"""Write a synthetic training corpus: mono PCM16 harmonic tones (a
fundamental and its first harmonics, as tests/test_e2e_training.py:
make_dataset writes) with a slow vibrato, of lengths spread evenly over
``[min_frames, max_frames]`` spectrogram frames, and a filelist of them
(``path|sid`` lines when ``speakers`` > 0).

    python -m smart_vocoder_torch.tools.make_corpus OUT_DIR [--clips 96]
        [--min-frames 345] [--max-frames 1000] [--speakers 0] [--seed 1234]

The defaults fill every bucket of iitp_base's boundaries from 300 to 1000
frames: 4 to 11.6 s clips at 22.05 kHz.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy.io import wavfile


def write_corpus(out_dir: str, clips: int = 96, min_frames: int = 345,
                 max_frames: int = 1000, speakers: int = 0, seed: int = 1234,
                 sampling_rate: int = 22050, hop: int = 256) -> str:
    """Write the clips under ``out_dir/wavs`` and return the filelist's path."""
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    frames = np.linspace(min_frames, max_frames, clips).round().astype(int)
    lines = []
    for i, f in enumerate(rng.permutation(frames)):
        t = np.arange(int(f) * hop) / sampling_rate
        f0 = rng.uniform(90, 300) * (1 + 0.02 * np.sin(2 * np.pi * rng.uniform(3, 6) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sampling_rate
        wav = sum(np.sin(h * phase) / h for h in (1, 2, 3, 4))
        wav = wav / np.abs(wav).max() * 0.5 + rng.normal(0, 0.003, wav.shape)
        path = os.path.join(wav_dir, f"clip{i:04d}.wav")
        wavfile.write(path, sampling_rate, (wav * 32767).astype(np.int16))
        lines.append(f"{path}|{i % speakers}" if speakers else path)
    filelist = os.path.join(out_dir, "files.txt")
    with open(filelist, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    return filelist


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir")
    p.add_argument("--clips", type=int, default=96)
    p.add_argument("--min-frames", type=int, default=345)
    p.add_argument("--max-frames", type=int, default=1000)
    p.add_argument("--speakers", type=int, default=0)
    p.add_argument("--seed", type=int, default=1234)
    a = p.parse_args(argv)
    print(write_corpus(a.out_dir, a.clips, a.min_frames, a.max_frames, a.speakers, a.seed))


if __name__ == "__main__":
    main()
