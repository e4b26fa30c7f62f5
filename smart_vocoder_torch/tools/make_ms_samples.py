"""Regenerate the multi-speaker sample set from a trained checkpoint, in one process.

The port's counterpart of ``scripts/make_ms_samples.py``:

    python -m smart_vocoder_torch.tools.make_ms_samples CONFIG CKPT OUT_DIR \
        WAV:SID [WAV:SID ...] [--device cpu]

``CKPT`` is a ``G_*.pth`` or a model directory, whose newest ``G_*.pth``
(``utils/checkpoint.py``) is taken. The generator is served by
``Vocoder.from_torch_checkpoint`` at its defaults (the bf16 kernel route at
hifi 2, the path ``bench`` times) on the card unless ``--device cpu`` is
given. For each (wav, sid) pair: copy synthesis (wav -> mel -> wav) with that
speaker, written as ``OUT_DIR/<stem>_sid<k>.wav``, and one line with the
seconds of audio, the times real time of the call, and the copy-synthesis
mel-L1 against the INPUT's mel (trained-model quality, not implementation
parity).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from scipy.io import wavfile

from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.ops import MelConfig, mel_spectrogram
from smart_vocoder_torch.utils.checkpoint import CheckpointManager


def generator_path(ckpt: str) -> str:
    """``ckpt`` itself, or the newest ``G_*.pth`` of the model directory it names."""
    if not os.path.isdir(ckpt):
        return ckpt
    mngr = CheckpointManager(ckpt)
    step = mngr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no G_/D_ checkpoint pair in {ckpt}")
    return mngr.path("G", step)


def copy_synthesis_mel_l1(wav: np.ndarray, out: np.ndarray, mel_cfg: MelConfig) -> float:
    """Mean |mel(out) - mel(wav)| over the whole hops of ``wav``."""
    usable = (len(wav) // mel_cfg.hop_length) * mel_cfg.hop_length
    mel_in = mel_spectrogram(torch.from_numpy(wav[None, :usable]), mel_cfg)
    mel_out = mel_spectrogram(torch.from_numpy(out[None, :usable]), mel_cfg)
    return float((mel_in - mel_out).abs().mean())


def sample(voc: Vocoder, path: str, sid: int, out_dir: str) -> dict:
    """Copy-synthesize ``path`` as speaker ``sid`` into ``out_dir``, print the
    line and return ``{path, seconds, call_s, x_realtime, mel_l1, wav}``."""
    sr = voc.hps.data.sampling_rate
    in_sr, data = wavfile.read(path)
    if in_sr != sr:
        raise ValueError(f"{path}: {in_sr} Hz, the config's rate is {sr} Hz")
    wav = data.astype(np.float32) / voc.hps.data.max_wav_value
    t0 = time.perf_counter()
    out = voc.wav_to_wav(wav, sid=np.asarray([sid]))  # a host array: the call has ended
    dt = time.perf_counter() - t0
    l1 = copy_synthesis_mel_l1(wav, out, voc.mel_cfg)
    stem = os.path.splitext(os.path.basename(path))[0]
    out_path = os.path.join(out_dir, f"{stem}_sid{sid}.wav")
    wavfile.write(out_path, sr, (np.clip(out, -1, 1) * 32767).astype(np.int16))
    seconds = len(out) / sr
    print(f"{out_path}: {seconds:.2f}s in {dt:.2f}s "
          f"({seconds / dt:.0f}x RT), copy-synth mel_l1 {l1:.4f}", flush=True)
    return {"path": out_path, "seconds": seconds, "call_s": dt, "x_realtime": seconds / dt,
            "mel_l1": l1, "wav": out}


def load_vocoder(config: str, ckpt: str, device=None) -> Vocoder:
    return Vocoder.from_torch_checkpoint(config, generator_path(ckpt), device=device)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("ckpt", help="a G_*.pth, or a model directory (its newest G_*.pth)")
    ap.add_argument("out_dir")
    ap.add_argument("pairs", nargs="+", metavar="WAV:SID")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    pairs = []
    for spec in args.pairs:
        path, sid = spec.rsplit(":", 1)
        pairs.append((path, int(sid)))
    voc = load_vocoder(args.config, args.ckpt, args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    return [sample(voc, path, sid, args.out_dir) for path, sid in pairs]


if __name__ == "__main__":
    main()
