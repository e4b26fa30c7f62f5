"""Batch copy-synthesis CLI: the port's counterpart of the repo's ``infer.py``.

    python -m smart_vocoder_torch.infer -c configs/iitp_base.json \
        --ckpt G_*.pth --wavs 'test_wav_dir/*.wav' --out_dir generated_files

Each input wav is copy-synthesized (wav -> mel -> wav, notebook cell 4) by
``Vocoder.from_torch_checkpoint`` and ``wav_to_wav`` and written to
``out_dir`` as 16-bit PCM; prints per-file and total real-time factors. It
runs on the CUDA card unless ``--device cpu`` is given. Only reference-format
``G_*.pth`` files load: the JAX package's orbax checkpoint directories are
not read by the port.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
from scipy.io import wavfile

from smart_vocoder_torch.inference import Vocoder


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--ckpt", required=True, help="reference G_*.pth file")
    p.add_argument("--wavs", required=True, help="glob of input wavs")
    p.add_argument("--out_dir", default="generated_files")
    p.add_argument("--noise_scale", type=float, default=0.667)
    p.add_argument("--sid", type=int, default=None, help="speaker id (ms configs)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    if os.path.isdir(args.ckpt):
        p.error(f"--ckpt {args.ckpt} is a directory: orbax checkpoints are the JAX "
                "package's format and the port does not read them; pass a G_*.pth file")
    voc = Vocoder.from_torch_checkpoint(args.config, args.ckpt, device=args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    sr = voc.hps.data.sampling_rate
    sid = None if args.sid is None else np.asarray([args.sid])
    files = sorted(glob.glob(args.wavs))
    total_audio = total_time = 0.0
    for path in files:
        in_sr, data = wavfile.read(path)
        if in_sr != sr:
            raise SystemExit(f"{path}: sampling rate {in_sr}, the config's is {sr}")
        wav = data.astype(np.float32) / voc.hps.data.max_wav_value

        t0 = time.perf_counter()
        out = voc.wav_to_wav(wav, noise_scale=args.noise_scale, sid=sid)
        dt = time.perf_counter() - t0

        out_path = os.path.join(args.out_dir, os.path.basename(path))
        wavfile.write(out_path, sr, (np.clip(out, -1, 1) * 32767).astype(np.int16))
        total_audio += len(out) / sr
        total_time += dt
        print(f"{out_path}: {len(out) / sr:.2f}s audio in {dt:.3f}s "
              f"({len(out) / sr / dt:.1f}x RT)")
    if files:
        print(f"TOTAL: {total_audio:.1f}s audio in {total_time:.2f}s "
              f"({total_audio / total_time:.1f}x RT) on {voc.device}")


if __name__ == "__main__":
    main()
