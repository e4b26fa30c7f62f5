"""Generate a synthetic speech-like training corpus, its filelists and a config.

The port's counterpart of ``scripts/make_synth_data.py``, with the same CLI,
the same numpy stream and the same files byte for byte:

    python -m smart_vocoder_torch.tools.make_synth_data OUT [n_clips] [n_speakers] [--ms]

(``n_clips`` 64 and ``n_speakers`` 4 by default.) ``OUT`` must be given,
unlike the script's fixed default directory, which two checkouts would
share. ``--ms`` emits a
multi-speaker config (``model.use_spk_embed: true``, the reference's
speaker-conditioned mode) and gives each speaker a FIXED timbre signature
(register + spectral tilt + formant profile) so the speaker embedding has
something real to learn; without it, speakers differ only by f0 register
and the config trains the single-speaker model.

Each clip is a few seconds of harmonic source (randomly-walking f0 per
"speaker" register) shaped by slowly-moving formant-ish resonances plus
breath noise -- enough spectral structure that the vocoder's mel-L1 and the
GAN losses behave like they do on speech, with no external data dependency.
Writes mono PCM16 wavs at 22.05 kHz under ``OUT/wavs``, ``train_files.txt``
and ``val_files.txt`` (``path|sid``; the first ``max(2, n_clips // 16)``
clips validate), and ``OUT/config.json``: ``configs/iitp_base.json`` with
those filelists and ``n_speakers``, ``log_interval`` 20, ``eval_interval``
200 and one training bucket, ``tpu.bucket_boundaries`` ``[32, 600]`` (the
clips are at most 6 s, 517 frames). Runs on the host; nothing here touches a
device.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
from scipy.io import wavfile

SR = 22050
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth_clip(rng: np.random.Generator, seconds: float, f0_base: float,
               timbre: dict | None = None) -> np.ndarray:
    n = int(seconds * SR)
    t = np.arange(n) / SR
    # randomly-walking f0 around the speaker register
    f0 = f0_base * np.exp(np.cumsum(rng.normal(0, 0.0008, n)))
    f0 = np.clip(f0, 60.0, 400.0)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    # harmonic stack with per-speaker tilt rolloff (default 1/h)
    tilt = timbre["tilt"] if timbre else 1.0
    sig = np.zeros(n)
    for h in range(1, 13):
        amp = 1.0 / h ** tilt
        sig += amp * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    # 2-3 slowly-moving "formant" resonances via time-varying comb of sines;
    # in --ms mode the center rates/depths are drawn around a fixed
    # per-speaker profile so timbre is a stable speaker signature
    env = np.ones(n)
    profile = timbre["formants"] if timbre else [
        (rng.uniform(300, 3000), rng.uniform(0.5, 2.0))
        for _ in range(rng.integers(2, 4))]
    for _fc, rate0 in profile:
        rate = rate0 * rng.uniform(0.85, 1.15)
        env *= 0.6 + 0.4 * np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi))
    sig *= env
    # breath noise, high-passed by first differencing
    noise = rng.normal(0, 1.0, n)
    noise = np.diff(noise, prepend=0.0) * 0.05
    sig = sig / (np.abs(sig).max() + 1e-9) * 0.6 + noise
    # syllable-ish amplitude gating (3-5 Hz)
    gate = 0.35 + 0.65 * np.clip(np.sin(2 * np.pi * rng.uniform(3, 5) * t
                                        + rng.uniform(0, 2 * np.pi)), 0, 1) ** 0.5
    sig *= gate
    # fade edges
    fade = min(1024, n // 8)
    sig[:fade] *= np.linspace(0, 1, fade)
    sig[-fade:] *= np.linspace(1, 0, fade)
    return np.clip(sig, -0.99, 0.99)


def make_synth_data(out: str, n_clips: int = 64, n_speakers: int = 4,
                    ms: bool = False) -> str:
    """Write the corpus, filelists and config under ``out``; return the
    config's path."""
    wav_dir = os.path.join(out, "wavs")
    os.makedirs(wav_dir, exist_ok=True)

    rng = np.random.default_rng(1234)
    registers = np.linspace(95, 250, n_speakers) if ms else rng.uniform(
        90, 260, n_speakers)
    timbres = [
        {"tilt": float(rng.uniform(0.7, 1.5)),
         "formants": [(float(rng.uniform(300, 3000)), float(rng.uniform(0.5, 2.0)))
                      for _ in range(int(rng.integers(2, 4)))]}
        for _ in range(n_speakers)
    ] if ms else None
    entries = []
    for i in range(n_clips):
        sid = int(i % n_speakers)
        seconds = float(rng.uniform(1.5, 6.0))
        clip = synth_clip(rng, seconds, registers[sid], timbres[sid] if ms else None)
        path = os.path.join(wav_dir, f"clip_{i:04d}.wav")
        wavfile.write(path, SR, (clip * 32767).astype(np.int16))
        entries.append(f"{os.path.abspath(path)}|{sid}")

    n_val = max(2, n_clips // 16)
    train_list = os.path.join(out, "train_files.txt")
    val_list = os.path.join(out, "val_files.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(entries[n_val:]) + "\n")
    with open(val_list, "w") as f:
        f.write("\n".join(entries[:n_val]) + "\n")

    with open(os.path.join(_ROOT, "configs", "iitp_base.json")) as f:
        cfg = json.load(f)
    cfg["data"]["training_files"] = os.path.abspath(train_list)
    cfg["data"]["validation_files"] = os.path.abspath(val_list)
    cfg["data"]["n_speakers"] = n_speakers
    if ms:
        cfg["model"]["use_spk_embed"] = True
    cfg["train"]["log_interval"] = 20
    cfg["train"]["eval_interval"] = 200
    # one bucket = one step shape; clips are capped at 6 s (517 frames), so
    # nothing is dropped
    cfg.setdefault("tpu", {})["bucket_boundaries"] = [32, 600]
    cfg_path = os.path.join(out, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    print(f"{n_clips} clips ({n_speakers} speakers{', spk-embed' if ms else ''})"
          f" -> {wav_dir}\nconfig: {cfg_path}")
    return cfg_path


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if a != "--ms"]
    if not args:
        sys.exit("usage: make_synth_data OUT [n_clips] [n_speakers] [--ms]")
    make_synth_data(args[0],
                    int(args[1]) if len(args) > 1 else 64,
                    int(args[2]) if len(args) > 2 else 4,
                    ms="--ms" in argv)


if __name__ == "__main__":
    main()
