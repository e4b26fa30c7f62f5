"""Serving speed against fidelity: the five operating points of the serving path.

The port's counterpart of ``scripts/fidelity_frontier.py``:

    python -m smart_vocoder_torch.tools.fidelity_frontier [reps] [iters] [--device cpu]

One process, one parameter set (``utils/golden.py:fidelity_state_dict``, the
weights the golden fixture's torch reference ran), five ``Vocoder``\\ s that
differ only in where the f32 islands sit (the ``hifi`` ladder of
``kernels/decoder.py`` and the prior's precision):

  l0  ("bf16-fast(l0)")      the bf16 kernel route (``bench --fast``)
  l1  ("tail(l1)")           + stage 4's two-pass hi/lo products and the
                             stage 3-4 f32 activations
  l2  ("l2+priorF32")        + the early decoder in f32 storage and the f32
                             prior and flow: the serving default, ``bench``'s
                             headline
  l3  ("l3(s3x2)+priorF32")  + stage 3's two-pass hi/lo products
  f32 ("f32")                f32 weights and activations, ``bench --f32``'s
                             route (the stages on their f32 FMA kernels); the
                             JAX script's f32 point is its module graph

For each point: ms a step and times real time under ``bench``'s protocol
(B = 32 x 1000 frames, the noise drawn on the device each call), and the
mel-L1 of its waveform on the golden fixture's mel and noise against the
torch reference's waveform there. Timing rounds interleave the points: in
each of ``reps`` rounds every point runs ``iters`` calls between two
synchronizes, and a point's time is the median of its rounds. Every point,
the f32 one too, runs at ``batch`` (the JAX script's v5e took 8 for its f32
point for lack of memory); each row keeps the script's ``batch`` field.
Prints a table, then
the ``{"frontier": [...]}`` line last. Runs on the card unless ``--device
cpu`` is given; a kernel route that is not taken, or a first call on the
card that does not launch the two stage kernels, raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from smart_vocoder_torch.bench import BATCH, CONFIG, FIXTURE, FRAMES, NOISE_SEED, golden_case
from smart_vocoder_torch.config import load_config
from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.kernels import LAUNCHES, reset_launch_counts
from smart_vocoder_torch.utils import jax_random
from smart_vocoder_torch.utils.device import device_label, resolve_device
from smart_vocoder_torch.utils.golden import NOISE_SCALE, fidelity_state_dict

# (name, dtype, hifi level); the prior runs in f32 from level 2 (Vocoder)
POINTS = (("bf16-fast(l0)", torch.bfloat16, 0),
          ("tail(l1)", torch.bfloat16, 1),
          ("l2+priorF32", torch.bfloat16, 2),
          ("l3(s3x2)+priorF32", torch.bfloat16, 3),
          ("f32", torch.float32, 0))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def point_vocoders(hps, state, device) -> dict:
    """{name: Vocoder} of the five points, each on the kernel route."""
    out = {}
    for name, dtype, level in POINTS:
        v = Vocoder(hps, state, dtype=dtype, use_kernels=True, use_wn_kernels=False,
                    hifi=level, device=device)
        if not v.use_kernels or v.hifi != (level if dtype == torch.bfloat16 else 0):
            raise RuntimeError(f"{name}: the kernel route at hifi {level} was not taken")
        out[name] = v
    return out


def main(reps: int = 3, iters: int = 20, device=None, hps=None, state=None,
         fixture: str = FIXTURE, batch: int = BATCH, frames: int = FRAMES) -> list:
    """Time and score the five points; print the table and the JSON line and
    return its rows. ``hps`` defaults to iitp_base's, ``state`` to the
    fidelity recipe's weights."""
    device = resolve_device(device)
    hps = hps or load_config(CONFIG)
    state = fidelity_state_dict(hps) if state is None else state
    sr, hop = hps.data.sampling_rate, hps.data.hop_length
    mel = jax_random.normal(jax_random.key(0), (batch, frames, hps.data.n_mel_channels))
    mel = torch.from_numpy(mel * np.float32(2) - np.float32(4)).to(device)
    lens = torch.full((batch,), frames, dtype=torch.int64, device=device)
    gmel, glens, geps, noise_scale, mel_l1 = golden_case(hps, fixture, device)
    log(f"device {device_label(device)}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def steps(voc, n, gen):
        for _ in range(n):
            eps = torch.randn((batch, frames, hps.model.inter_channels), generator=gen,
                              device=device)
            voc._infer(mel, lens, eps, NOISE_SCALE)

    built = {}
    for name, voc in point_vocoders(hps, state, device).items():
        f32 = voc.dtype == torch.float32
        log(f"first call of {name} ...")
        t0 = time.time()
        reset_launch_counts()
        steps(voc, 1, torch.Generator(device=device).manual_seed(NOISE_SEED))
        launches = {k: v for k, v in LAUNCHES.items() if v}
        # the stage kernels a call must launch on the card (f32: their FMA forms)
        routed = [f"mrf_stage{'_fma' if f32 else ''}", f"up_mrf_stage{'_fma' if f32 else ''}"]
        if device.type == "cuda" and not all(launches.get(k) for k in routed):
            raise RuntimeError(f"{name}: launches a call {launches}, expected {routed}")
        sync()
        l1 = mel_l1(voc._infer(gmel, glens, geps, noise_scale))
        built[name] = (voc, l1)
        log(f"  first call in {time.time() - t0:.1f} s, launches {launches}, mel_l1={l1:.4e}")

    acc = {name: [] for name in built}
    for _ in range(reps):
        for name, (voc, _) in built.items():  # interleave the points
            gen = torch.Generator(device=device).manual_seed(NOISE_SEED)
            sync()
            t0 = time.perf_counter()
            steps(voc, iters, gen)
            sync()
            acc[name].append((time.perf_counter() - t0) / iters)

    print(f"{'point':>16} {'ms/step':>8} {'RTF':>7} {'mel_l1':>8}")
    rows = []
    for name, (_, l1) in built.items():
        dt = statistics.median(acc[name])
        rtf = batch * frames * hop / sr / dt
        print(f"{name:>16} {dt * 1e3:>8.1f} {rtf:>7.0f} {l1:>8.5f}")
        rows.append({"point": name, "ms": round(dt * 1e3, 1), "batch": batch,
                     "rtf": round(rtf, 1), "mel_l1": round(l1, 5)})
    print(json.dumps({"frontier": rows}), flush=True)
    return rows


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("reps", nargs="?", type=int, default=3)
    ap.add_argument("iters", nargs="?", type=int, default=20)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args()
    main(args.reps, args.iters, device=args.device)


if __name__ == "__main__":
    _cli()
