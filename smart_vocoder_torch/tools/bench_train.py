"""The GAN train step on the card: step time, throughput and memory.

Counterpart of ``scripts/bench_train.py``. The config's model at full width
(iitp_base by default), B = ``train.batch_size`` rows of one ``frames``-frame
bucket, a synthetic batch from a numpy seed (waveforms uniform in +-0.5, their
linear spectrograms), seeded weights (``training.init_train_state``), the
step's randomness from a seeded generator on the device. Each leg (``bf16``:
compute in bf16 over f32 master weights, the config of record; ``f32``) runs
from the same initial weights, one warm-up step each, then ``rounds``
interleaved rounds of ``iters`` steps (every other round in reverse order):

  step_ms          host ms per step (the round ends in a device synchronize),
                   median over the rounds, with its min and max
  steps_per_s      1000 / step_ms
  audio_x_realtime B * frames * hop / sr seconds of audio per step over the
                   step's seconds (scripts/bench_train.py:72)
  busy_ms          the card's busy ms per step, summed by torch.profiler
                   over ``iters`` more steps (None on the CPU)
  busy_share       busy_ms over step_ms: the profiler's own host overhead
                   stays out of the wall it is divided by. Up to the
                   profiler's error, 1 means the card never waits for the host
  peak_mem_gib     the step's own peak: the leg's state (parameters, buffers,
                   AdamW moments) plus the most its steps allocated above
                   what was resident before them (torch.cuda
                   .max_memory_allocated); the other leg's state and whatever
                   the caller holds are left out
  tflops           the step's model FLOPs (``utils.flops.train_step_flops``)
                   over step_ms, beside the bound: those FLOPs at 989 TFLOP/s
  loss_first, loss_last  the losses of the warm-up step and of the last step

Every table names the device: the card and its power limit as ``nvidia-smi``
reports them. ``main(device="cpu", hps=...)`` runs the same code on the CPU
at a small size; its times are the host's, not the card's.

Usage: python -m smart_vocoder_torch.tools.bench_train [--config PATH] [--frames F]
       [--rounds R] [--iters I] [--legs bf16,f32]
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import statistics
import time

import numpy as np
import torch

from smart_vocoder_torch.config import load_config
from smart_vocoder_torch.inference import set_precision_flags
from smart_vocoder_torch.ops import stft_magnitude
from smart_vocoder_torch.tools import device_busy_ms
from smart_vocoder_torch.training import Batch, init_train_state, make_train_step
from smart_vocoder_torch.utils.device import device_label, resolve_device
from smart_vocoder_torch.utils.flops import H100_BF16_PEAK, train_step_flops

SEED = 1234
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOSSES = ("loss/g/total", "loss/d/total", "loss/g/fm", "loss/g/mel", "loss/g/kl")


def synthetic_batch(hps, rows: int, frames: int, device: torch.device) -> Batch:
    """``rows`` waveforms of ``frames`` frames (uniform in +-0.5, numpy seed
    ``SEED``) and their linear spectrograms, on ``device``."""
    hop = hps.data.hop_length
    rng = np.random.default_rng(SEED)
    wav = torch.from_numpy(rng.uniform(-0.5, 0.5, (rows, frames * hop, 1))
                           .astype(np.float32)).to(device)
    spec = stft_magnitude(wav[..., 0], hps.data.filter_length, hop, hps.data.win_length)
    lengths = torch.full((rows,), frames, dtype=torch.int32, device=device)
    conditioned = bool(hps.model.get("use_spk_embed", False)) and hps.data.n_speakers > 0
    sid = (torch.arange(rows, device=device) % hps.data.n_speakers) if conditioned else None
    return Batch(spec, lengths, wav, lengths * hop, sid)


def state_bytes(state) -> int:
    """Bytes of a ``TrainState``'s tensors: both nets' parameters and buffers
    and both optimizers' state (gradients are freed after each step)."""
    tensors = [t for net in (state.net_g, state.net_d)
               for t in itertools.chain(net.parameters(), net.buffers())]
    tensors += [v for opt in (state.opt_g, state.opt_d) for st in opt.state.values()
                for v in st.values() if torch.is_tensor(v)]
    return sum(t.numel() * t.element_size() for t in tensors)


def leg_hps(hps, leg: str):
    out = copy.deepcopy(hps)
    out.tpu.bf16_run = leg == "bf16"
    return out


def main(device=None, hps=None, frames: int = 1000, rounds: int = 5, iters: int = 3,
         legs=("bf16",)) -> dict:
    """Time the step's legs; print each leg's line and one JSON line, and
    return {"device": ..., "legs": {leg: {"step_ms": ..., ...}}}."""
    device = resolve_device(device)
    set_precision_flags()  # TF32 off: the f32 leg is real f32
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # one shape a leg: let cuDNN pick its plans
    if hps is None:
        hps = load_config(os.path.join(_ROOT, "configs", "iitp_base.json"))
    rows = hps.train.batch_size
    label = device_label(device)
    batch = synthetic_batch(hps, rows, frames, device)
    audio_s = rows * frames * hps.data.hop_length / hps.data.sampling_rate
    flops = train_step_flops(hps, rows, frames)

    base = init_train_state(leg_hps(hps, legs[0]), seed=SEED, device=device)
    runs = {}
    for leg in legs:
        h = leg_hps(hps, leg)
        state = base if leg == legs[0] else init_train_state(
            h, device=device, net_g=copy.deepcopy(base.net_g), net_d=copy.deepcopy(base.net_d))
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        runs[leg] = {"state": state, "step": make_train_step(h, device=device), "gen": gen,
                     "metrics": None}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def one(leg):
        r = runs[leg]
        r["state"], r["metrics"] = r["step"](r["state"], batch, r["gen"])

    results = {}
    for leg in legs:  # warm-up: cuDNN's plan choice, the allocator's growth, AdamW's moments
        one(leg)
        sync()
        results[leg] = {"loss_first": {k: runs[leg]["metrics"][k].item() for k in LOSSES},
                        "times": [], "peak_mem_gib": None}
    order = list(legs)
    for r in range(rounds):
        for leg in (order if r % 2 == 0 else order[::-1]):
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
                resident = torch.cuda.memory_allocated(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                one(leg)
            sync()
            results[leg]["times"].append((time.perf_counter() - t0) / iters * 1e3)
            if device.type == "cuda":
                peak = (state_bytes(runs[leg]["state"]) + torch.cuda.max_memory_allocated(device)
                        - resident) / 2 ** 30
                results[leg]["peak_mem_gib"] = max(results[leg]["peak_mem_gib"] or 0.0, peak)

    out = {"device": label, "rows": rows, "frames": frames, "audio_s_per_step": audio_s,
           "model_tflop_per_step": flops / 1e12, "bound_ms": flops / H100_BF16_PEAK * 1e3,
           "legs": {}}
    for leg in legs:
        res = results[leg]
        times = res.pop("times")
        ms = statistics.median(times)
        busy = device_busy_ms(lambda: [one(leg) for _ in range(iters)], device)
        busy = None if busy is None else busy / iters
        res.update({
            "step_ms": ms, "step_ms_min": min(times), "step_ms_max": max(times),
            "rounds": rounds, "iters": iters, "steps_per_s": 1e3 / ms,
            "audio_x_realtime": audio_s / (ms / 1e3), "tflops": flops / (ms / 1e3) / 1e12,
            "busy_ms": busy, "busy_share": None if busy is None else busy / ms,
            "loss_last": {k: runs[leg]["metrics"][k].item() for k in LOSSES},
        })
        out["legs"][leg] = res
        busy_txt = "n/a" if busy is None else f"{100 * res['busy_share']:.1f}%"
        mem_txt = "n/a" if res["peak_mem_gib"] is None else f"{res['peak_mem_gib']:.2f} GiB"
        print(f"train step {leg} B={rows} x {frames} frames: {ms:.2f} ms "
              f"({min(times):.2f}-{max(times):.2f}, {rounds} rounds of {iters}), "
              f"{res['steps_per_s']:.2f} steps/s, {res['audio_x_realtime']:.1f}x real time, "
              f"{res['tflops']:.2f} TFLOP/s of {flops / 1e12:.3f} TFLOP "
              f"(bound {out['bound_ms']:.2f} ms), busy {busy_txt}, peak {mem_txt}; "
              f"loss/g/total {res['loss_first']['loss/g/total']:.3f} -> "
              f"{res['loss_last']['loss/g/total']:.3f}  [{label}]", flush=True)
    print(json.dumps(out), flush=True)
    return out


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=os.path.join(_ROOT, "configs", "iitp_base.json"))
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--legs", default="bf16", help="comma-separated: bf16, f32")
    args = ap.parse_args()
    main(hps=load_config(args.config), frames=args.frames, rounds=args.rounds,
         iters=args.iters, legs=tuple(args.legs.split(",")))


if __name__ == "__main__":
    _cli()
