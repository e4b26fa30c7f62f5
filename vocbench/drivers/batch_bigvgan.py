"""Closed-loop batch synthesis of BigVGAN-v2: back-to-back ``Vocoder.mel_to_wav``
calls of a generator-only configuration (``model.kind: "bigvgan"``).

The traffic parameters and the calls are ``batch.py``'s (its ``make_calls``
and ``sample_calls``): the same lengths in a seed's order, mel normal × 2 − 4,
three warm-up calls, the longest-row call and ``check_calls - 1`` drawn ones
compared. The generator draws no noise, so a call passes no ``seed=``. The
weights are ``vocbench/weights.py``'s rule over ``reference/bigvgan.py``'s
leaves, SnakeBeta's log-scale parameters uniform in the configuration's
``seeded_weights.log_scale_bound`` and ``conv_post`` times its gain.

The run counts the program's ``LAUNCHES["aa_snake"]`` over the window (the
counter ``aa_snake_launches``; none where the program has no such entry).

    python3 -m vocbench.drivers.batch_bigvgan --workload <cell> --seeds 11,12

prints, for each seed, the gaps of the control (the reference with every model
convolution's operands in float8 e4m3) to the float32 reference on the calls a
run compares: a limit is sound only where the control reads above it. It
needs the card, as a run does; the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import traceback

import numpy as np
import torch

from vocbench import compare, weights
from vocbench.drivers.batch import WARMUP_CALLS, make_calls, sample_calls
from vocbench.harness import Check, Context, Record, derived_seed
from vocbench.reference import bigvgan
from vocbench.reference.graph import F32, Numerics


def make_weights(ctx: Context, sizes: bigvgan.Sizes) -> dict:
    sw = ctx.config["seeded_weights"]
    state = weights.make(bigvgan.generator_params(sizes, float(sw["log_scale_bound"])),
                         derived_seed(ctx.seed, 0), ctx.device)
    state["conv_post.weight"] = state["conv_post.weight"] * float(sw["conv_post_gain"])
    return state


def aa_launches():
    from smart_vocoder_torch.kernels._build import LAUNCHES

    return LAUNCHES.get("aa_snake")


def run(ctx: Context) -> Record:
    from smart_vocoder_torch.inference import Vocoder

    rec = ctx.recorder
    sizes = bigvgan.Sizes.from_config(ctx.config)
    sr = int(ctx.config["data"]["sampling_rate"])
    with rec.span("setup.weights"):
        state = make_weights(ctx, sizes)
    with rec.span("setup.inputs"):
        calls = make_calls(ctx, sizes.n_mels)
    with rec.span("setup.vocoder"):
        voc = Vocoder(ctx.hps, state, device=ctx.device)
    with rec.span("setup.warmup"):
        for call in calls[:WARMUP_CALLS]:
            voc.mel_to_wav(call["mel"], call["lengths"])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)

    window = ctx.window()
    outs: dict[int, list[np.ndarray]] = {}
    failed = attempted = 0
    launches0 = aa_launches()
    t0 = window.start()
    setup_s = t0 - ctx.t_process
    i = 0
    while time.perf_counter() - t0 < ctx.seconds:
        call = calls[i % len(calls)]
        attempted += len(call["lengths"])
        with rec.span("vb.call", index=i, frames=call["lengths"].tolist(),
                      audio_s=float(call["lengths"].sum()) * sizes.hop / sr) as sp:
            try:
                outs[i] = voc.mel_to_wav(call["mel"], call["lengths"])
                sp.attrs["ok"] = True
            except Exception:
                failed += len(call["lengths"])
                rec.add("failed_calls")
                if failed == len(call["lengths"]):
                    traceback.print_exc(file=sys.stderr)
        i += 1
    t1 = window.stop()
    if launches0 is not None:
        rec.add("aa_snake_launches", aa_launches() - launches0)
    peak = int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.device.type == "cuda" else 0

    voc.close()
    del voc
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, state, sizes, calls, outs) if outs else []
    return Record(ctx, setup_s, t0, t1, attempted, failed, checks, peak, window.trace)


def reference_answers(ctx: Context, state, sizes, calls, picked, numerics=F32) -> list:
    out = []
    with compare.reference_precision():
        for i in picked:
            call = calls[i % len(calls)]
            out.extend(bigvgan.batch_call(state, sizes, call["mel"], call["lengths"],
                                          ctx.device, nx=numerics))
    return out


def check(ctx: Context, state, sizes, calls, outs) -> list[Check]:
    """The sampled calls' waveforms against the reference's."""
    picked = sample_calls(ctx, calls, sorted(outs))
    want = reference_answers(ctx, state, sizes, calls, picked)
    got = [w for i in picked for w in outs[i]]
    clamped = float(np.mean([np.mean(np.abs(w) >= 1.0) for w in want]))
    rms = float(np.sqrt(np.mean([np.mean(np.square(w)) for w in want])))
    print(f"reference answers: RMS {rms!r}, share of samples clamped {clamped!r}",
          file=sys.stderr)
    return compare.waveform_checks(got, want, ctx.traffic["limits"], ctx.config["data"])


def control_gaps(ctx: Context) -> dict:
    """The control's gaps to the reference on the calls a run compares."""
    sizes = bigvgan.Sizes.from_config(ctx.config)
    state = make_weights(ctx, sizes)
    calls = make_calls(ctx, sizes.n_mels)
    picked = sample_calls(ctx, calls, list(range(len(calls))))
    want = reference_answers(ctx, state, sizes, calls, picked)
    got = reference_answers(ctx, state, sizes, calls, picked, Numerics("fp8"))
    return compare.waveform_gaps(got, want, ctx.config["data"])


def main(argv=None) -> int:
    from vocbench import run as vrun

    ap = argparse.ArgumentParser(description="the fp8 control of a BigVGAN batch cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("batch_bigvgan: no CUDA device", file=sys.stderr)
        return 2
    bench = vrun.load_json("BENCHMARK.json")
    cell = vrun.find(bench["workloads"], args.workload, "workload")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = vrun.make_context(cell, bench, seed, 1.0, False, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "fp8",
                          **control_gaps(ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
