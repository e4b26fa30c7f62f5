"""Closed-loop batch synthesis: back-to-back ``Vocoder.mel_to_wav`` calls.

Traffic parameters (the traffic file): ``batch`` rows a call, ``frames``
``[lo, hi]`` true lengths, ``pool_calls`` distinct calls whose inputs are made
at set-up and sent in turn, ``noise_scale``, ``check_calls`` calls compared
with the reference after the window (the one holding the longest row among
them), and ``limits``.

Every seed gets the same set of lengths, ``batch * pool_calls`` points spread
evenly over ``[lo, hi]``, in an order drawn from the seed, so that the work of
a window does not depend on the seed. A call's mel is normal × 2 − 4 (log-mel
units) over its rows' true frames, zero beyond them, and the call passes its
own ``seed=`` so the program draws the prior noise (``Vocoder.batch_eps``).
"""

from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np
import torch

from vocbench import compare, weights
from vocbench.harness import Check, Context, Record, derived_seed, rng
from vocbench.reference import graph, synthesis

WARMUP_CALLS = 3  # the window's first calls were slower after a single one


def make_calls(ctx: Context, n_mels: int) -> list[dict]:
    tr = ctx.traffic
    b, pool = int(tr["batch"]), int(tr["pool_calls"])
    lo, hi = tr["frames"]
    g = rng(ctx.seed, 1)
    lengths = np.rint(np.linspace(lo, hi, b * pool)).astype(np.int64)
    lengths = g.permutation(lengths).reshape(pool, b)
    calls = []
    for c in range(pool):
        lens = lengths[c]
        t = int(lens.max())
        mel = g.standard_normal((b, t, n_mels), dtype=np.float32) * np.float32(2) - np.float32(4)
        mel[np.arange(t)[None, :] >= lens[:, None]] = 0.0
        calls.append({"mel": mel, "lengths": lens})
    return calls


def call_seed(ctx: Context, i: int) -> int:
    return derived_seed(ctx.seed, 2, i)


def run(ctx: Context) -> Record:
    from smart_vocoder_torch.inference import Vocoder

    tr, rec = ctx.traffic, ctx.recorder
    sizes = graph.Sizes.from_config(ctx.config)
    hop, sr = sizes.hop, int(ctx.config["data"]["sampling_rate"])
    noise_scale = float(tr["noise_scale"])
    with rec.span("setup.weights"):
        state = weights.make(graph.generator_params(sizes),
                             derived_seed(ctx.seed, 0), ctx.device)
    with rec.span("setup.inputs"):
        calls = make_calls(ctx, sizes.n_mels)
    with rec.span("setup.vocoder"):
        voc = Vocoder(ctx.hps, state, device=ctx.device)
    with rec.span("setup.warmup"):
        for k, call in enumerate(calls[:WARMUP_CALLS]):
            voc.mel_to_wav(call["mel"], call["lengths"], noise_scale=noise_scale,
                           seed=derived_seed(ctx.seed, 3, k))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)

    window = ctx.window()
    outs: dict[int, list[np.ndarray]] = {}
    failed = attempted = 0
    t0 = window.start()
    setup_s = t0 - ctx.t_process
    i = 0
    while time.perf_counter() - t0 < ctx.seconds:
        call = calls[i % len(calls)]
        attempted += len(call["lengths"])
        with rec.span("vb.call", index=i,
                      frames=call["lengths"].tolist(),
                      audio_s=float(call["lengths"].sum()) * hop / sr) as sp:
            try:
                outs[i] = voc.mel_to_wav(call["mel"], call["lengths"], noise_scale=noise_scale,
                                         seed=call_seed(ctx, i))
                sp.attrs["ok"] = True
            except Exception:
                failed += len(call["lengths"])
                rec.add("failed_calls")
                if failed == len(call["lengths"]):
                    traceback.print_exc(file=sys.stderr)
        i += 1
    t1 = window.stop()
    peak = int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.device.type == "cuda" else 0

    voc.close()
    del voc
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, state, sizes, calls, outs) if outs else []
    return Record(ctx, setup_s, t0, t1, attempted, failed, checks, peak, window.trace)


def sample_calls(ctx: Context, calls: list[dict], done: list[int]) -> list[int]:
    """``check_calls`` completed calls drawn from the seed, the one holding
    the longest row among them."""
    k = min(int(ctx.traffic["check_calls"]), len(done))
    longest = max(done, key=lambda i: (int(calls[i % len(calls)]["lengths"].max()), -i))
    rest = [i for i in done if i != longest]
    picked = list(rng(ctx.seed, 4).choice(rest, size=k - 1, replace=False)) if k > 1 else []
    return [longest] + sorted(int(i) for i in picked)


def check(ctx: Context, state, sizes, calls, outs, numerics=graph.F32) -> list[Check]:
    """The sampled calls' waveforms against the reference's."""
    limits = ctx.traffic["limits"]
    picked = sample_calls(ctx, calls, sorted(outs))
    got, want = [], []
    with compare.reference_precision():
        for i in picked:
            call = calls[i % len(calls)]
            ref = synthesis.batch_call(state, sizes, call["mel"], call["lengths"],
                                       float(ctx.traffic["noise_scale"]), call_seed(ctx, i),
                                       ctx.device, nx=numerics)
            got.extend(outs[i])
            want.extend(ref)
    return compare.waveform_checks(got, want, limits, ctx.config["data"])
