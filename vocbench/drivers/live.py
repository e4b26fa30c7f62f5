"""Open-loop live streaming: arrivals into one ``serving.StreamServer``.

Traffic parameters (the traffic file): ``rate_per_s`` arrivals a second,
``frames`` ``[lo, hi]`` an utterance's length, ``max_streams``, ``chunk``,
``overlap`` of the server, ``noise_scale``, ``check_streams`` streams compared
with the reference after the window (the longest among them), and ``limits``.

An arrival is an utterance whose whole mel is ready when it arrives, as a
non-autoregressive acoustic model emits it: ``open(seed, sid)``, ``feed`` and
``close`` at once. The loop admits every arrival that is due, calls
``step()`` whenever a window is ready, and sleeps until the next arrival when
none is. Arrivals stop at the window's end; the run then drains the streams
that arrived. A stream's first audio is the time its first piece came out of
``step()``, from its scheduled arrival.

Every seed gets the same work in another order: ``round(rate * seconds)``
arrivals, whose gaps are the evenly spaced quantiles of an exponential
distribution (a Poisson process's gaps), shuffled by the seed and scaled to
fill the window; lengths evenly spaced over ``[lo, hi]``; speakers cycling
through the configuration's ``n_speakers``; all three in orders drawn from
the seed.
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


def make_arrivals(ctx: Context, rate: float, seconds: float, n_mels: int, n_speakers: int):
    """The arrivals of a window: dicts of ``at`` (seconds from the window's
    start), ``mel``, ``seed``, ``sid``."""
    tr = ctx.traffic
    n = max(1, int(round(rate * seconds)))
    g = rng(ctx.seed, 11)
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps = g.permutation(gaps)
    at = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) * (seconds / gaps.sum())
    lo, hi = tr["frames"]
    lengths = g.permutation(np.rint(np.linspace(lo, hi, n)).astype(np.int64))
    sids = g.permutation(np.arange(n) % max(1, n_speakers))
    out = []
    for k in range(n):
        mel = g.standard_normal((int(lengths[k]), n_mels), dtype=np.float32)
        out.append({"at": float(at[k]), "mel": mel * np.float32(2) - np.float32(4),
                    "seed": derived_seed(ctx.seed, 12, k),
                    "sid": int(sids[k]) if n_speakers else None})
    return out


def drive(ctx: Context, server, arrivals: list[dict], noise_scale: float, window) -> dict:
    """Run the arrivals through ``server`` in the window and drain it; the
    streams' pieces, first-audio ms and the window's bounds."""
    rec = ctx.recorder
    pieces: dict[int, list[np.ndarray]] = {}
    first_ms: dict[int, float] = {}
    handles: dict[int, int] = {}   # server handle -> arrival index
    lateness = []
    failed: set[int] = set()
    t0 = window.start()
    i = 0
    backlog = []
    while True:
        now = time.perf_counter() - t0
        while i < len(arrivals) and arrivals[i]["at"] <= now:
            a = arrivals[i]
            h = server.open(seed=a["seed"], sid=a["sid"], noise_scale=noise_scale)
            server.feed(h, a["mel"])
            server.close(h)
            handles[h] = i
            pieces[i] = []
            lateness.append(now - a["at"])
            i += 1
        if server.pending():
            with rec.span("vb.step", max_streams=server.max_streams, chunk=server.chunk) as sp:
                try:
                    out = server.step()
                except Exception:
                    traceback.print_exc(file=sys.stderr)
                    failed.update(pieces)
                    break
            t = sp.end
            sp.attrs["lengths"] = [int(len(w)) // server.hop for w in out.values()]
            sp.attrs["windows"] = len(out)
            for h, wav in out.items():
                k = handles[h]
                if k not in first_ms:
                    first_ms[k] = (t - t0 - arrivals[k]["at"]) * 1e3
                pieces[k].append(wav)
            backlog.append((t - t0, server.pending()))
        elif i < len(arrivals):
            with rec.span("vb.idle"):
                time.sleep(max(0.0, arrivals[i]["at"] - (time.perf_counter() - t0)))
        else:
            break
    t1 = window.stop()
    return {"pieces": pieces, "first_ms": first_ms, "failed": failed, "t0": t0, "t1": t1,
            "lateness_ms": [x * 1e3 for x in lateness], "backlog": backlog,
            "arrived": i}


def setup(ctx: Context):
    """Weights, the vocoder, the server after ``warmup``."""
    from smart_vocoder_torch.inference import Vocoder
    from smart_vocoder_torch.serving import StreamServer

    tr, rec = ctx.traffic, ctx.recorder
    sizes = graph.Sizes.from_config(ctx.config)
    with rec.span("setup.weights"):
        state = weights.make(graph.generator_params(sizes),
                             derived_seed(ctx.seed, 0), ctx.device)
    with rec.span("setup.vocoder"):
        voc = Vocoder(ctx.hps, state, device=ctx.device)
    with rec.span("setup.warmup"):
        server = StreamServer(voc, max_streams=int(tr["max_streams"]), chunk=int(tr["chunk"]),
                              overlap=int(tr["overlap"]))
        server.warmup()
    return sizes, state, voc, server


def run(ctx: Context) -> Record:
    tr = ctx.traffic
    sizes, state, voc, server = setup(ctx)
    with ctx.recorder.span("setup.inputs"):
        arrivals = make_arrivals(ctx, float(tr["rate_per_s"]), ctx.seconds, sizes.n_mels,
                                 sizes.n_speakers if sizes.conditioned else 0)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    window = ctx.window()
    res = drive(ctx, server, arrivals, float(tr["noise_scale"]), window)
    setup_s = res["t0"] - ctx.t_process
    peak = int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.device.type == "cuda" else 0
    voc.close()
    del voc, server
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    failed = set(res["failed"]) | {k for k in res["pieces"] if k not in res["first_ms"]}
    whole = {k: np.concatenate(p) for k, p in res["pieces"].items() if p and k not in failed}
    for k, w in whole.items():  # a stream cut short is failed
        if len(w) != len(arrivals[k]["mel"]) * sizes.hop:
            failed.add(k)
    record = Record(ctx, setup_s, res["t0"], res["t1"], res["arrived"], len(failed),
                    [], peak, window.trace,
                    data={"first_ms": res["first_ms"], "failed": sorted(failed),
                          "lateness_ms": res["lateness_ms"], "backlog": res["backlog"]})
    ok = sorted(k for k in whole if k not in failed)
    if ok:
        record.checks = check(ctx, state, sizes, arrivals, {k: whole[k] for k in ok})
    late = res["lateness_ms"]
    ctx.log(f"live: {res['arrived']} arrivals, {len(failed)} failed, admission late by "
            f"{np.mean(late) if late else 0:.3f} ms on average, {max(late, default=0):.3f} ms "
            "at most")
    return record


def sample_streams(ctx: Context, arrivals: list[dict], done: list[int]) -> list[int]:
    """``check_streams`` finished streams drawn from the seed, the longest
    among them."""
    k = min(int(ctx.traffic["check_streams"]), len(done))
    longest = max(done, key=lambda i: (len(arrivals[i]["mel"]), -i))
    rest = [i for i in done if i != longest]
    picked = list(rng(ctx.seed, 13).choice(rest, size=k - 1, replace=False)) if k > 1 else []
    return [longest] + sorted(int(i) for i in picked)


def check(ctx: Context, state, sizes, arrivals, whole: dict, numerics=graph.F32) -> list[Check]:
    """The sampled streams' joined pieces against the reference's windows."""
    tr = ctx.traffic
    picked = sample_streams(ctx, arrivals, sorted(whole))
    with compare.reference_precision():
        want = synthesis.streams(state, sizes, [arrivals[k]["mel"] for k in picked],
                                 [arrivals[k]["seed"] for k in picked],
                                 [arrivals[k]["sid"] for k in picked],
                                 [float(tr["noise_scale"])] * len(picked), int(tr["chunk"]),
                                 int(tr["overlap"]), ctx.device, nx=numerics)
    return compare.waveform_checks([whole[k] for k in picked], want, tr["limits"],
                                   ctx.config["data"])
