"""The knee of a live cell: its traffic at several arrival rates through one
server, one window a rate, in one process.

    python3 -m vocbench.sweep --workload <live cell> --rates 10,20,30 --seconds 30 --seed 7

For each rate it prints one JSON line: arrivals, the median and 95th
percentile of first-audio ms, the unfinished streams (arrived, not finished)
averaged over the window's middle and last thirds, and how long the drain
took after the last arrival. The knee is the highest rate whose unfinished
count does not grow over the window; a live cell's traffic file states its
rate as a fixed share of it. This needs the card; the benchmark's runs never
call it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from vocbench import run
from vocbench.drivers import live
from vocbench.harness import Window


def one_rate(ctx, server, sizes, rate: float) -> dict:
    arrivals = live.make_arrivals(ctx, rate, ctx.seconds, sizes.n_mels,
                                  sizes.n_speakers if sizes.conditioned else 0)
    res = live.drive(ctx, server, arrivals, float(ctx.traffic["noise_scale"]),
                     Window(ctx.device, False))
    s = ctx.seconds

    def unfinished(lo, hi):
        v = [n for t, n in res["backlog"] if lo <= t < hi]
        return float(np.mean(v)) if v else 0.0

    first = list(res["first_ms"].values())
    return {"rate_per_s": rate, "arrivals": len(arrivals), "emitted": len(first),
            "first_ms_p50": float(np.percentile(first, 50)) if first else None,
            "first_ms_p95": float(np.percentile(first, 95)) if first else None,
            "unfinished_mid": unfinished(s / 3, 2 * s / 3),
            "unfinished_last": unfinished(2 * s / 3, s),
            "drain_s": res["t1"] - res["t0"] - s,
            "steps": len(res["backlog"]),
            "admission_late_ms_mean": float(np.mean(res["lateness_ms"]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vocbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json("BENCHMARK.json")
    cell = run.find(bench["workloads"], args.workload, "workload")
    ctx = run.make_context(cell, bench, args.seed, args.seconds, False, torch.device("cuda", 0))
    sizes, _, voc, server = live.setup(ctx)
    for rate in (float(r) for r in args.rates.split(",")):
        print(json.dumps(one_rate(ctx, server, sizes, rate)), flush=True)
    voc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
