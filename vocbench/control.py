"""The control of a synthesis cell's comparison: the plain reference put in
the program's place, computed in the precision below the configuration's.

    python3 -m vocbench.control --workload <cell> --seeds 11,12,13

The configuration runs in bfloat16, so the control rounds both operands of
every convolution to float8 e4m3 (``reference.graph.Numerics("fp8")``). For
each seed it makes the cell's inputs and weights as a run does, draws the
sample a run compares (for training: the first steps' rows), and prints the
gaps of the control's answers to the float32 reference's by every measure the
cell's comparison has; for training also those of a planted fault, the
reference stepped on the first half of each batch's rows (the mean taken over
the rest) against the whole batch. A limit is
sound only where the control reads above it. The benchmark's runs never run
this; it needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from vocbench import compare, run, weights
from vocbench.drivers import batch, live
from vocbench.harness import derived_seed
from vocbench.reference import graph, synthesis

FP8 = graph.Numerics("fp8")


def answers(ctx, numerics_list) -> list[list]:
    """The sampled answers of the cell under each of ``numerics_list``."""
    sizes = graph.Sizes.from_config(ctx.config)
    state = weights.make(graph.generator_params(sizes), derived_seed(ctx.seed, 0), ctx.device)
    tr = ctx.traffic
    out = []
    with compare.reference_precision():
        if tr["driver"] == "batch":
            calls = batch.make_calls(ctx, sizes.n_mels)
            picked = batch.sample_calls(ctx, calls, list(range(len(calls))))
            for nx in numerics_list:
                got = []
                for i in picked:
                    c = calls[i]
                    got.extend(synthesis.batch_call(state, sizes, c["mel"], c["lengths"],
                                                    float(tr["noise_scale"]),
                                                    batch.call_seed(ctx, i), ctx.device, nx=nx))
                out.append(got)
        elif tr["driver"] == "live":
            arrivals = live.make_arrivals(ctx, float(tr["rate_per_s"]), ctx.seconds, sizes.n_mels,
                                          sizes.n_speakers if sizes.conditioned else 0)
            picked = live.sample_streams(ctx, arrivals, list(range(len(arrivals))))
            for nx in numerics_list:
                out.append(synthesis.streams(
                    state, sizes, [arrivals[k]["mel"] for k in picked],
                    [arrivals[k]["seed"] for k in picked], [arrivals[k]["sid"] for k in picked],
                    [float(tr["noise_scale"])] * len(picked), int(tr["chunk"]),
                    int(tr["overlap"]), ctx.device, nx=nx))
        else:
            raise SystemExit(f"vocbench.control: no synthesis control for {tr['driver']!r}")
    return out


def control_gaps(ctx) -> dict:
    if ctx.traffic["driver"] == "train":
        return train_control_gaps(ctx)
    want, got = answers(ctx, [graph.F32, FP8])
    return compare.waveform_gaps(got, want, ctx.config["data"])


def train_control_gaps(ctx) -> dict:
    """The training cell's numbers for the reference's first steps in fp8
    against the same steps in float32, on the rows the program's sampler
    gives the first epoch's first batches (longest row first, as the loader
    collates them)."""
    import tempfile

    from smart_vocoder_torch.data import AudioSpecDataset, BucketSampler

    from vocbench.drivers import train
    from vocbench.reference import train as ref

    tr, cfg = ctx.traffic, ctx.config
    sizes = graph.Sizes.from_config(cfg)
    ctx.hps.train.seed = derived_seed(ctx.seed, 20) % 2 ** 31
    lengths = train.corpus_lengths(list(ctx.hps.tpu.bucket_boundaries), *tr["frames"],
                                   int(tr["clips_per_bucket"]))
    clips = train.make_clips(ctx, lengths)
    with tempfile.TemporaryDirectory(prefix="vocbench-corpus-") as tmp:
        filelist = train.write_corpus(clips, int(cfg["data"]["sampling_rate"]), tmp)
        dataset = AudioSpecDataset(filelist, ctx.hps.data)
        sampler = BucketSampler(dataset.lengths, ctx.hps.train.batch_size,
                                list(ctx.hps.tpu.bucket_boundaries), shuffle=True)
        sampler.set_epoch(1)
        batches = list(iter(sampler))[: train.COMPARE_STEPS]
    seen = {"rows": [sorted((dataset.lengths[i] for i in b), reverse=True) for b in batches],
            "frames": [sampler.bucket_boundary(b) for b in batches]}
    gparams, dparams = graph.generator_params(sizes), ref.discriminator_params()
    g0 = weights.make(gparams, derived_seed(ctx.seed, 0), ctx.device, conv_post_gain=1.0,
                      weight_norm=ref.generator_weight_norm(gparams))
    d0 = weights.make(dparams, derived_seed(ctx.seed, 1), ctx.device,
                      weight_norm=ref.discriminator_weight_norm(dparams))
    g0 = {k: v.cpu() for k, v in g0.items()}
    d0 = {k: v.cpu() for k, v in d0.items()}
    want = train.reference_steps(ctx, sizes, clips, g0, d0, seen)
    fp8 = train.gaps(train.reference_steps(ctx, sizes, clips, g0, d0, seen, numerics=FP8), want)
    half = {"rows": [r[: len(r) // 2] for r in seen["rows"]], "frames": seen["frames"]}
    halved = train.gaps(train.reference_steps(ctx, sizes, clips, g0, d0, half), want)
    return {**fp8, **{f"half_batch.{k}": v for k, v in halved.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vocbench.control: no CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json("BENCHMARK.json")
    cell = run.find(bench["workloads"], args.workload, "workload")
    seconds = args.seconds or float(bench["run_seconds"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = run.make_context(cell, bench, seed, seconds, False, torch.device("cuda", 0))
        gaps = control_gaps(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "fp8", **gaps}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
