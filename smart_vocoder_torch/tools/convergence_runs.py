"""The port's convergence evidence on the card, made through its tools.

    python -m smart_vocoder_torch.tools.convergence_runs OUT_DIR [--runs a,b,c,d] [--device cpu]

- (a) ``make_synth_data WORK/data 200 4``, then the ``train`` CLI on its
  config for 1000 steps: full-size iitp_base, single speaker.
- (b) ``make_synth_data WORK/data_ms 200 4 --ms``, then 2000 steps: the
  speaker-conditioned model.
- (c) ``make_ms_samples`` on (b)'s model directory (its newest ``G_*.pth``):
  2 validation clips x each of the 4 sids.
- (d) ``python -m smart_vocoder_torch.tools.fidelity_frontier 3 20`` in a
  fresh process.

The train CLI runs in this process (``train.main``; the config pins
``tpu.data_parallel: 1``, one rank on one card), so that its peak memory
(``torch.cuda.max_memory_allocated``) can be read after it. For (a) and
(b), ``OUT_DIR`` gets ``train.log``, the table that
``report_convergence`` writes from it, and in ``results.json``: the wall
time, the loop's ms a step (the median over the 20-step windows between two
loss lines of ``train.log``, read from its timestamps, the windows with an
eval or a save left out), each eval's and save's ms (from the timestamps
of the loss, eval and save lines of their step), the time to the first loss
line, peak memory, the eval trend and the trajectory checks against the JAX
runs in ``CONVERGENCE.md`` (no non-finite line; KL below 2 by step 200 and
after; ``loss/d/total`` in [1.5, 3.5] after step 100; the mean
``loss/g/mel`` over the last 100 steps within 25% of JAX's last rows). A
check that misses is reported, not raised. The work directory (corpora,
checkpoints) is a temporary one, removed at the end. Each result line names
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import datetime

import torch

from smart_vocoder_torch import train
from smart_vocoder_torch.tools import make_ms_samples, make_synth_data, report_convergence
from smart_vocoder_torch.utils.device import device_label, resolve_device

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLIPS, SPEAKERS = 200, 4
# run: (steps, --ms, JAX's loss/g/mel over its last rows, CONVERGENCE.md)
RUNS = {"a": (1000, False, (20.424, 21.142)), "b": (2000, True, (15.132, 15.446))}
MEL_REL = 0.25
KL_BOUND, KL_BY = 2.0, 200
D_BAND, D_AFTER = (1.5, 3.5), 100
SAMPLE_CLIPS = 2


def log_times(log_path: str) -> dict:
    """Seconds since the log's first line of each loss line (by step), eval
    line and save line (by the step they name). Loss and eval lines are the
    ones ``report_convergence.parse_line`` reads."""
    loss, evals, saves, t0 = {}, {}, {}, None
    with open(log_path) as f:
        for line in f:
            stamp = line.split("\t", 1)[0]
            try:
                t = datetime.strptime(stamp, "%Y-%m-%d %H:%M:%S,%f").timestamp()
            except ValueError:
                continue
            t0 = t if t0 is None else t0
            if got := report_convergence.parse_line(line):
                if got[0] == "loss":
                    loss[got[1][5]] = t - t0
                else:
                    evals[got[1][0]] = t - t0
            elif m := re.search(r"\tSaving model and optimizer state at iteration (\d+) ", line):
                saves[int(m.group(1))] = t - t0
    return {"loss": loss, "eval": evals, "save": saves}


def loop_timing(log_path: str) -> dict:
    """The loop's ms a step and each eval's and save's ms, from the times of
    ``train.log``'s lines (module docstring)."""
    t = log_times(log_path)
    steps = sorted(t["loss"])
    paused = set(t["eval"]) | set(t["save"])
    windows = [(t["loss"][b] - t["loss"][a]) / (b - a) * 1e3
               for a, b in zip(steps, steps[1:]) if a not in paused]
    evals_ms = {s: (t["eval"][s] - t["loss"][s]) * 1e3 for s in t["eval"] if s in t["loss"]}
    saves_ms = {s: (t["save"][s] - t["eval"].get(s, t["loss"][s])) * 1e3
                for s in t["save"] if s in t["loss"]}
    return {"step_ms": statistics.median(windows), "step_ms_min": min(windows),
            "step_ms_max": max(windows), "windows": len(windows),
            "eval_ms": evals_ms, "save_ms": saves_ms}


def trajectory_checks(rows, every: int, steps: int, jax_mel: tuple) -> dict:
    """The shape of the run's trajectory against the JAX run's: each check's
    reading and whether it holds."""
    got = [r[5] for r in rows]
    kl_at = [r[4] for r in rows if r[5] >= KL_BY]
    d_after = [r[0] for r in rows if r[5] > D_AFTER]
    last = [r[3] for r in rows if r[5] >= steps - 100]
    mel_mean = statistics.fmean(last)
    lo, hi = (1 - MEL_REL) * jax_mel[0], (1 + MEL_REL) * jax_mel[1]
    return {
        "finite": {"ok": got == list(range(0, steps, every))
                   and all(math.isfinite(v) for r in rows for v in r),
                   "rows": len(rows), "expected": len(range(0, steps, every))},
        "kl": {"ok": bool(kl_at) and max(kl_at) < KL_BOUND,
               "at_200": kl_at[0] if kl_at else None, "max_after": max(kl_at, default=None)},
        "d_band": {"ok": bool(d_after) and D_BAND[0] <= min(d_after)
                   and max(d_after) <= D_BAND[1],
                   "min": min(d_after, default=None), "max": max(d_after, default=None)},
        "mel_last_100": {"ok": lo <= mel_mean <= hi, "mean": mel_mean, "band": [lo, hi],
                         "jax": list(jax_mel)},
    }


def training_run(name: str, work: str, out_dir: str, device, card: str) -> dict:
    steps, ms, jax_mel = RUNS[name]
    cfg_path = make_synth_data.make_synth_data(os.path.join(work, f"data_{name}"), CLIPS,
                                               SPEAKERS, ms=ms)
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["tpu"]["data_parallel"] = 1  # one rank on one card, whatever the machine
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    every = cfg["train"]["log_interval"]
    argv = ["-c", cfg_path, "-m", f"run_{name}", "--max-steps", str(steps)]
    if device.type == "cpu":
        argv += ["--device", "cpu"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    cwd = os.getcwd()
    os.chdir(work)  # the CLI writes ./logs/<model>
    t0 = time.perf_counter()
    try:
        train.main(argv)
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    model_dir = os.path.join(work, "logs", f"run_{name}")
    log_path = os.path.join(model_dir, "train.log")
    shutil.copy(log_path, os.path.join(out_dir, f"train_{name}.log"))
    report = os.path.join(out_dir, f"report_{name}.md")
    report_convergence.main([model_dir, report, "100"])
    rows, evals = report_convergence.parse(log_path)
    res = {"steps": steps, "ms": ms, "config": cfg_path, "model_dir": model_dir,
           "wall_s": wall, "first_loss_line_s": log_times(log_path)["loss"].get(0),
           **loop_timing(log_path),
           "peak_allocated_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda
           else None,
           "peak_reserved_gib": torch.cuda.max_memory_reserved(device) / 2**30 if cuda
           else None,
           "evals": evals, "last_row": rows[-1],
           "checks": trajectory_checks(rows, every, steps, jax_mel), "device": card}
    print(f"run ({name}): {json.dumps({k: v for k, v in res.items() if k != 'evals'})}",
          flush=True)
    return res


def samples_run(run_b: dict, work: str, out_dir: str, device, card: str) -> list:
    with open(run_b["config"]) as f:
        val = json.load(f)["data"]["validation_files"]
    with open(val) as f:
        clips = [ln.split("|")[0] for ln in f.read().split()][:SAMPLE_CLIPS]
    argv = [run_b["config"], run_b["model_dir"], os.path.join(work, "samples")]
    argv += [f"{c}:{sid}" for c in clips for sid in range(SPEAKERS)]
    recs = make_ms_samples.main(argv + (["--device", "cpu"] if device.type == "cpu" else []))
    out = [{k: v for k, v in r.items() if k != "wav"} for r in recs]
    print(f"samples (c) of {make_ms_samples.generator_path(run_b['model_dir'])}: "
          f"{json.dumps(out)}  [{card}]", flush=True)
    return out


def frontier_run(out_dir: str, device, card: str) -> dict:
    cmd = [sys.executable, "-m", "smart_vocoder_torch.tools.fidelity_frontier", "3", "20"]
    if device.type == "cpu":
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=_ROOT, capture_output=True, text=True, timeout=1800)
    with open(os.path.join(out_dir, "frontier.txt"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"fidelity_frontier: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    rows = json.loads(proc.stdout.strip().splitlines()[-1])["frontier"]
    print(f"frontier (d), {time.perf_counter() - t0:.1f} s: {json.dumps(rows)}  [{card}]",
          flush=True)
    return {"frontier": rows, "wall_s": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--runs", default="a,b,c,d", help="which of a, b, c (needs b) and d")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = device_label(device)
    print(card, flush=True)
    runs = args.runs.split(",")
    os.makedirs(args.out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="svt_convergence_runs_")
    results = {"device": card}

    def save():
        with open(os.path.join(args.out_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=1)

    try:
        for name in runs:
            if name in RUNS:
                results[name] = training_run(name, work, args.out_dir, device, card)
            elif name == "c":
                results[name] = samples_run(results["b"], work, args.out_dir, device, card)
            elif name == "d":
                results[name] = frontier_run(args.out_dir, device, card)
            else:
                raise ValueError(f"unknown run {name!r}")
            save()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results


if __name__ == "__main__":
    main()
