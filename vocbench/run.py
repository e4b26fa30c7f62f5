"""The benchmark of ``smart_vocoder_torch`` on NVIDIA GPUs: one run of one cell.

    python3 -m vocbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with ``--trace
1``), ``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``,
each number compared beside its limit. The same checks are the last lines of
standard error.

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:

- the cell (``workloads``) names its configuration and its traffic;
- a configuration is ``vocbench/configs/<config>.json``: the model config as
  run (``train``, ``data``, ``model``, ``tpu``) with its ``source``,
  ``reduced``, ``assumed`` and ``deployment``; a ``deployment`` object's
  ``torch_threads`` sets torch's intra-op threads before the program is built
  (``host.place``);
- a traffic mix is ``vocbench/traffic/<traffic>.json``: parameters, among
  them ``driver``, the module ``vocbench/drivers/<driver>.py`` whose
  ``run(ctx)`` makes the inputs from the seed, drives the program through the
  window, records its spans and compares its answers with the plain
  reference (``vocbench/reference/``);
- a metric, end-to-end or per-layer, is ``vocbench/metrics/<name>.py``, whose
  ``read(record)`` returns its value or ``None`` where the run has nothing to
  read; a metric is reported in the cells its ``workloads`` list, or in every
  cell without one.

A new cell, configuration, traffic mix or metric is a new file and a new entry
in ``BENCHMARK.json``; no file here names one.

Fixed directories: the program builds its CUDA kernels into
``smart_vocoder_torch/_build/`` inside the checkout; Triton's cache is
``.vocbench_cache/triton`` at the checkout's root (``TRITON_CACHE_DIR``, set
here, before anything imports Triton). A run writes nothing else to disk
except where a traffic mix says so (the training cell's corpus, under
``TMPDIR``). Standard error also carries, before the checks, the window's
``vb.call`` or ``vb.step`` durations and a ``host:`` line (``host.py``):
torch's threads, and the CPU seconds and memory the run took over the window.
A run needs the CUDA devices the cell asks for: without them it exits with
code 2 and prints no result; it never falls back to the CPU. It also exits
with code 3 and no result if ``jax``, ``jaxlib``, ``flax`` or
``smart_vocoder_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

from vocbench import host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "smart_vocoder_tpu")


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (Linux ``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROCESS = process_start()


def load_json(*parts: str) -> dict:
    with open(os.path.join(ROOT, *parts), encoding="utf-8") as f:
        return json.load(f)


def find(items: list[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"vocbench: no {what} named {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, section: str, cell: str) -> list[dict]:
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    path = os.path.join(ROOT, "vocbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"vocbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def make_context(cell: dict, bench: dict, seed: int, seconds: float, trace: bool, device,
                 config_override: dict | None = None):
    """The driver's context for ``cell``; ``config_override`` replaces the
    configuration file's JSON (the CPU tests' tiny model)."""
    from smart_vocoder_torch.config import HParams, validate

    from vocbench.harness import Context

    conf = find(bench["configs"], cell["config"], "configuration")
    config = config_override or load_json(conf["file"])
    run_keys = {k: config[k] for k in ("train", "data", "model", "tpu") if k in config}
    hps = validate(HParams(**json.loads(json.dumps(run_keys))))
    traffic = load_json("vocbench", "traffic", f"{cell['traffic']}.json")
    return Context(cell=cell, config=config, hps=hps, traffic=traffic, seed=seed,
                   seconds=seconds, trace=trace, device=device, t_process=T_PROCESS,
                   log=lambda *a: print(*a, file=sys.stderr))


def execute(ctx, bench: dict):
    """Drive the cell and read its metrics: (record, result dict)."""
    driver = importlib.import_module(f"vocbench.drivers.{ctx.traffic['driver']}")
    record = driver.run(ctx)
    section = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, section, ctx.cell["name"]):
        value = load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": record.correct, "attempted": int(record.attempted),
              "failed": int(record.failed), "metrics": metrics}
    return record, result


def device_info(device, count: int, record) -> dict:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": count, "memory_peak_bytes": int(record.memory_peak_bytes)}
    if record.trace is not None:
        info["busy_s"] = record.trace.busy()
        info["window_s"] = record.trace.window_s
    return info


def result_line(record, result: dict, device, count: int) -> dict:
    """The result object: the contract's keys, ``breakdown`` for a traced
    run, and last ``checks``, each number compared with its limit."""
    from vocbench.harness import breakdown

    out = dict(result, device=device_info(device, count, record))
    if record.trace is not None:
        out["breakdown"] = breakdown(record)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in record.checks}
    return out


def print_durations(name: str, ms: list[float]) -> None:
    """One line of a span's durations in the window: count, quartiles, the
    tail, and the first three in order (a slow start shows there)."""
    if not ms:
        return
    q = sorted(ms)
    q1, q2, q3 = statistics.quantiles(q, n=4) if len(q) > 1 else (q[0],) * 3
    print(f"{name}: {len(q)} in the window, ms min {q[0]:.1f} q1 {q1:.1f} median {q2:.1f} "
          f"q3 {q3:.1f} p90 {q[int(0.9 * (len(q) - 1))]:.1f} max {q[-1]:.1f} mean "
          f"{statistics.fmean(q):.2f}; first {' '.join(f'{x:.1f}' for x in ms[:3])}",
          file=sys.stderr)


def host_lines(record, threads: int) -> list[str]:
    """A ``host:`` line for each window of the run: torch's intra-op threads
    and the host's counters over the window."""
    return [host.line({"torch_threads": threads, **host.window_report(*w.host)})
            for w in record.ctx.windows if len(w.host) == 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".vocbench_cache", "triton")
    bench = load_json("BENCHMARK.json")
    cell = find(bench["workloads"], args.workload, "workload")
    try:
        import torch
    except ImportError as e:
        print(f"vocbench: {e}", file=sys.stderr)
        return 2
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vocbench: the cell needs {chips} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    ctx = make_context(cell, bench, args.seed, args.seconds, bool(args.trace), device)
    threads = host.place(ctx.config.get("deployment"))
    record, result = execute(ctx, bench)
    bad = forbidden_modules()
    if bad:
        print(f"vocbench: loaded in this process once the window closed: {bad}",
              file=sys.stderr)
        return 3
    line = result_line(record, result, device, chips)
    for name in ("vb.call", "vb.step"):
        print_durations(name, [1e3 * (s.end - s.start) for s in record.named(name)])
    for text in host_lines(record, threads):
        print(text, file=sys.stderr)
    parts = [s for s in record.spans if s.name.startswith("setup.")]
    if parts:
        split = {"imports": parts[0].start - T_PROCESS,
                 **{s.name[len("setup."):]: s.end - s.start for s in parts}}
        print("setup_s split: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()),
              file=sys.stderr)
    for c in record.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
