"""The run's contract: the result line's keys, no result without a card, the
metric readers on a known trace, and the modules a run may load."""

import json
import os
import subprocess
import sys

import pytest
import torch

from vocbench import harness, run
from vocbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["iitp_base.batch", "iitp_base_ms.live"])
def test_result_line_keys(cell):
    ctx, b = tiny.context(cell)
    record, result = run.execute(ctx, b)
    line = run.result_line(record, result, torch.device("cpu"), 1)
    assert list(line) == KEYS  # the contract's keys, checks last
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in run.metrics_for(b, "end_to_end", cell)}
    assert set(line["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["checks"]) == set(ctx.traffic["limits"])
    json.dumps(line)


def test_no_card_no_result():
    """Without the cell's CUDA devices a run exits 2 and prints nothing on
    standard output; it never falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "vocbench.run", "--workload", "iitp_base.batch",
                        "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=run.ROOT,
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode == 2
    assert p.stdout == ""


def test_every_metric_has_a_reader_and_a_cell():
    b = tiny.bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(run.ROOT, "vocbench", "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", cells)) <= cells
    for w in b["workloads"]:
        assert run.metrics_for(b, "per_layer", w["name"]), w["name"]
        names = {m["name"] for m in run.metrics_for(b, "end_to_end", w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert os.path.exists(os.path.join(run.ROOT, "vocbench", "traffic",
                                           f"{w['traffic']}.json"))


def test_trace_readers_on_a_known_trace():
    """Busy union, idle share, host time inside calls, gap labels and the
    roofline reader on hand-made intervals."""
    rec = harness.Recorder()
    ctx, _ = tiny.context("iitp_base.batch")
    ctx.recorder = rec
    rec.spans += [harness.Span("vb.call", 0.0, 1.0, {"ok": True, "frames": [100], "audio_s": 1.0}),
                  harness.Span("vb.call", 1.0, 2.0, {"ok": True, "frames": [100], "audio_s": 1.0})]
    ops = [(0.1, 0.5, "k"), (0.4, 0.6, "void up_mrf_stage_kernel<64>"),
           (1.2, 1.8, "void mrf_stage_kernel<64, 1>")]
    record = harness.Record(ctx, 1.0, 0.0, 2.0, 2, 0, [], 0, harness.Trace(ops, 0.0, 2.0))
    assert record.trace.busy() == pytest.approx(0.5 + 0.6)
    assert run.load_reader("device_idle.synth")(record) == pytest.approx(100 * (1 - 1.1 / 2))
    assert run.load_reader("synth.host_ms")(record) == pytest.approx(1e3 * 0.45)
    assert run.load_reader("synth_x_realtime")(record) == pytest.approx(1.0)
    assert run.load_reader("mrf_roofline.synth")(record) > 0
    bd = harness.breakdown(record)
    assert bd["idle_gaps"][0][0] == "vb.call"
    assert sum(s for _, s in bd["idle_gaps"]) == pytest.approx(2 - 1.1)
    assert bd["device_ops"][0] == ["void mrf_stage_kernel<64, 1>", pytest.approx(0.6)]
    # nothing to read: no share is made up as 0
    empty = harness.Record(ctx, 1.0, 0.0, 2.0, 0, 0, [], 0, harness.Trace([], 0.0, 2.0))
    ctx.recorder = harness.Recorder()
    assert run.load_reader("mrf_roofline.synth")(empty) is None


IMPORT_CHECK = """
import sys, importlib, pkgutil
import vocbench
names = [m.name for m in pkgutil.walk_packages(vocbench.__path__, 'vocbench.')
         if '.tests' not in m.name]
for n in names:
    importlib.import_module(n)
from vocbench import run
for path in __import__('glob').glob(run.ROOT + '/vocbench/metrics/*.py'):
    run.load_reader(path.rsplit('/', 1)[1][:-3])
print(sorted({m.split('.')[0] for m in sys.modules}))
"""

REFERENCE_CHECK = """
import sys, importlib, pkgutil
import vocbench.reference as r
for m in pkgutil.walk_packages(r.__path__, 'vocbench.reference.'):
    importlib.import_module(m.name)
print(sorted({m.split('.')[0] for m in sys.modules}))
"""


def loaded(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=300, check=True)
    return set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))


def test_no_jax_anywhere_and_no_program_in_the_reference():
    """Whole top-level module names: the port's name begins with the JAX
    package's, so a prefix test would be wrong."""
    everything = loaded(IMPORT_CHECK)
    assert not everything & {"jax", "jaxlib", "flax", "smart_vocoder_tpu"}
    reference = loaded(REFERENCE_CHECK)
    assert not reference & {"jax", "jaxlib", "flax", "smart_vocoder_tpu", "smart_vocoder_torch"}
    assert "torch" in reference
