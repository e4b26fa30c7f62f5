"""On the card: each cell runs end to end for a few seconds and is correct,
traced and untraced, and each synthesis control reads above its cell's
limits. Run there with

    python -m pytest vocbench/tests/test_vocbench_cuda.py -m cuda -q
"""

import json
import subprocess
import sys

import pytest
import torch

from vocbench import run

CELLS = [w["name"] for w in run.load_json("BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def last_line(args):
    p = subprocess.run([sys.executable, "-m", *args], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell, trace):
    line = last_line(["vocbench.run", "--workload", cell, "--seed", str(2 ** 32 + 11),
                      "--seconds", "3", "--trace", str(trace)])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert all(v["value"] <= 105 for k, v in line["metrics"].items()
                   if "roofline" in k or "mfu" in k)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    bench = run.load_json("BENCHMARK.json")
    limits = run.load_json("vocbench", "traffic",
                           run.find(bench["workloads"], cell, "workload")["traffic"] + ".json")
    p = subprocess.run([sys.executable, "-m", "vocbench.control", "--workload", cell,
                        "--seeds", "91", "--seconds", "10"], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    gaps = json.loads(p.stdout.strip().splitlines()[-1])
    assert any(gaps[k] > v for k, v in limits["limits"].items()), (gaps, limits["limits"])
