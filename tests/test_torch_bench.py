"""The headline entry point (``python -m smart_vocoder_torch.bench``) on the CPU.

At a tiny config, ``bench.main(device="cpu", ...)`` times the serving path
and its hifi-0 datapoint for one call each and returns (and prints last) the
JAX ``bench.py`` line's keys. Its fidelity function is fed a fixture made as
``tests/fixtures/golden_iitp_base.npz`` was, at that tiny config: the JAX f32
``SynthesizerTrn.infer`` at matmul precision "highest" on the recipe's
weights (``fidelity_state_dict``, which equals ``fidelity_params``:
``tests/test_torch_golden_recipe.py``) and ``fidelity_inputs``' mel and noise.
The port's f32 path must land within mel-L1 1e-4 of it. A kernel route that
was asked for and not taken raises; the train phase merges the bf16 leg of
``tools/bench_train.py`` and leaves its keys out when that fails.
"""

import copy
import json
import subprocess
import sys

import flax
import jax
import numpy as np
import pytest
import torch

from smart_vocoder_torch import bench
from smart_vocoder_torch.utils.flops import H100_BF16_PEAK
from smart_vocoder_torch.utils.golden import NOISE_SCALE, fidelity_inputs, fidelity_state_dict
from smart_vocoder_tpu.models import build_synthesizer as jax_build
from smart_vocoder_tpu.models.synthesizer import SynthesizerTrn
from smart_vocoder_tpu.utils.torch_compat import torch_key_to_path
from test_torch_package import TINY_CFG, tiny_hparams

SERVING_KEYS = {"metric", "value", "unit", "achieved_tflops_per_s", "mfu", "mel_l1_vs_reference",
                "fidelity_target", "device", "hifi", "cudnn_benchmark"}


@pytest.fixture(scope="module")
def tiny_fixture(tmp_path_factory):
    """(port hparams, path of a golden fixture at the tiny config)."""
    jhps, thps = tiny_hparams()
    state = fidelity_state_dict(thps)
    params = flax.traverse_util.unflatten_dict(
        {torch_key_to_path(k): v.numpy() for k, v in state.items()})
    mel, lens, eps = fidelity_inputs(thps)
    net = jax_build(jhps, weight_norm=False)

    @jax.jit
    def synth(params, mel, lens, eps):
        wav, _, _ = net.apply({"params": params}, mel, lens, jax.random.key(0),
                              noise_scale=NOISE_SCALE, eps=eps, method=SynthesizerTrn.infer)
        return wav

    with jax.default_matmul_precision("highest"):
        wav = np.asarray(synth(params, mel, lens.astype(np.int32), eps))
    path = tmp_path_factory.mktemp("golden") / "golden_tiny.npz"
    np.savez(path, mel=mel, eps=eps, wav_ref=wav[0, :, 0], noise_scale=np.float32(NOISE_SCALE))
    return thps, str(path)


def test_headline_on_the_cpu(tiny_fixture, capsys):
    thps, fixture = tiny_fixture
    out = bench.main(device="cpu", hps=thps, batch=2, iters=1, train=False, fixture=fixture)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert set(out) == SERVING_KEYS | {"mel_l1_serving_hifi", "rtf_fast_bf16"}
    assert (out["metric"], out["unit"], out["hifi"]) == ("rtf_22k05_synthesis", "x_realtime", 2)
    assert out["cudnn_benchmark"] is torch.backends.cudnn.benchmark
    assert out["device"].startswith("cpu")
    assert all(np.isfinite(out[k]) and out[k] > 0 for k in ("value", "rtf_fast_bf16", "mfu"))
    assert out["mfu"] == pytest.approx(out["achieved_tflops_per_s"] * 1e12 / H100_BF16_PEAK)
    assert out["fidelity_target"] == 1e-2
    assert out["mel_l1_vs_reference"] <= 1e-4, out
    assert np.isfinite(out["mel_l1_serving_hifi"])


@pytest.mark.parametrize("mode,kw,hifi", [("bf16", {"fast": True}, 0),
                                          ("f32", {"f32": True}, 0),
                                          ("bf16", {"kernels": False}, 0),
                                          ("hifi", {"wn_kernels": True}, 2)])
def test_headline_modes(tiny_fixture, mode, kw, hifi):
    """``--fast``, ``--f32`` and ``--no-kernels`` time level 0 and name its
    serving mel-L1 by the dtype; ``--wn-kernels`` keeps hifi 2."""
    hps, fixture = tiny_fixture
    if kw.get("wn_kernels"):
        hps = copy.deepcopy(hps)
        hps.model.hidden_channels = 64  # the WN kernel route wants a multiple of 64
    out = bench.main(device="cpu", hps=hps, batch=1, iters=1, train=False, fixture=fixture,
                     **kw)
    assert out["hifi"] == hifi
    assert f"mel_l1_serving_{mode}" in out and ("rtf_fast_bf16" in out) == bool(hifi)
    if not kw.get("wn_kernels"):  # the hidden width changes the weights, not the fixture
        assert out["mel_l1_vs_reference"] <= 1e-4


def test_a_kernel_route_not_taken_raises(tiny_fixture):
    """No fallback: a ResBlock2 config has no kernel route, and asking for
    one ends the run."""
    cfg = copy.deepcopy(TINY_CFG)
    cfg["model"].update(resblock="2", resblock_dilation_sizes=[[1, 3], [1, 3], [1, 3]])
    _, thps = tiny_hparams(cfg)
    with pytest.raises(RuntimeError, match="not taken"):
        bench.main(device="cpu", hps=thps, batch=1, iters=1, train=False,
                   fixture=tiny_fixture[1])


def test_the_entry_point_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()


def _bench_train_line(leg):
    return json.dumps({"device": "card", "legs": {"bf16": leg}})


@pytest.mark.parametrize("outcome", ["ok", "failed", "timeout", "no_json"])
def test_train_metrics(monkeypatch, outcome):
    """The bf16 leg's step ms, audio x real time and TFLOP/s over the H100
    peak, from the tool's last JSON line; nothing on a failure."""
    leg = {"step_ms": 300.5, "audio_x_realtime": 496.3, "tflops": 18.6}
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        if outcome == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        stdout = {"ok": f"train step ...\n{_bench_train_line(leg)}\n", "failed": "",
                  "no_json": "train step ...\n"}[outcome]
        return subprocess.CompletedProcess(cmd, 1 if outcome == "failed" else 0, stdout,
                                           "Traceback: boom\n")

    monkeypatch.setattr(bench.subprocess, "run", run)
    got = bench.train_metrics("cfg.json")
    assert calls[0][1:] == ["-m", "smart_vocoder_torch.tools.bench_train", "--legs", "bf16",
                            "--config", "cfg.json"]
    if outcome == "ok":
        assert got == {"train_step_ms": 300.5, "train_audio_x_realtime": 496.3,
                       "train_mfu_wallclock": 18.6e12 / H100_BF16_PEAK}
    else:
        assert got == {}


def test_cli_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(bench, "main", lambda **kw: seen.update(kw))
    monkeypatch.setattr(sys, "argv", ["bench", "--no-kernels", "--wn-kernels", "--f32",
                                      "--fast", "--no-train", "--batch", "4", "--iters", "2",
                                      "--config", "c.json", "--device", "cpu"])
    bench._cli()
    assert seen == {"device": "cpu", "config": "c.json", "batch": 4, "iters": 2,
                    "kernels": False, "wn_kernels": True, "f32": True, "fast": True,
                    "train": False}
