"""The port's training-evidence tools on the CPU, each against the JAX
script it ports (loaded from ``scripts/`` by path):

- ``tools/report_convergence.py``: the same markdown as
  ``scripts/report_convergence.py`` from the ``train.log`` of a 3-step run of
  the port's loop (a loss line every step, evals at steps 0 and 2), and from a
  hand-written log with malformed lines; no loss row exits with the script's
  message.
- ``tools/make_ms_samples.py``: at a tiny speaker-conditioned config whose
  ``G_*.pth`` holds a JAX parameter tree (``torch_state_dict_from_params``),
  the tool's audio is ``Vocoder.wav_to_wav(sid=...)``'s bit for bit, whether
  named by file or by model directory; its mel-L1 is the JAX script's formula
  (``smart_vocoder_tpu.ops.mel_spectrogram``) within 1e-5; two sids differ.
  On the same ``.pth``, the port's f32 ``wav_to_wav`` at ``noise_scale=0``
  with a sid matches JAX's ``Vocoder.wav_to_wav`` within 5e-4 (the f32
  serving tests' tolerance).
- ``tools/fidelity_frontier.py``: at a tiny config with the fixture's noise
  pinned, each of the five points is the port's ``Vocoder`` at that level
  (the f32 point ``bench --f32``'s route), and the tool's rows carry those
  waveforms' mel-L1.
- Without a card and without ``--device cpu`` the device tools raise.
- ``tools/convergence_runs.py`` reads a ``train.log``'s timestamps into the
  loop's ms a step and each eval's and save's ms, and holds a trajectory to
  the JAX runs' shape.
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from smart_vocoder_torch.bench import golden_case
from smart_vocoder_torch.config import get_hparams
from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.tools import (fidelity_frontier, make_ms_samples, make_synth_data,
                                       report_convergence)
from smart_vocoder_torch.training import loop as loop_lib
from smart_vocoder_torch.utils.golden import fidelity_inputs, fidelity_state_dict
from smart_vocoder_tpu.inference import Vocoder as JaxVocoder
from smart_vocoder_tpu.ops import MelConfig as JaxMelConfig
from smart_vocoder_tpu.ops import mel_spectrogram as jax_mel_spectrogram
from smart_vocoder_tpu.utils.checkpoint import load_reference_generator
from smart_vocoder_tpu.utils.torch_compat import save_torch_checkpoint
from test_torch_package import TINY_CFG, jax_synth_params, tiny_hparams
from test_torch_streaming import one_thread  # noqa: F401 (autouse fixture)
from test_torch_synth_data import jax_script
from test_torch_train_loop import make_config

JAX_TOL = 5e-4
MEL_L1_TOL = 1e-5


def both_reports(tmp_path, monkeypatch, capsys, model_dir, every):
    """(port's markdown, port's line, JAX script's markdown, its line)."""
    out_port, out_jax = str(tmp_path / "port.md"), str(tmp_path / "jax.md")
    report_convergence.main([model_dir, out_port, str(every)])
    said_port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["report_convergence.py", model_dir, out_jax, str(every)])
    jax_script("report_convergence").main()
    said_jax = capsys.readouterr().out
    with open(out_port) as a, open(out_jax) as b:
        return a.read(), said_port, b.read(), said_jax.replace(out_jax, out_port)


def test_report_of_the_loops_log(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    hps = get_hparams(["-c", make_config(str(tmp_path)), "-m", "run"])
    loop_lib.run(hps, max_steps=3, device="cpu")
    capsys.readouterr()
    rows, evals = report_convergence.parse(os.path.join(hps.model_dir, "train.log"))
    assert [r[5] for r in rows] == [0, 1, 2] and [s for s, _ in evals] == [0, 2]
    md, said, md_jax, said_jax = both_reports(tmp_path, monkeypatch, capsys, hps.model_dir, 2)
    assert md == md_jax and said == said_jax
    assert "| 2 | " in md and "| step | eval/mel_l1 |" in md


HAND_LOG = """\
2026-01-01 00:00:00,000\trun\tINFO\tsummary writer: x
2026-01-01 00:00:00,001\trun\tINFO\t[5.9, 281.8, 0.35, 137.4, 139.6, 0, 0.0002]
2026-01-01 00:00:00,002\trun\tINFO\teval step 0: mel_l1 1.2345
2026-01-01 00:00:00,003\trun\tINFO\t[2.4, 37.1, 2.8, 30.2, 1.9, 40, 0.0002
2026-01-01 00:00:00,004\trun\tINFO\t[2.4, 37.1, 2.8, 30.2, 1.9, 60]
2026-01-01 00:00:00,005\trun\tINFO\t[nan, 37.1, 2.8, 30.2, 1.9, 80, 0.0002]
2026-01-01 00:00:00,006\trun\tINFO\teval step 100: mel_l1 nan
[2.0, 30.0, 2.0, 25.0, 1.0, 90, 0.0002]
2026-01-01 00:00:00,007\trun\tWARNING\t[2.0, 30.0, 2.0, 25.0, 1.0, 95, 0.0002]
2026-01-01 00:00:00,008\trun\tINFO\t[2.419, 37.118, 2.871, 30.267, 1.944, 100, 0.000199975]
2026-01-01 00:00:00,009\trun\tINFO\t[2.63, 34.375, 2.146, 29.224, 1.129, 140, 0.000199975]
2026-01-01 00:00:00,010\trun\tINFO\teval step 200: mel_l1 0.98765
2026-01-01 00:00:00,011\trun\tINFO\t[2.7, 30.6, 2.0, 25.5, 1.07, 210, 0.00019995]
2026-01-01 00:00:00,012\trun\tINFO\t[2.5, 25.8, 2.8, 20.4, 0.65, 230, 0.00019995]
"""


@pytest.mark.parametrize("every", [100, 1])
def test_report_of_a_hand_written_log(tmp_path, monkeypatch, capsys, every):
    (tmp_path / "train.log").write_text(HAND_LOG)
    rows, evals = report_convergence.parse(str(tmp_path / "train.log"))
    assert [r[5] for r in rows] == [0, 100, 140, 210, 230]  # malformed and nan rows skipped
    assert evals == [(0, 1.2345), (200, 0.98765)]
    md, said, md_jax, said_jax = both_reports(tmp_path, monkeypatch, capsys, str(tmp_path), every)
    assert md == md_jax and said == said_jax


def test_report_without_loss_rows(tmp_path):
    (tmp_path / "train.log").write_text("2026-01-01 00:00:00,000\trun\tINFO\tnothing\n")
    with pytest.raises(SystemExit, match="no loss rows found"):
        report_convergence.main([str(tmp_path), str(tmp_path / "report.md")])


def test_tools_need_their_out_argument(tmp_path):
    """Neither tool falls back to a default output path: the scripts' defaults
    (``CONVERGENCE.md`` in the working directory, a fixed temporary directory)
    would overwrite the JAX package's record or another checkout's corpus."""
    with pytest.raises(SystemExit, match="usage: report_convergence MODEL_DIR OUT.md"):
        report_convergence.main([str(tmp_path)])
    with pytest.raises(SystemExit, match="usage: make_synth_data OUT"):
        make_synth_data.main(["--ms"])


# a tiny speaker-conditioned config whose decoder stages 3-4 take the kernel route
MS_CFG = copy.deepcopy(TINY_CFG)
MS_CFG["data"]["n_speakers"] = 4
MS_CFG["model"].update(gin_channels=16, use_spk_embed=True)


@pytest.fixture(scope="module")
def ms_checkpoint(tmp_path_factory):
    """(JAX hparams, config path, ``G_*.pth`` path, wav path) at MS_CFG: a JAX
    parameter tree saved by the JAX package's ``.pth`` writer, and a 1.2 s
    harmonic clip."""
    root = tmp_path_factory.mktemp("ms")
    jhps, _ = tiny_hparams(MS_CFG)
    cfg = root / "config.json"
    cfg.write_text(json.dumps(MS_CFG))
    run = root / "run"
    run.mkdir()
    params = jax_synth_params(jhps, seed=3)
    pth = str(run / "G_7.pth")
    save_torch_checkpoint(pth, params, iteration=7, learning_rate=2e-4)
    open(run / "D_7.pth", "wb").close()  # a pair, as the loop writes them
    t = np.arange(int(1.2 * 22050)) / 22050
    wav = 0.3 * sum(np.sin(2 * np.pi * 150 * h * t) / h for h in (1, 2, 3))
    wav_path = str(root / "clip.wav")
    wavfile.write(wav_path, 22050, (wav * 32767).astype(np.int16))
    return jhps, str(cfg), pth, wav_path


def test_ms_samples_are_wav_to_wav(ms_checkpoint, tmp_path, capsys):
    jhps, cfg, pth, wav_path = ms_checkpoint
    got = make_ms_samples.main([cfg, os.path.dirname(pth), str(tmp_path),
                                f"{wav_path}:1", f"{wav_path}:3", "--device", "cpu"])
    said = capsys.readouterr().out.strip().splitlines()
    assert len(said) == 2 and said[0].startswith(str(tmp_path / "clip_sid1.wav") + ": 1.20s in ")
    assert "x RT), copy-synth mel_l1 " in said[0]
    voc = Vocoder.from_torch_checkpoint(cfg, pth, device="cpu")
    assert (voc.dtype, voc.hifi, voc.use_kernels) == (torch.bfloat16, 2, True)
    _, data = wavfile.read(wav_path)
    wav = data.astype(np.float32) / 32768.0
    mel_cfg = JaxMelConfig.from_hparams(jhps)
    usable = (len(wav) // 16) * 16
    for rec, sid in zip(got, (1, 3)):
        want = voc.wav_to_wav(wav, sid=np.asarray([sid]))
        np.testing.assert_array_equal(rec["wav"], want)
        sr, written = wavfile.read(rec["path"])
        assert sr == 22050
        np.testing.assert_array_equal(written, (np.clip(want, -1, 1) * 32767).astype(np.int16))
        l1 = float(jnp.mean(jnp.abs(
            jax_mel_spectrogram(jnp.asarray(wav[None, :usable]), mel_cfg)
            - jax_mel_spectrogram(jnp.asarray(want[None, :usable]), mel_cfg))))
        assert abs(rec["mel_l1"] - l1) <= MEL_L1_TOL, (rec["mel_l1"], l1)
        assert rec["seconds"] == pytest.approx(usable / 22050)
    assert not np.array_equal(got[0]["wav"], got[1]["wav"])
    assert make_ms_samples.generator_path(os.path.dirname(pth)) == pth


def test_conditioned_wav_to_wav_matches_jax(ms_checkpoint):
    """At ``noise_scale=0`` the prior noise drops out, so the two packages'
    copy synthesis of one clip with one sid is one function of the ``.pth``."""
    jhps, cfg, pth, wav_path = ms_checkpoint
    _, data = wavfile.read(wav_path)
    wav = data.astype(np.float32) / 32768.0
    port = Vocoder.from_torch_checkpoint(cfg, pth, dtype=torch.float32, use_kernels=False,
                                         device="cpu")
    params, _ = load_reference_generator(pth, jax_synth_params(jhps))
    with jax.default_matmul_precision("highest"):
        jvoc = JaxVocoder(jhps, jax.tree.map(jnp.asarray, params), dtype=jnp.float32,
                          use_pallas=False)
        wants = []
        for sid in (0, 2):
            want = jvoc.wav_to_wav(wav, sid=np.asarray([sid]), noise_scale=0.0)
            got = port.wav_to_wav(wav, sid=np.asarray([sid]), noise_scale=0.0)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=JAX_TOL)
            wants.append(want)
    # the sid moves JAX's waveform far beyond the tolerance, so a port that
    # dropped or mis-sliced the speaker conditioning would fail above
    assert np.max(np.abs(wants[0] - wants[1])) >= 10 * JAX_TOL


def test_frontier_points_are_the_vocoders(tmp_path, capsys):
    _, thps = tiny_hparams()
    state = fidelity_state_dict(thps)
    mel, lens, eps = fidelity_inputs(thps)
    ref = Vocoder(thps, state, dtype=torch.float32, use_kernels=False, device="cpu")
    wav_ref = ref._infer(torch.from_numpy(mel), torch.from_numpy(lens), torch.from_numpy(eps),
                         0.667)
    fixture = str(tmp_path / "golden_tiny.npz")
    np.savez(fixture, mel=mel, eps=eps, wav_ref=wav_ref[0, :, 0].numpy(),
             noise_scale=np.float32(0.667))
    rows = fidelity_frontier.main(reps=2, iters=1, device="cpu", hps=thps, state=state,
                                  fixture=fixture, batch=2, frames=32)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"frontier": rows}
    assert [r["point"] for r in rows] == [p[0] for p in fidelity_frontier.POINTS]
    assert [r["batch"] for r in rows] == [2] * 5
    assert all(np.isfinite(r["ms"]) and r["rtf"] > 0 for r in rows)

    gmel, glens, geps, ns, mel_l1 = golden_case(thps, fixture, torch.device("cpu"))
    points = fidelity_frontier.point_vocoders(thps, state, "cpu")
    for (name, dtype, level), row in zip(fidelity_frontier.POINTS, rows):
        voc = Vocoder(thps, state, dtype=dtype, use_kernels=True, hifi=level, device="cpu")
        got = points[name]._infer(gmel, glens, geps, ns)
        assert torch.equal(got, voc._infer(gmel, glens, geps, ns)), name
        assert row["mel_l1"] == round(mel_l1(got), 5), name
    assert rows[-1]["mel_l1"] <= 1e-4  # the f32 kernel route against the f32 module graph


def test_device_tools_need_the_card(ms_checkpoint, tmp_path, monkeypatch):
    _, cfg, pth, wav_path = ms_checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_ms_samples.main([cfg, pth, str(tmp_path), f"{wav_path}:0"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fidelity_frontier.main(reps=1, iters=1)


def test_convergence_runs_read_the_log(tmp_path):
    """``tools/convergence_runs.py``'s readings of a ``train.log``: the loop's
    ms a step from the 20-step windows without an eval or a save, each
    eval's and save's ms, and the trajectory checks against JAX's rows."""
    from smart_vocoder_torch.tools import convergence_runs

    lines = [("00,000", "summary writer: x"),
             ("01,000", "[6.0, 280.0, 0.3, 137.0, 139.0, 0, 0.0002]"),
             ("03,000", "eval step 0: mel_l1 1.0000"),
             ("05,500", "Saving model and optimizer state at iteration 0 to r/G_0.pth (+D)"),
             ("11,000", "[2.4, 37.0, 2.8, 30.0, 1.9, 20, 0.0002]"),
             ("17,000", "[2.5, 35.0, 2.8, 24.0, 1.1, 40, 0.0002]"),
             ("25,000", "[2.6, 33.0, 2.8, 22.0, 0.9, 60, 0.0002]")]
    log = tmp_path / "train.log"
    log.write_text("".join(f"2026-01-01 00:00:{t}\trun\tINFO\t{m}\n" for t, m in lines)
                   + "2026-01-01 00:00:26,000\trun\tWARNING\t[1.0, 1.0, 1.0, 1.0, 1.0, 80, 0.1]\n")
    # the timed lines are the ones the report's parser reads, the WARNING not
    rows, evals = report_convergence.parse(str(log))
    times = convergence_runs.log_times(str(log))
    assert sorted(times["loss"]) == [r[5] for r in rows] == [0, 20, 40, 60]
    assert sorted(times["eval"]) == [s for s, _ in evals] == [0]
    got = convergence_runs.loop_timing(str(log))
    assert got["windows"] == 2 and got["step_ms"] == pytest.approx(350.0)
    assert (got["step_ms_min"], got["step_ms_max"]) == pytest.approx((300.0, 400.0))
    assert got["eval_ms"] == {0: pytest.approx(2000.0)}
    assert got["save_ms"] == {0: pytest.approx(2500.0)}

    rows = [[6.0 if s == 0 else 2.0 + s / 1000, 30.0, 2.5, 20.5, 1.0 if s >= 200 else 5.0, s,
             2e-4] for s in range(0, 300, 20)]
    checks = convergence_runs.trajectory_checks(rows, 20, 300, (20.0, 21.0))
    assert all(c["ok"] for c in checks.values()), checks
    assert checks["kl"]["at_200"] == 1.0 and checks["d_band"]["min"] == pytest.approx(2.12)
    assert checks["mel_last_100"]["mean"] == 20.5
    assert not convergence_runs.trajectory_checks(rows, 20, 300, (10.0, 11.0))["mel_last_100"]["ok"]
    rows[-1][3] = float("nan")
    assert not convergence_runs.trajectory_checks(rows, 20, 300, (20.0, 21.0))["finite"]["ok"]
    assert not convergence_runs.trajectory_checks(rows[:-1], 20, 300, (20.0, 21.0))["finite"]["ok"]
