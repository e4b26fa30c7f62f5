"""The port's synthetic corpus (``smart_vocoder_torch/tools/make_synth_data.py``)
against ``scripts/make_synth_data.py``: at 6 clips and 2 speakers, with and
without ``--ms``, both write the same wavs byte for byte, the same filelists
and the same config, the directory each was given aside."""

import importlib.util
import json
import os
import sys

import pytest

from smart_vocoder_torch.tools import make_synth_data

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    """A script under ``scripts/`` as a module, loaded from its path."""
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  os.path.join(_REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("ms", [False, True])
def test_same_files_as_the_script(tmp_path, monkeypatch, capsys, ms):
    flag = ["--ms"] if ms else []
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["make_synth_data.py", ref, "6", "2", *flag])
    jax_script("make_synth_data").main()
    said_ref = capsys.readouterr().out
    make_synth_data.main([port, "6", "2", *flag])
    assert capsys.readouterr().out == said_ref.replace(ref, port)

    wavs = sorted(os.listdir(os.path.join(ref, "wavs")))
    assert wavs == sorted(os.listdir(os.path.join(port, "wavs"))) == [
        f"clip_{i:04d}.wav" for i in range(6)]
    for name in wavs:
        with open(os.path.join(ref, "wavs", name), "rb") as a, \
                open(os.path.join(port, "wavs", name), "rb") as b:
            assert a.read() == b.read(), name
    for name in ("train_files.txt", "val_files.txt", "config.json"):
        with open(os.path.join(ref, name)) as a, open(os.path.join(port, name)) as b:
            assert a.read().replace(ref, port) == b.read(), name
    with open(os.path.join(port, "val_files.txt")) as f:
        assert [ln.rsplit("|", 1)[1] for ln in f.read().split()] == ["0", "1"]  # max(2, 6 // 16)
    with open(os.path.join(port, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["data"]["n_speakers"] == 2 and cfg["tpu"]["bucket_boundaries"] == [32, 600]
    assert cfg["model"].get("use_spk_embed", False) is ms
    assert (cfg["train"]["log_interval"], cfg["train"]["eval_interval"]) == (20, 200)
