"""The port's training runtime on the CPU: the loop (``training/loop.py``),
its config entry (``config.get_hparams``) and the ``train`` / ``preprocess``
entry points, at a tiny config on a corpus of harmonic tones.

- ``run(hps, max_steps=3, device="cpu")`` writes ``train.log`` whose first
  line names the summary writer, with the loss list lines that
  ``tests/test_multiprocess.py:_loss_trajectory`` parses (steps 0-2, all
  finite), ``eval/mel_l1`` at each eval step, the scalars under the
  reference's names (tensorboardX's event files, and the plain writer's
  ``scalars.jsonl`` with tensorboardX hidden) and the ``G_``/``D_`` pairs at
  ``eval_interval`` and at the end.
- 4 straight steps equal 2 steps + resume + 2 steps bit for bit (parameters,
  ``weight_u``, optimizer state), and the resumed run's steps see the
  straight run's batches (the mid-epoch skip) and draws.
- ``_evaluate``'s ``eval/mel_l1`` and audio equal JAX's on the same
  weights, list and noise.
- ``debug_nans`` turns on autograd's anomaly mode; ``model_parallel > 1``
  and the default device without a card raise.
- ``python -m smart_vocoder_torch.train ... --max-steps 2 --device cpu`` and
  ``python -m smart_vocoder_torch.preprocess`` in subprocesses.
"""

import copy
import json
import math
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from smart_vocoder_torch.config import get_hparams, get_hparams_from_dir
from smart_vocoder_torch.training import loop as loop_lib
from smart_vocoder_torch.utils.checkpoint import CheckpointManager
from smart_vocoder_torch.utils.torch_compat import load_torch_checkpoint
from test_multiprocess import _loss_trajectory
from test_torch_streaming import one_thread  # noqa: F401 (fixture)
from test_torch_train_step import TRAIN_CFG

pytestmark = pytest.mark.usefixtures("one_thread")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, HOP = 22050, 256


def make_corpus(root, n=8, speakers=4):
    """Harmonic tones of 40-68 frames (as tests/test_e2e_training.py:
    make_dataset writes) and a ``path|sid`` filelist."""
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i in range(n):
        t = np.arange((40 + 4 * i) * HOP) / SR
        f0 = 110 + 20 * i
        wav = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in (1, 2, 3)) * 6000
        path = os.path.join(wav_dir, f"u{i}.wav")
        wavfile.write(path, SR, wav.astype(np.int16))
        lines.append(f"{path}|{i % speakers}")
    filelist = os.path.join(root, "train.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(lines) + "\n")
    return filelist


def make_config(root, **tpu):
    cfg = copy.deepcopy(TRAIN_CFG)
    filelist = make_corpus(root)
    cfg["train"].update(log_interval=1, eval_interval=2, epochs=3)
    cfg["data"].update(training_files=filelist, validation_files=filelist)
    cfg["tpu"] = dict(bucket_boundaries=[32, 50, 70], eval_samples=2, keep_ckpts=2, **tpu)
    path = os.path.join(root, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture
def hparams(tmp_path, monkeypatch):
    """``get_hparams`` for a model named ``model`` run from ``tmp_path``."""
    monkeypatch.chdir(tmp_path)

    def make(model, **tpu):
        return get_hparams(["-c", make_config(str(tmp_path), **tpu), "-m", model])
    return make


def event_scalar_tags(log_dir):
    """{tag: [steps]} of the simple values in a directory's tfevents files
    (TFRecord framing: length, its CRC, the Event proto, its CRC)."""
    from tensorboardX.proto import event_pb2

    tags = {}
    for name in os.listdir(log_dir):
        if not name.startswith("events.out.tfevents"):
            continue
        with open(os.path.join(log_dir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            n = struct.unpack("<Q", data[pos:pos + 8])[0]
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 16 + n
            for v in event.summary.value:
                if v.HasField("simple_value"):
                    tags.setdefault(v.tag, []).append(event.step)
    return tags


def jsonl_scalar_tags(log_dir):
    tags = {}
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            assert math.isfinite(rec["value"]), rec
            tags.setdefault(rec["tag"], []).append(rec["step"])
    return tags


NAMES = ["loss/g/total", "loss/d/total", "loss/g/fm", "loss/g/mel", "loss/g/kl",
         "grad_norm_d", "grad_norm_g", "learning_rate", "loss/g/0", "loss/d_r/0", "loss/d_g/0"]


@pytest.mark.parametrize("writer", ["tensorboardX", "plain"])
def test_run_writes_log_scalars_and_checkpoints(hparams, monkeypatch, writer):
    if writer == "plain":
        monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the import fails
    hps = hparams("run")
    loop_lib.run(hps, max_steps=3, device="cpu")
    log_path = os.path.join(hps.model_dir, "train.log")
    with open(log_path) as f:
        lines = f.read().splitlines()
    want = "PlainWriter" if writer == "plain" else "tensorboardX"
    assert "summary writer" in lines[0] and want in lines[0]
    traj = _loss_trajectory(log_path)
    assert sorted(traj) == [0, 1, 2]
    assert all(math.isfinite(v) for losses in traj.values() for v in losses)
    evals = [ln for ln in lines if "eval step" in ln and "mel_l1" in ln]
    assert [int(ln.split("eval step ")[1].split(":")[0]) for ln in evals] == [0, 2]
    assert CheckpointManager(hps.model_dir).steps() == [2, 3]  # keep 2 of 0, 2, 3
    assert load_torch_checkpoint(os.path.join(hps.model_dir, "G_2.pth"))["iteration"] == 3

    read = jsonl_scalar_tags if writer == "plain" else event_scalar_tags
    tags = read(hps.model_dir)
    for name in NAMES:
        assert tags.get(name) == [0, 1, 2], name
    assert tags.get("perf/step_ms") == [2]  # after the timer's warm-up
    assert read(os.path.join(hps.model_dir, "eval")).get("eval/mel_l1") == [0, 2]
    if writer == "plain":
        images = os.listdir(os.path.join(hps.model_dir, "images"))
        assert "slice_mel_org_0.npy" in images and "all_mel_2.npy" in images
        audio = os.listdir(os.path.join(hps.model_dir, "eval", "audio"))
        assert {"gen_audio_0.wav", "gt_audio_0.wav", "gen_audio_2.wav"} <= set(audio)


def recording_step(record):
    """``make_train_step`` whose step keeps each step's batch and noise."""
    make = loop_lib.make_train_step

    def make_recording(hps, device=None):
        step = make(hps, device)

        def run_step(state, batch, generator=None, perm=None):
            gen_state = generator.get_state()
            state_step = state.step
            state, metrics = step(state, batch, generator=generator, perm=perm)
            record[state_step] = (batch.spec.clone(), gen_state, perm.clone())
            return state, metrics
        return run_step
    return make_recording


def final_state(model_dir, step):
    return (load_torch_checkpoint(os.path.join(model_dir, f"G_{step}.pth")),
            load_torch_checkpoint(os.path.join(model_dir, f"D_{step}.pth")))


def assert_payload_equal(a, b):
    if torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_payload_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_payload_equal(x, y)
    else:
        assert a == b


def test_resume_is_bit_exact(hparams, monkeypatch):
    hps = hparams("straight")
    hps.model.use_spectral_norm = True  # weight_u must come back too
    seen_straight, seen_resumed = {}, {}
    monkeypatch.setattr(loop_lib, "make_train_step", recording_step(seen_straight))
    loop_lib.run(hps, max_steps=4, device="cpu")
    straight = final_state(hps.model_dir, 4)

    hps_b = copy.deepcopy(hps)
    hps_b.model_dir = os.path.join(os.path.dirname(hps.model_dir), "resumed")
    loop_lib.run(hps_b, max_steps=2, device="cpu")
    monkeypatch.setattr(loop_lib, "make_train_step", recording_step(seen_resumed))
    loop_lib.run(hps_b, max_steps=4, device="cpu")
    with open(os.path.join(hps_b.model_dir, "train.log")) as f:
        log = f.read()
    # 5 batches an epoch (3 clips in (32, 50] and 5 in (50, 70], 2 rows, each
    # bucket filled to a multiple of 2): step 2 is batch 2 of epoch 1
    assert "resumed from step 2 (epoch 1, batch 2)" in log
    assert sorted(seen_resumed) == [2, 3]
    for s in (2, 3):  # the same batch and the same draws as the straight run's
        for a, b in zip(seen_straight[s], seen_resumed[s]):
            assert torch.equal(a, b), s
    resumed = final_state(hps_b.model_dir, 4)
    assert_payload_equal(straight, resumed)
    assert straight[0]["iteration"] == 4 and straight[0]["epoch"] == 1


class RecordingWriter:
    """The summary writer's calls that ``summarize`` makes, kept by tag."""

    def __init__(self):
        self.scalars, self.images, self.audios = {}, {}, {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = value

    def add_image(self, tag, image, step, dataformats=None):
        self.images[tag] = np.asarray(image)

    def add_audio(self, tag, wav, step, sample_rate=None):
        self.audios[tag] = np.asarray(wav)


def test_evaluate_matches_jax(tmp_path):
    """``eval/mel_l1`` of the port's ``_evaluate`` against JAX's
    (``smart_vocoder_tpu/training/loop.py:_evaluate``) on the same G weights,
    validation list and prior noise: 3 utterances of 40-48 frames, each padded
    to 1000 frames, the batch filled to ``eval_samples`` = 4 rows by
    repeating row 0, each row with its own ``sid``, the mel-L1 over each
    row's valid frames and its mean over the 3 real rows."""
    import logging
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    from smart_vocoder_torch.config import HParams, validate
    from smart_vocoder_torch.data import AudioSpecDataset, BucketedLoader, BucketSampler
    from smart_vocoder_torch.ops import MelConfig
    from smart_vocoder_tpu.config import HParams as JaxHParams
    from smart_vocoder_tpu.config import validate as jax_validate
    from smart_vocoder_tpu.data import AudioSpecDataset as JaxDataset
    from smart_vocoder_tpu.data import BucketedLoader as JaxLoader
    from smart_vocoder_tpu.data import BucketSampler as JaxSampler
    from smart_vocoder_tpu.models.synthesizer import SynthesizerTrn
    from smart_vocoder_tpu.ops import MelConfig as JaxMelConfig
    from smart_vocoder_tpu.training import loop as jax_loop
    from test_torch_train_step import batches, jax_modules, jax_state, port_state

    filelist = make_corpus(str(tmp_path), n=3)
    cfg = copy.deepcopy(TRAIN_CFG)
    cfg["data"].update(training_files=filelist, validation_files=filelist)
    cfg["tpu"] = dict(bucket_boundaries=[32, 50, 70], eval_samples=4)
    jhps, thps = (validate_(cls(**copy.deepcopy(cfg))) for cls, validate_ in
                  ((JaxHParams, jax_validate), (HParams, validate)))
    jhps.model_dir = str(tmp_path / "jax")
    jstate = jax_state(jhps, batches(jhps)[0], jax_init=False)
    eps = np.random.default_rng(5).standard_normal(
        (4, loop_lib.EVAL_FRAMES, cfg["model"]["inter_channels"])).astype(np.float32)
    net_g = jax_modules(jhps)[0]

    def infer_fn(params, mel, lens, rng, sid=None, max_len=None):
        return net_g.apply({"params": params}, mel, lens, rng, sid=sid, noise_scale=1.0,
                           max_len=max_len, eps=jnp.asarray(eps), method=SynthesizerTrn.infer)

    def loader(dataset_cls, sampler_cls, loader_cls, hps, **kw):
        dataset = dataset_cls(filelist, hps.data)
        sampler = sampler_cls(dataset.lengths, 1, [32, 50, 70], shuffle=False)
        return loader_cls(dataset, sampler, with_sid=True, **kw)

    want, got = RecordingWriter(), RecordingWriter()
    jax_loop._evaluate(jhps, net_g, SimpleNamespace(params_g=jstate.params_g),
                       loader(JaxDataset, JaxSampler, JaxLoader, jhps), jax.jit(
                           infer_fn, static_argnames=("max_len",)),
                       JaxMelConfig.from_hparams(jhps), want, 0)
    state = port_state(thps, jstate)
    port_loader = loader(AudioSpecDataset, BucketSampler, BucketedLoader, thps,
                         device=torch.device("cpu"))
    try:
        loop_lib._evaluate(thps, state.net_g, port_loader, MelConfig.from_hparams(thps), got,
                           0, logging.getLogger("eval_test"), torch.device("cpu"),
                           eps=torch.from_numpy(eps))
    finally:
        port_loader.close()
    assert set(got.scalars) == set(want.scalars) == {"eval/mel_l1"}
    assert set(got.audios) == set(want.audios) == {"gen/audio", "gt/audio"}
    np.testing.assert_allclose(got.audios["gt/audio"], want.audios["gt/audio"], rtol=0,
                               atol=1e-7)
    gen, gen_want = got.audios["gen/audio"], want.audios["gen/audio"]
    assert gen.shape == gen_want.shape and gen.shape[0] % HOP == 0
    np.testing.assert_allclose(gen, gen_want, rtol=0, atol=1e-5 * np.abs(gen_want).max())
    mel_l1, mel_l1_want = got.scalars["eval/mel_l1"], want.scalars["eval/mel_l1"]
    assert abs(mel_l1 - mel_l1_want) <= 1e-5 * abs(mel_l1_want), (mel_l1, mel_l1_want)


def test_debug_nans_and_refusals(hparams, monkeypatch):
    hps = hparams("anomaly", debug_nans=True)
    modes = []
    make = loop_lib.make_train_step

    def make_watching(h, device=None):
        step = make(h, device)

        def run_step(*args, **kwargs):
            modes.append(torch.is_anomaly_enabled())
            return step(*args, **kwargs)
        return run_step

    monkeypatch.setattr(loop_lib, "make_train_step", make_watching)
    try:
        loop_lib.run(hps, max_steps=1, device="cpu")
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert modes == [True]

    hps.tpu.model_parallel = 2
    with pytest.raises(ValueError, match="model_parallel"):
        loop_lib.run(hps, max_steps=1, device="cpu")
    hps.tpu.model_parallel = 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop_lib.run(hps, max_steps=1)


def test_profile_window_writes_a_trace(hparams):
    """``tpu.profile_steps`` traces steps [start, start + n) into
    ``<model_dir>/profile`` as a Chrome trace."""
    hps = hparams("profiled", profile_steps=2, profile_start_step=1)
    loop_lib.run(hps, max_steps=4, device="cpu")
    trace = os.path.join(hps.model_dir, "profile", "trace_1_3.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert os.listdir(os.path.join(hps.model_dir, "profile")) == ["trace_1_3.json"]


def test_get_hparams_snapshot(tmp_path, monkeypatch):
    cfg = make_config(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    hps = get_hparams(["-c", cfg, "-m", "snap", "--unrelated", "1"])
    assert hps.model_dir == "./logs/snap"
    assert hps.tpu.eval_samples == 2 and hps.tpu.cache_specs is False
    with open(cfg) as f, open("logs/snap/config.json") as g:
        assert f.read() == g.read()
    os.remove(cfg)  # init=False reads the snapshot, not the -c file
    again = get_hparams(["-m", "snap"], init=False)
    assert again.to_dict() == hps.to_dict()
    assert get_hparams_from_dir("./logs/snap").to_dict() == hps.to_dict()


def test_entry_points(tmp_path):
    cfg = make_config(str(tmp_path))
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run([sys.executable, "-m", "smart_vocoder_torch.train", "-c", cfg,
                           "-m", "cli", "--max-steps", "2", "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    model_dir = tmp_path / "logs" / "cli"
    assert sorted(_loss_trajectory(str(model_dir / "train.log"))) == [0, 1]
    assert CheckpointManager(str(model_dir)).steps() == [0, 2]

    speakers = tmp_path / "speakers.json"
    speakers.write_text(json.dumps({"spk_a": 3, "spk_b": 7}))
    for spk in ("spk_a", "spk_b"):
        d = tmp_path / "corpus" / spk
        d.mkdir(parents=True)
        wavfile.write(str(d / "x.wav"), SR, np.zeros(HOP * 40, np.int16))
    out = tmp_path / "lists" / "files.txt"
    proc = subprocess.run([sys.executable, "-m", "smart_vocoder_torch.preprocess", "--wav_dir",
                           str(tmp_path / "corpus"), "--filelists", str(out), "--speaker_map",
                           str(speakers)], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = sorted(out.read_text().splitlines())
    assert [ln.rsplit("|", 1)[1] for ln in lines] == ["3", "7"]
    assert all(os.path.exists(ln.rsplit("|", 1)[0]) for ln in lines)
