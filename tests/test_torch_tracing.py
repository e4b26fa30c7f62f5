"""The port's spans (``smart_vocoder_torch/utils/profiling.py``): recorded at
the layer boundaries only while a torch profiler runs, nothing recorded and
no clock read otherwise, and the same outputs either way.

Tiny sizes on the CPU: a 16-channel generator at hop 16, D at 1/8 width,
B = 2 (the train step at 32 frames, segment 256 samples).
"""

import copy
import os
import threading
import types

import numpy as np
import pytest
import torch
from scipy.io import wavfile
from torch.profiler import ProfilerActivity, profile

from smart_vocoder_torch.config import HParams, validate
from smart_vocoder_torch.data import AudioSpecDataset, BucketedLoader, BucketSampler
from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.models import build_synthesizer
from smart_vocoder_torch.serving import StreamServer
from smart_vocoder_torch.training import Batch, init_train_state, make_train_step
from smart_vocoder_torch.utils import profiling
from smart_vocoder_torch.utils.init import init_synthesizer

HOP, FRAMES, ROWS = 16, 32, 2
CFG = {
    "train": dict(log_interval=10, eval_interval=100, seed=1234, epochs=1, learning_rate=2e-4,
                  betas=[0.8, 0.99], eps=1e-9, batch_size=ROWS, fp16_run=False,
                  lr_decay=0.999875, segment_size=256, c_mel=45, c_kl=1.0),
    "data": dict(training_files="", validation_files="", max_wav_value=32768.0,
                 sampling_rate=22050, filter_length=256, hop_length=HOP, win_length=256,
                 n_mel_channels=80, mel_fmin=0.0, mel_fmax=None, n_speakers=0),
    "model": dict(inter_channels=16, hidden_channels=16, resblock="1",
                  resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
                  upsample_rates=[4, 2, 2], upsample_initial_channel=32,
                  upsample_kernel_sizes=[8, 4, 4], gin_channels=0, use_spectral_norm=False,
                  enc_layers=2, flow_wn_layers=2, disc_width_mult=0.125),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as the suite's other CPU model tests: several
    workers share a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hparams():
    return validate(HParams(**copy.deepcopy(CFG)))


@pytest.fixture(scope="module")
def voc():
    hps = hparams()
    state = init_synthesizer(build_synthesizer(hps), 0).state_dict()
    return Vocoder(hps, state, dtype=torch.float32, buckets=(64,), device="cpu")


def traced(fn):
    """``fn()`` under a CPU profile: its result and the spans it recorded."""
    before = {id(s) for s in profiling.recorded()}
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [s for s in profiling.recorded() if id(s) not in before]


def untraced(fn):
    """``fn()`` with no profiler, which records no span."""
    before = [id(s) for s in profiling.recorded()]
    out = fn()
    assert [id(s) for s in profiling.recorded()] == before
    return out


def mels(n=ROWS, t=50, seed=3):
    mel = np.random.default_rng(seed).normal(-4, 2, (n, t, 80)).astype(np.float32)
    return mel, np.array([t, t - 7][:n], np.int64)


# -- the gate ---------------------------------------------------------------------
def test_no_profiler_no_span_and_no_clock(monkeypatch, voc):
    """Without a profiler ``span`` is the one shared null object, reads no
    clock and keeps nothing, through a whole ``mel_to_wav``."""
    assert profiling.span("a") is profiling.span("b", x=1) is profiling.NULL_SPAN

    def no_clock():
        raise AssertionError("a span read the clock")

    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter=no_clock))
    before = len(profiling.recorded())
    with profiling.span("x") as s:
        assert s is None
    voc.mel_to_wav(*mels(), seed=5)
    assert len(profiling.recorded()) == before


def test_span_parent_thread_and_buffer():
    """A span's parent is the span open on its own thread; the buffer is
    bounded."""
    _, spans = traced(lambda: [_nested() for _ in range(2)])
    outer = [s for s in spans if s.name == "outer"]
    inner = [s for s in spans if s.name == "inner"]
    other = [s for s in spans if s.name == "other thread"]
    assert len(outer) == len(inner) == len(other) == 2
    for o, i, t in zip(outer, inner, other):
        assert o.parent is None and i.parent == o.id and i.thread == o.thread
        assert t.parent is None and t.thread != o.thread
        assert o.attrs == {"k": 1} and o.start <= i.start <= i.end <= o.end
    assert profiling._spans.maxlen == profiling.SPAN_BUFFER


def _other_thread():
    with profiling.span("other thread"):
        pass


def _nested():
    with profiling.span("outer", k=1):
        with profiling.span("inner"):
            t = threading.Thread(target=_other_thread)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()


# -- the layers -------------------------------------------------------------------
def test_mel_to_wav_spans_and_outputs(voc):
    mel, lengths = mels()
    plain = untraced(lambda: voc.mel_to_wav(mel, lengths, seed=5))
    got, spans = traced(lambda: voc.mel_to_wav(mel, lengths, seed=5))
    for a, b in zip(plain, got, strict=True):
        np.testing.assert_array_equal(a, b)
    (call,) = [s for s in spans if s.name == "synth.call"]
    assert call.attrs["rows"] == ROWS and call.attrs["bucket"] == 64
    assert isinstance(call.attrs["call"], int)
    parts = sorted((s for s in spans if s.parent == call.id), key=lambda s: s.start)
    assert [s.name for s in parts] == ["synth.pad", "synth.eps", "synth.h2d", "synth.trim"]
    assert all(call.start <= s.start <= s.end <= call.end for s in parts)
    assert all(a.end <= b.start for a, b in zip(parts, parts[1:]))
    # a given eps is padded inside synth.pad, and nothing is drawn
    eps = np.zeros((ROWS, 50, 16), np.float32)
    _, spans = traced(lambda: voc.mel_to_wav(mel, lengths, eps=eps))
    assert sorted(s.name for s in spans) == ["synth.call", "synth.h2d", "synth.pad",
                                             "synth.trim"]


def _serve(voc, streams):
    server = StreamServer(voc, max_streams=2, chunk=64, overlap=16)
    handles = []
    for seed, mel in streams:
        h = server.open(seed=seed)
        server.feed(h, mel)
        server.close(h)
        handles.append(h)
    steps = []
    while server.pending():
        steps.append(server.step())
    return handles, steps


def test_server_step_spans_and_outputs(voc):
    rng = np.random.default_rng(4)
    streams = [(s, rng.normal(-4, 2, (t, 80)).astype(np.float32))
               for s, t in ((1, 70), (2, 40), (3, 25))]
    _, plain = untraced(lambda: _serve(voc, streams))
    (handles, got), spans = traced(lambda: _serve(voc, streams))
    assert len(plain) == len(got) > 1
    for a, b in zip(plain, got):
        assert list(a) == list(b)
        for h in a:
            np.testing.assert_array_equal(a[h], b[h])
    steps = [s for s in spans if s.name == "serve.step"]
    assert len(steps) == len(got)
    for sp, out in zip(steps, got):
        assert sp.attrs["windows"] == len(out) and sp.attrs["max_streams"] == 2
        assert sorted(sp.attrs["handles"]) == sorted(out)
        assert set(sp.attrs["handles"]) <= set(handles)


def _train(steps=2):
    hps = hparams()
    torch.manual_seed(0)
    state = init_train_state(hps, seed=7, device="cpu")
    step = make_train_step(hps, "cpu")
    rng = np.random.default_rng(9)
    lens = torch.tensor([FRAMES, FRAMES - 5])
    batch = Batch(spec=torch.from_numpy(rng.uniform(0, 2, (ROWS, FRAMES, 129)).astype(np.float32)),
                  spec_lengths=lens,
                  wav=torch.from_numpy(rng.normal(0, 0.1, (ROWS, FRAMES * HOP, 1))
                                       .astype(np.float32)),
                  wav_lengths=lens * HOP)
    losses = []
    for n in range(steps):
        state, metrics = step(state, batch, generator=torch.Generator().manual_seed(n))
        losses.append({k: v.clone() for k, v in metrics.items()})
    params = [p.detach().clone() for net in (state.net_g, state.net_d) for p in net.parameters()]
    return losses, params


def test_train_step_phases_tile_the_step_and_outputs():
    plain_losses, plain_params = untraced(_train)
    (losses, params), spans = traced(_train)
    for a, b in zip(plain_losses, losses, strict=True):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(plain_params, params, strict=True):
        assert torch.equal(a, b)
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.attrs for s in steps] == [{"step": n, "rows": ROWS, "frames": FRAMES}
                                        for n in range(2)]
    for st in steps:
        phases = sorted((s for s in spans if s.parent == st.id), key=lambda s: s.start)
        assert [s.name for s in phases] == ["train.forward", "train.d_phase", "train.g_phase"]
        bounds = [st.start] + [t for s in phases for t in (s.start, s.end)] + [st.end]
        assert bounds == sorted(bounds)
        # the phases tile the step: what falls between them is a few lines of Python
        covered = sum(s.end - s.start for s in phases)
        assert covered >= 0.9 * (st.end - st.start)
        optim = [s for s in spans if s.name == "train.optim"
                 and s.parent in {p.id for p in phases}]
        by_phase = {p.id: p.name for p in phases}
        assert sorted((by_phase[s.parent], s.attrs["net"]) for s in optim) == [
            ("train.d_phase", "d"), ("train.g_phase", "g")]


def _corpus(root, frames=(20, 24, 30, 36, 44, 50)):
    rng = np.random.default_rng(0)
    lines = []
    for i, f in enumerate(frames):
        path = os.path.join(root, f"u{i}.wav")
        n = f * HOP
        wav = np.sin(2 * np.pi * 200 * np.arange(n) / 22050) * 0.3 + rng.normal(0, 0.01, n)
        wavfile.write(path, 22050, (wav * 32767).astype(np.int16))
        lines.append(path)
    files = os.path.join(root, "files.txt")
    with open(files, "w") as f:
        f.write("\n".join(lines) + "\n")
    return files


def test_loader_wait_one_a_batch(tmp_path):
    hps = hparams()
    ds = AudioSpecDataset(_corpus(str(tmp_path)), hps.data)
    sampler = BucketSampler(ds.lengths, 2, [16, 32, 64])
    loader = BucketedLoader(ds, sampler, num_workers=2, prefetch=2)
    try:
        plain = untraced(lambda: list(loader))
        got, spans = traced(lambda: list(loader))
        assert len(got) == len(plain) == len(loader) >= 2
        for a, b in zip(plain, got):
            assert torch.equal(a.spec, b.spec) and torch.equal(a.wav, b.wav)
        waits = [s for s in spans if s.name == "loader.wait"]
        assert len(waits) == len(got)
        assert all(isinstance(s.attrs["empty"], bool) for s in waits)
        assert waits[0].attrs["empty"]  # the producer starts at the first next()
    finally:
        loader.close()
