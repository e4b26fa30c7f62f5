"""The data axis of the port's serving path: ``Vocoder(devices=[...])``.

The JAX package shards a batch over the ``'data'`` axis of a mesh
(``smart_vocoder_tpu/inference.py:110-142``) and keys each row's prior noise
by its global index, so the audio does not depend on the mesh. The port
splits the rows into contiguous blocks, one a listed device, and decodes
each block on its device's replica from a worker thread. Here a device named
three times drives that path on the CPU, at tests/test_torch_package.py's
tiny config, bucket 64:

- each shard equals a one-device decode of its block of rows bit for bit
  (same shapes, same weights);
- every row is within rtol / atol 2e-5 of the one-device decode of the whole
  batch (another batch size sums in another order), JAX's own bound for its
  mesh against one device (tests/test_parallel.py:122), with ``eps`` passed
  and with ``seed=`` alone;
- the rows are within atol 5e-4 of JAX's ``Vocoder(mesh=make_mesh(data=8))``
  on conftest's 8 virtual CPU devices (tests/test_torch_slice.py's bound);
- the kernel route (bf16, hifi 2, on the kernels' plain versions) and a
  speaker-conditioned config, whose ``sid`` is split with the rows;
- what must raise: a ``StreamServer`` over several shards, an empty or
  doubly given device list, a card that is not there, a failing shard.

Also: a device's shards keep one worker thread; the kernel library's first
load and its launch counts under many threads (the shards' workers launch
kernels at once).
"""

import copy
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.inference import Vocoder
from smart_vocoder_torch.kernels import _build
from smart_vocoder_torch.parallel import data_devices, split_rows
from smart_vocoder_torch.serving import StreamServer
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.inference import Vocoder as JaxVocoder
from smart_vocoder_tpu.parallel import make_mesh
from test_torch_package import TINY_CFG, jax_synth_params, tiny_hparams
from test_torch_streaming import one_thread  # noqa: F401 (fixture)

T = 50            # frames; the bucket is 64
SHARDS = 3
TOL = 2e-5        # tests/test_parallel.py:122
JAX_TOL = 5e-4    # tests/test_torch_slice.py:60


def ms_cfg():
    cfg = copy.deepcopy(TINY_CFG)
    cfg["data"]["n_speakers"] = 4
    cfg["model"].update(gin_channels=16, use_spk_embed=True)
    return cfg


@pytest.fixture(scope="module")
def weights():
    jhps, thps = tiny_hparams()
    params = jax_synth_params(jhps, seed=3)
    return jhps, thps, params, state_dict_from_jax_params(params)


def vocoders(thps, sd, **kw):
    """A one-device ``Vocoder`` and one over ``SHARDS`` CPU shards."""
    return (Vocoder(thps, sd, buckets=(64,), device="cpu", **kw),
            Vocoder(thps, sd, buckets=(64,), devices=["cpu"] * SHARDS, **kw))


@pytest.fixture(scope="module")
def f32(weights):
    _, thps, _, sd = weights
    one, many = vocoders(thps, sd, dtype=torch.float32, use_kernels=False)
    yield one, many
    many.close()


def inputs(b, inter, seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.normal(-4, 2, (b, T, 80)).astype(np.float32)
    lengths = rng.integers(20, T + 1, b)
    lengths[0] = T
    eps = rng.normal(0, 1, (b, T, inter)).astype(np.float32)
    return mel, lengths, eps


def check_blocks(one, many, mel, lengths, sid=None, **noise):
    """``many``'s rows; each of its shards bit-equal to ``one``'s decode of
    the shard's rows (``eps`` split with them, or drawn for the whole batch
    by ``batch_eps``)."""
    b = len(mel)
    got = many.mel_to_wav(mel, lengths, sid=sid, **noise)
    assert len(got) == b
    eps = noise.get("eps")
    if eps is None:
        eps = one.batch_eps(noise["seed"], b, 64).numpy()
    for r in split_rows(b, len(many.devices)):
        if r.stop == r.start:
            continue
        want = one.mel_to_wav(mel[r], lengths[r], eps=eps[r],
                              sid=None if sid is None else sid[r])
        for g, w in zip(got[r], want):
            np.testing.assert_array_equal(g, w)
    return got


def test_split_rows_blocks():
    for b in range(0, 12):
        for shards in range(1, 6):
            blocks = split_rows(b, shards)
            sizes = [r.stop - r.start for r in blocks]
            assert len(blocks) == shards and sum(sizes) == b
            assert max(sizes) - min(sizes) <= 1
            assert [r.start for r in blocks] == [0] + [r.stop for r in blocks[:-1]]
    assert split_rows(5, 3) == [slice(0, 2), slice(2, 4), slice(4, 5)]
    with pytest.raises(ValueError):
        split_rows(4, 0)


def test_data_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert data_devices(device="cpu") == [cpu]
    assert data_devices(3, device="cpu") == [cpu] * 3
    with pytest.raises(ValueError):
        data_devices(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert data_devices() == [torch.device("cuda", i) for i in range(4)]
    assert data_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="needs 5 CUDA cards, 4 visible"):
        data_devices(5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="0 visible"):
        data_devices()


@pytest.mark.parametrize("b", [2, 5, 8])
def test_f32_shards_match_one_device(f32, weights, b):
    """Explicit noise and seeded noise: shards bit-equal to their blocks, rows
    within 2e-5 of the whole batch on one device; B = 2 leaves a shard empty."""
    one, many = f32
    inter = weights[1].model.inter_channels
    mel, lengths, eps = inputs(b, inter, seed=b)
    for noise in ({"eps": eps}, {"seed": 11}):
        got = check_blocks(one, many, mel, lengths, **noise)
        for g, w, n in zip(got, one.mel_to_wav(mel, lengths, **noise), lengths):
            assert g.shape == (n * 16,)
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_f32_shards_match_the_jax_mesh(f32, weights):
    """The same weights and noise through JAX's data mesh of 8 (B = 5 is
    padded to 8 there, split 2 + 2 + 1 here): one JAX compile."""
    jhps, _, params, _ = weights
    _, many = f32
    mel, lengths, eps = inputs(5, jhps.model.inter_channels, seed=1)
    with jax.default_matmul_precision("highest"):
        jvoc = JaxVocoder(jhps, jax.tree.map(jnp.asarray, params), dtype=jnp.float32,
                          buckets=(64,), use_pallas=False, mesh=make_mesh(data=8))
        want = jvoc.mel_to_wav(mel, lengths, eps=eps)
    for g, w in zip(many.mel_to_wav(mel, lengths, eps=eps), want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=JAX_TOL)


def test_windows_decode_on_the_first_device(f32):
    """``mel_to_wav_chunked`` of a multi-shard ``Vocoder`` is its first
    device's, as the JAX mesh route pads a B = 1 window over the mesh."""
    one, many = f32
    mel = inputs(1, 16, seed=4)[0][0]
    np.testing.assert_array_equal(many.mel_to_wav_chunked(mel, chunk=32, overlap=8, seed=2),
                                  one.mel_to_wav_chunked(mel, chunk=32, overlap=8, seed=2))


def test_each_device_keeps_its_thread(f32, monkeypatch):
    """A device's shards run on one worker thread, the same at every call
    (cuDNN keeps its plans, and its timed choices, per thread)."""
    _, many = f32
    threads = []
    infer = many._infer

    def recording(*args):
        threads.append(threading.get_ident())
        return infer(*args)

    monkeypatch.setattr(many, "_infer", recording)
    mel, lengths, eps = inputs(5, 16)
    for _ in range(3):
        many.mel_to_wav(mel, lengths, eps=eps)
    assert len(threads) == 9 and len(set(threads)) == 1
    assert threads[0] != threading.get_ident()


def test_kernel_route_bf16_hifi2_shards(weights):
    """The serving route (decoder through the kernels' wrappers, their plain
    versions on the CPU) at bf16, hifi 2: shards bit-equal to their blocks."""
    _, thps, _, sd = weights
    one, many = vocoders(thps, sd, dtype=torch.bfloat16, hifi=2)
    try:
        assert many.use_kernels and many.hifi == 2
        mel, lengths, eps = inputs(5, thps.model.inter_channels, seed=7)
        check_blocks(one, many, mel, lengths, eps=eps)
    finally:
        many.close()


def test_conditioned_rows_split_their_sid():
    jhps, thps = tiny_hparams(ms_cfg())
    sd = state_dict_from_jax_params(jax_synth_params(jhps, seed=4))
    one, many = vocoders(thps, sd, dtype=torch.float32, use_kernels=False)
    try:
        mel, lengths, _ = inputs(5, thps.model.inter_channels, seed=5)
        sid = np.array([3, 0, 2, 1, 3])
        got = check_blocks(one, many, mel, lengths, sid=sid, seed=9)
        for g, w in zip(got, one.mel_to_wav(mel, lengths, sid=sid, seed=9)):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        other = many.mel_to_wav(mel, lengths, sid=(sid + 1) % 4, seed=9)
        for g, o in zip(got, other):  # each shard decodes its rows' own speakers
            assert not np.allclose(g, o, rtol=0, atol=1e-4)
    finally:
        many.close()


def test_what_raises(f32, weights, monkeypatch):
    _, thps, _, sd = weights
    one, many = f32
    with pytest.raises(ValueError, match="one server per card"):
        StreamServer(many, max_streams=2, chunk=32, overlap=8)
    StreamServer(one, max_streams=2, chunk=32, overlap=8)
    with pytest.raises(ValueError, match="empty"):
        Vocoder(thps, sd, devices=[])
    with pytest.raises(ValueError, match="not both"):
        Vocoder(thps, sd, device="cpu", devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Vocoder(thps, sd, devices=["cuda:0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):  # before the file is read
            Vocoder.from_torch_checkpoint("missing.json", "missing.pth", devices=["cuda:0"])

    calls = []
    infer = many._infer

    def failing(mel, *args):
        calls.append(mel.shape[0])
        if len(calls) == 2:
            raise FloatingPointError("shard 2 failed")
        return infer(mel, *args)

    monkeypatch.setattr(many, "_infer", failing)
    mel, lengths, eps = inputs(5, thps.model.inter_channels)
    with pytest.raises(FloatingPointError, match="shard 2 failed"):
        many.mel_to_wav(mel, lengths, eps=eps)
    assert sorted(calls) == [1, 2, 2]  # every shard ran to its end


def test_library_load_and_launch_counts_under_threads(monkeypatch):
    """Sixteen threads at the first load build once and share one library;
    sixteen threads counting launches with a switch interval of 1 us lose
    none of them."""
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return "libsvt_kernels_test.so"

    def fake_cdll(path):
        return types.SimpleNamespace(**{n: types.SimpleNamespace() for n in _build._SIGNATURES})

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    _build._load.cache_clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            libs = list(pool.map(lambda _: _build.load_library(), range(16)))
        _build.reset_launch_counts()

        def count(_):
            for _ in range(2000):
                _build.count_launches("mrf_stage")

        with ThreadPoolExecutor(16) as pool:
            list(pool.map(count, range(16)))
        counted = _build.LAUNCHES["mrf_stage"]
    finally:
        sys.setswitchinterval(interval)
        _build._load.cache_clear()
        _build.reset_launch_counts()
    assert len(builds) == 1 and all(lib is libs[0] for lib in libs)
    assert counted == 16 * 2000
