"""The port's position-keyed noise, noise-scale rounding, window API
(chunked and streaming synthesis, ``warmup``) and copy-synthesis CLI.

- Noise (``ops.noise.positional_eps``): Philox-4x32-10 against the published
  known-answer vectors and an independent numpy implementation (the integers
  equal, the normals within 1e-6: the float64 transform rounds once to
  float32); position purity (any start or window gives the same frame's
  values bit for bit); mean and std of 10^5 draws within 0.01 of 0 and 1.
- Noise scale (``ops.noise.prior_sample``): bit for bit against ``jnp``'s
  bf16 expression, and a float scale equals a per-row tensor of it bit for
  bit; the bf16 module-graph prior rounds the scale to bf16.
- Twins of tests/test_inference_api.py:102-268 on the port's ``Vocoder``
  (that file's ``tiny_vocoder`` config; the port's seeded init): tolerances
  as there (2e-4 where the window cuts differ, 1e-5 for a window against the
  same noise through ``mel_to_wav``, exact for stream against chunked).
- Chunked and streaming synthesis of the port against the JAX package's at
  ``noise_scale=0.0`` (so that the two noise streams do not enter), f32,
  atol 5e-4 as tests/test_torch_slice.py: on the module graph (the
  ``tiny_vocoder`` config) and on the kernel route (test_torch_package's
  ResBlock1 config, JAX's Pallas kernels in interpret mode).
"""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from smart_vocoder_torch.inference import Vocoder as TorchVocoder
from smart_vocoder_torch.models import build_synthesizer
from smart_vocoder_torch.ops.noise import philox4x32, positional_eps, prior_sample
from smart_vocoder_torch.utils.init import init_synthesizer
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.inference import Vocoder as JaxVocoder
from test_torch_package import TINY_CFG, jax_synth_params, tiny_hparams

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 256

# tests/test_inference_api.py:tiny_vocoder's config (ResBlock2, 32 channels)
VOC_CFG = {
    "train": {"log_interval": 1, "eval_interval": 10, "seed": 0, "epochs": 1,
              "learning_rate": 2e-4, "betas": [0.8, 0.99], "eps": 1e-9,
              "batch_size": 1, "fp16_run": False, "lr_decay": 0.999875,
              "segment_size": 2048, "c_mel": 45, "c_kl": 1.0},
    "data": {"training_files": "", "validation_files": "", "max_wav_value": 32768.0,
             "sampling_rate": 22050, "filter_length": 1024, "hop_length": 256,
             "win_length": 1024, "n_mel_channels": 80, "mel_fmin": 0.0,
             "mel_fmax": None, "n_speakers": 0},
    "model": {"inter_channels": 32, "hidden_channels": 32, "resblock": "2",
              "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
              "upsample_rates": [8, 8, 2, 2], "upsample_initial_channel": 32,
              "upsample_kernel_sizes": [16, 16, 4, 4], "use_spectral_norm": False,
              "gin_channels": 0, "enc_layers": 2, "flow_wn_layers": 1},
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module. The suite runs several workers on
    a few cores, and each worker's OpenMP pool spins against the others: the
    many small ops of a window decode ran 10-80x slower there. Every
    comparison here runs both of its sides under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def voc_cfg(ms=False):
    cfg = copy.deepcopy(VOC_CFG)
    if ms:  # as tiny_vocoder(ms=True)
        cfg["data"]["n_speakers"] = 4
        cfg["model"].update(gin_channels=16, use_spk_embed=True)
    return cfg


def port_vocoder(ms=False, seed=0, **kw):
    """The port's ``Vocoder`` on the tiny_vocoder config, seeded weights, CPU."""
    _, thps = tiny_hparams(voc_cfg(ms))
    state = init_synthesizer(build_synthesizer(thps), seed).state_dict()
    kw.setdefault("dtype", torch.float32)
    return TorchVocoder(thps, state, device="cpu", **kw)


# -- the noise ----------------------------------------------------------------
M32 = np.uint64(0xFFFFFFFF)


def np_philox(ctr, key):
    """Philox-4x32-10 in numpy uint64 (a 32 x 32-bit product fits exactly)."""
    c = [np.asarray(v, np.uint64) for v in ctr]
    k0, k1 = (np.asarray(v, np.uint64) for v in key)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & M32
            k1 = (k1 + np.uint64(0xBB67AE85)) & M32
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & M32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & M32]
    return c


def np_positional_eps(seed, start, n, channels):
    """The same generator, written again in numpy: counter (frame lo, frame
    hi, channel // 4, 0), key (seed lo, seed hi), Box-Muller on word pairs."""
    frame = np.uint64(start) + np.arange(n, dtype=np.uint64)[:, None]
    block = np.arange((channels + 3) // 4, dtype=np.uint64)[None, :]
    seed = np.uint64(seed)
    w = np_philox([frame & M32, frame >> np.uint64(32), block, np.uint64(0)],
                  [seed & M32, seed >> np.uint64(32)])
    out = []
    for u, v in ((w[0], w[1]), (w[2], w[3])):
        r = np.sqrt(-2.0 * np.log((u.astype(np.float64) + 0.5) * 2.0 ** -32))
        theta = 2.0 * np.pi * 2.0 ** -32 * (v.astype(np.float64) + 0.5)
        out += [r * np.cos(theta), r * np.sin(theta)]
    z = np.stack([out[0], out[1], out[2], out[3]], axis=-1).reshape(n, -1)
    return w, z[:, :channels].astype(np.float32)


# Random123's kat_vectors for philox4x32_10: (counter, key, output)
PHILOX_KAT = [
    ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    got = philox4x32([torch.tensor(v, dtype=torch.int64) for v in ctr],
                     [torch.tensor(v, dtype=torch.int64) for v in key])
    assert [int(v) for v in got] == want
    assert [int(v) for v in np_philox(ctr, key)] == want


@pytest.mark.parametrize("seed,start", [(0, 0), (5, 1000), (2**40 + 3, 2**33 - 7)])
def test_positional_eps_matches_numpy(seed, start):
    """Known answers: the integers equal bit for bit, the normals within 1e-6."""
    n, c = 37, 22  # c not a multiple of 4: the last block is cut
    words, want = np_positional_eps(seed, start, n, c)
    frame = torch.arange(n, dtype=torch.int64)[:, None] + start
    block = torch.arange(6, dtype=torch.int64)[None, :]
    got_words = philox4x32([frame & 0xFFFFFFFF, frame >> 32, block, torch.tensor(0)],
                           [torch.tensor(seed & 0xFFFFFFFF), torch.tensor(seed >> 32)])
    for g, w in zip(got_words, words):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    got = positional_eps([seed], [start], n, c)
    assert got.shape == (1, n, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-6)


def test_positional_eps_is_position_pure():
    """Frame t of a seed is the same from any start, window length and row."""
    whole = positional_eps([7], [0], 300, 192)[0]
    for start, n in ((0, 64), (37, 128), (299, 1), (150, 150)):
        np.testing.assert_array_equal(positional_eps([7], [start], n, 192)[0],
                                      whole[start:start + n])
    rows = positional_eps([3, 7, 7], [0, 40, 5], 50, 192)
    np.testing.assert_array_equal(rows[1], whole[40:90])
    np.testing.assert_array_equal(rows[2], whole[5:55])
    assert not torch.equal(rows[0], whole[:50])  # another seed, another stream
    assert not torch.equal(whole[:, :4], whole[:, 4:8])  # channel blocks differ


def test_positional_eps_moments():
    """10^5 draws (520 frames x 192 channels): mean within 0.01 of 0, std of 1."""
    e = positional_eps([11], [12345], 521, 192).double()
    assert e.numel() >= 100_000
    assert abs(e.mean().item()) < 0.01 and abs(e.std().item() - 1.0) < 0.01


# -- the noise-scale rounding ---------------------------------------------------
def _bf16_triplet(rng, shape):
    m = rng.normal(0, 2, shape).astype(np.float32)
    logs = rng.normal(0, 1, shape).astype(np.float32)
    eps = rng.normal(0, 1, shape).astype(np.float32)
    to_t = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    return to_t(m), to_t(logs), eps


@pytest.mark.parametrize("scale", [0.667, 1.0, 0.3])
def test_prior_sample_matches_jnp_bf16(scale):
    """``m_p + eps * exp(logs_p) * s`` on bf16 inputs: the same bits as jnp,
    which rounds the weak-typed scalar to bf16 first."""
    m, logs, eps = _bf16_triplet(np.random.default_rng(0), (3, 40, 16))
    got = prior_sample(m, logs, torch.from_numpy(eps), scale)
    jm = jnp.asarray(m.float().numpy(), jnp.bfloat16)
    jl = jnp.asarray(logs.float().numpy(), jnp.bfloat16)
    want = jm + jnp.asarray(eps).astype(jnp.bfloat16) * jnp.exp(jl) * scale
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # torch's own product with the unrounded Python float differs
    unrounded = m + torch.from_numpy(eps).bfloat16() * torch.exp(logs) * scale
    assert scale == 1.0 or not torch.equal(unrounded, got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prior_sample_float_equals_row_tensor(dtype):
    """A float and a (B,) tensor of the same values: the same bits, in the
    (B, C, T) and (B, T, C) layouts alike."""
    rng = np.random.default_rng(1)
    m, logs, eps = _bf16_triplet(rng, (4, 16, 30))
    m, logs, eps = m.to(dtype), logs.to(dtype), torch.from_numpy(eps)
    for layout in (lambda a: a, lambda a: a.transpose(1, 2)):
        rows = prior_sample(layout(m), layout(logs), layout(eps), torch.full((4,), 0.667))
        one = prior_sample(layout(m), layout(logs), layout(eps), 0.667)
        assert torch.equal(rows, one)
    mixed = prior_sample(m, logs, eps, torch.tensor([0.667, 1.0, 0.667, 1.0]))
    assert torch.equal(mixed[1], prior_sample(m[1:2], logs[1:2], eps[1:2], 1.0)[0])


def test_bf16_module_prior_rounds_the_noise_scale():
    """The bf16 module-graph prior multiplies by bf16(0.667) = 0.66796875, as
    JAX does: 0.667 and 0.66796875 give the same latent bit for bit."""
    voc = port_vocoder(dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    mel = torch.from_numpy(rng.normal(-4, 2, (2, 48, 80)).astype(np.float32)).bfloat16()
    eps = torch.from_numpy(rng.normal(0, 3, (2, 48, 32)).astype(np.float32))
    lens = torch.tensor([48, 30])
    with torch.inference_mode():
        a = voc.net.prior_latent(mel, lens, eps, 0.667)[0]
        b = voc.net.prior_latent(mel, lens, eps, 0.66796875)[0]
        c = voc.net.prior_latent(mel, lens, eps, torch.tensor([0.667, 0.667]))[0]
    assert torch.equal(a, b) and torch.equal(a, c)


# -- twins of tests/test_inference_api.py -----------------------------------------
def _mel(seed, t):
    return np.random.default_rng(seed).normal(-4, 2, size=(t, 80)).astype(np.float32)


def test_chunked_matches_full():
    voc = port_vocoder(buckets=(64, 128, 256, 512))
    mel = _mel(1, 400)
    full = voc.mel_to_wav(mel[None], np.array([400]), noise_scale=0.0)[0]
    chunked = voc.mel_to_wav_chunked(mel, chunk=128, overlap=32, noise_scale=0.0)
    assert chunked.shape == full.shape
    np.testing.assert_allclose(chunked[2 * HOP: -2 * HOP], full[2 * HOP: -2 * HOP], atol=2e-4)


def test_chunked_short_input_passthrough():
    voc = port_vocoder(buckets=(64,))
    out = voc.mel_to_wav_chunked(np.zeros((40, 80), np.float32) - 4, chunk=128, overlap=16,
                                 noise_scale=0.0)
    assert out.shape == (40 * HOP,)


def test_chunk_size_invariance_with_noise():
    """Position-keyed noise: two chunkings of one utterance agree."""
    voc = port_vocoder(buckets=(64, 128, 256, 512))
    mel = _mel(2, 384)
    a = voc.mel_to_wav_chunked(mel, chunk=128, overlap=32, noise_scale=0.7, seed=5)
    b = voc.mel_to_wav_chunked(mel, chunk=256, overlap=48, noise_scale=0.7, seed=5)
    assert a.shape == b.shape
    np.testing.assert_allclose(a[2 * HOP: -2 * HOP], b[2 * HOP: -2 * HOP], atol=2e-4)
    c = voc.mel_to_wav_chunked(mel, chunk=128, overlap=32, noise_scale=0.7, seed=6)
    assert np.abs(a - c).max() > 1e-3  # the seed moves the audio


def test_stream_equals_chunked():
    voc = port_vocoder(buckets=(64, 128, 256))
    mel = _mel(4, 300)
    want = voc.mel_to_wav_chunked(mel, chunk=128, overlap=32, noise_scale=0.7, seed=9)
    cuts = [0, 37, 38, 138, 200, 300]  # ragged pieces: 37, 1, 100, 62, 100 frames
    got = list(voc.stream_mel_to_wav(iter([mel[a:b] for a, b in zip(cuts, cuts[1:])]),
                                     chunk=128, overlap=32, noise_scale=0.7, seed=9))
    assert len(got) > 1
    np.testing.assert_allclose(np.concatenate(got), want, rtol=0, atol=0)


def test_stream_first_chunk_latency():
    """A window is emitted once chunk - overlap frames are buffered."""
    voc = port_vocoder(buckets=(128,))
    chunk, overlap = 128, 32
    fed = []

    def feed():
        for i in range(300):
            fed.append(i + 1)
            yield np.zeros((1, 80), np.float32) - 4

    first = next(voc.stream_mel_to_wav(feed(), chunk=chunk, overlap=overlap, noise_scale=0.0))
    assert fed[-1] == chunk - overlap
    assert first.shape == ((chunk - 2 * overlap) * HOP,)


def test_window_matches_mel_to_wav_with_the_same_noise():
    """``_synth_window`` (noise on every padded frame) against ``mel_to_wav``
    given the same positional noise, zero-padded: the padded frames are
    masked out of every valid sample."""
    voc = port_vocoder(buckets=(128,))
    n, chunk, lo, seed = 90, 128, 55, 3
    mel = _mel(7, n)
    got = voc._synth_window(mel, lo, chunk, 0.7, None, seed)
    eps = positional_eps([seed], [lo], chunk, 32)[0, :n].numpy()
    want = voc.mel_to_wav(np.pad(mel, ((0, chunk - n), (0, 0)))[None], np.array([n]),
                          noise_scale=0.7, eps=np.pad(eps, ((0, chunk - n), (0, 0)))[None])[0]
    assert got.shape == (n * HOP,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_stream_short_input_single_window():
    voc = port_vocoder(buckets=(64, 128))
    mel = np.zeros((40, 80), np.float32) - 4
    got = np.concatenate(list(voc.stream_mel_to_wav([mel], chunk=128, overlap=16)))
    np.testing.assert_array_equal(got, voc.mel_to_wav_chunked(mel, chunk=128, overlap=16))
    assert got.shape == (40 * HOP,)


def test_window_rejects_overlap_past_half_a_chunk():
    voc = port_vocoder(buckets=(64,))
    with pytest.raises(ValueError, match="overlap"):
        voc.mel_to_wav_chunked(_mel(0, 100), chunk=64, overlap=32)


def test_warmup_runs_each_chunk_shape_once(monkeypatch):
    """``warmup`` decodes one window of each chunk size (default: every
    bucket), with the speaker id when given, and leaves later windows alone."""
    voc = port_vocoder(ms=True, buckets=(32, 64))
    mel = _mel(3, 50)
    before = voc._synth_window(mel, 10, 64, 0.667, np.array([2]), 4)
    shapes = []
    infer = voc._infer

    def spy(mel_t, lengths, eps, noise_scale, sid=None):
        shapes.append((tuple(mel_t.shape), None if sid is None else sid.tolist()))
        return infer(mel_t, lengths, eps, noise_scale, sid)

    monkeypatch.setattr(voc, "_infer", spy)
    voc.warmup()
    voc.warmup((48,), sid=np.array([1]))
    assert shapes == [((1, 32, 80), None), ((1, 64, 80), None), ((1, 48, 80), [1])]
    np.testing.assert_array_equal(voc._synth_window(mel, 10, 64, 0.667, np.array([2]), 4),
                                  before)


# -- against the JAX package at noise_scale = 0 -----------------------------------------
ROUTES = {
    # name: (config, chunk, overlap, frames)
    "module_graph": (VOC_CFG, 64, 16, 150),
    "kernels": (TINY_CFG, 32, 8, 70),
}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def both(request):
    cfg, chunk, overlap, t = ROUTES[request.param]
    jhps, thps = tiny_hparams(cfg)
    params = jax_synth_params(jhps, seed=5)
    with jax.default_matmul_precision("highest"):
        jvoc = JaxVocoder(jhps, jax.tree.map(jnp.asarray, params), dtype=jnp.float32,
                          buckets=(chunk,))
    tvoc = TorchVocoder(thps, state_dict_from_jax_params(params), dtype=torch.float32,
                        buckets=(chunk,), device="cpu")
    assert tvoc.use_kernels == (request.param == "kernels") == jvoc.use_pallas
    mel = np.random.default_rng(8).normal(-4, 2, (t, 80)).astype(np.float32)
    return jvoc, tvoc, mel, chunk, overlap


def test_chunked_and_stream_match_jax(both):
    """f32 at noise_scale 0: chunked and stream of the port against JAX's, atol
    5e-4; and the port's stream equals its chunked decode bit for bit."""
    jvoc, tvoc, mel, chunk, overlap = both
    kw = dict(chunk=chunk, overlap=overlap, noise_scale=0.0)
    with jax.default_matmul_precision("highest"):
        want = jvoc.mel_to_wav_chunked(mel, **kw)
        want_stream = np.concatenate(list(jvoc.stream_mel_to_wav(
            [mel[:13], mel[13:14], mel[14:]], **kw)))
    got = tvoc.mel_to_wav_chunked(mel, **kw)
    got_stream = np.concatenate(list(tvoc.stream_mel_to_wav([mel[:13], mel[13:14], mel[14:]],
                                                            **kw)))
    hop = tvoc.hps.data.hop_length
    assert got.shape == want.shape == got_stream.shape == want_stream.shape == (len(mel) * hop,)
    np.testing.assert_allclose(got, want, atol=5e-4)
    np.testing.assert_allclose(got_stream, want_stream, atol=5e-4)
    np.testing.assert_array_equal(got_stream, got)


# -- the CLI ----------------------------------------------------------------------
def test_infer_cli_copy_synthesis(tmp_path):
    """``python -m smart_vocoder_torch.infer --device cpu`` on a reference-format
    ``G_*.pth``: one output wav per input, of the input's usable length."""
    _, thps = tiny_hparams(VOC_CFG)
    state = init_synthesizer(build_synthesizer(thps), 1).state_dict()
    torch.save({"model": state, "iteration": 3, "optimizer": {}, "learning_rate": 0.0},
               tmp_path / "G_3.pth")
    (tmp_path / "config.json").write_text(json.dumps(VOC_CFG))
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    lengths = {"a.wav": 40 * HOP + 17, "b.wav": 23 * HOP}
    rng = np.random.default_rng(0)
    for name, n in lengths.items():
        wavfile.write(str(wav_dir / name), 22050,
                      (rng.uniform(-0.3, 0.3, n) * 32767).astype(np.int16))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # as the in-process tests (one_thread)
    proc = subprocess.run(
        [sys.executable, "-m", "smart_vocoder_torch.infer", "-c", str(tmp_path / "config.json"),
         "--ckpt", str(tmp_path / "G_3.pth"), "--wavs", str(wav_dir / "*.wav"),
         "--out_dir", str(tmp_path / "out"), "--device", "cpu"],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TOTAL:" in proc.stdout
    for name, n in lengths.items():
        sr, out = wavfile.read(str(tmp_path / "out" / name))
        assert sr == 22050 and out.dtype == np.int16 and out.shape == ((n // HOP) * HOP,)

    bad = subprocess.run(
        [sys.executable, "-m", "smart_vocoder_torch.infer", "-c", str(tmp_path / "config.json"),
         "--ckpt", str(tmp_path), "--wavs", "x", "--device", "cpu"],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "orbax" in bad.stderr
