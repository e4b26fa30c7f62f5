"""The port's ``serving.StreamServer``: multi-stream window batching.

Twins of tests/test_serving.py:82-165 on the port's ``Vocoder`` (that file's
``tiny_vocoder`` config, f32, the port's seeded init). The contract: batching
N streams into one ``(max_streams, chunk)`` decode changes no stream's audio
against its decode alone through ``stream_mel_to_wav`` with the same (chunk,
overlap, seed, sid, noise_scale). Co-tenancy and the row are pinned bit for
bit (one shape); batched against B = 1 crosses two batch sizes, whose
convolutions may sum in another order, so those asserts use atol 1e-6 as
there. A one-row server is the B = 1 program and is pinned bit for bit, in
bf16 too, where the per-row noise scale must round as the B = 1 float does.

Also: the port's server against the JAX package's at ``noise_scale=0.0``
(f32, atol 5e-4 as tests/test_torch_slice.py), and
``tools/bench_streaming.py`` at a small size on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.inference import Vocoder as TorchVocoder
from smart_vocoder_torch.models import build_synthesizer
from smart_vocoder_torch.serving import StreamServer
from smart_vocoder_torch.tools import bench_streaming
from smart_vocoder_torch.utils.init import init_synthesizer
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.inference import Vocoder as JaxVocoder
from smart_vocoder_tpu.serving import StreamServer as JaxStreamServer
from test_torch_package import TINY_CFG, jax_synth_params, tiny_hparams
from test_torch_streaming import VOC_CFG, one_thread, port_vocoder  # noqa: F401 (fixture)

CHUNK, OVERLAP = 64, 16


def assert_matches_sequential(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _mel(seed, t, n_mels=80):
    return np.asarray(np.random.default_rng(seed).normal(size=(t, n_mels)), np.float32)


def _pieces(mel, sizes):
    out, i = [], 0
    for s in sizes:
        out.append(mel[i: i + s])
        i += s
    if i < len(mel):
        out.append(mel[i:])
    return [p for p in out if len(p)]


def _sequential(voc, mel, seed, sid=None, noise_scale=0.667):
    return np.concatenate(list(voc.stream_mel_to_wav(
        _pieces(mel, [23] * 40), chunk=CHUNK, overlap=OVERLAP, seed=seed,
        sid=None if sid is None else np.asarray([sid]), noise_scale=noise_scale)))


@pytest.fixture(scope="module")
def voc():
    return port_vocoder(buckets=(CHUNK,))


@pytest.fixture(scope="module")
def voc_ms():
    return port_vocoder(ms=True, buckets=(CHUNK,))


def _serve_all(server, streams):
    """streams: [(handle, mel)] -> {handle: concatenated audio}."""
    got = {h: [] for h, _ in streams}
    feeds = {h: iter(_pieces(mel, [17] * 60)) for h, mel in streams}
    for h, wav in server.run(feeds):
        got[h].append(wav)
    return {h: np.concatenate(ws) for h, ws in got.items()}


def test_batched_matches_sequential(voc):
    """3 streams (lengths, seeds, noise scales differ) in one batched program
    == each alone through stream_mel_to_wav."""
    server = StreamServer(voc, max_streams=4, chunk=CHUNK, overlap=OVERLAP)
    specs = [(0, 150, 0.667), (7, 101, 0.667), (3, 64, 1.0)]  # (seed, frames, noise_scale)
    streams = [(server.open(seed=seed, noise_scale=ns), _mel(seed + 100, t))
               for seed, t, ns in specs]
    batched = _serve_all(server, streams)
    for (h, mel), (seed, _, ns) in zip(streams, specs):
        assert_matches_sequential(batched[h], _sequential(voc, mel, seed, noise_scale=ns))


def test_speaker_conditioned_rows(voc_ms):
    """Per-row speaker ids: each stream decodes with its own embedding."""
    server = StreamServer(voc_ms, max_streams=4, chunk=CHUNK, overlap=OVERLAP)
    mel = _mel(5, 96)
    h0, h1 = server.open(seed=1, sid=0), server.open(seed=1, sid=3)
    batched = _serve_all(server, [(h0, mel), (h1, mel)])
    w0, w1 = _sequential(voc_ms, mel, 1, sid=0), _sequential(voc_ms, mel, 1, sid=3)
    assert_matches_sequential(batched[h0], w0)
    assert_matches_sequential(batched[h1], w1)
    assert not np.array_equal(w0, w1)  # the sid rows really condition


def test_oversubscription_schedules_everyone(voc):
    """6 streams on a 2-row server: oldest cursor first, every stream served."""
    server = StreamServer(voc, max_streams=2, chunk=CHUNK, overlap=OVERLAP)
    streams = [(server.open(seed=s), _mel(s, 80 + 10 * s)) for s in range(6)]
    batched = _serve_all(server, streams)
    for i, (h, mel) in enumerate(streams):
        assert_matches_sequential(batched[h], _sequential(voc, mel, i))


def test_slot_position_invariance(voc):
    """A stream's audio does not depend on its row or its co-tenants."""
    mel = _mel(42, 120)
    s1 = StreamServer(voc, max_streams=4, chunk=CHUNK, overlap=OVERLAP)
    alone = _serve_all(s1, [(s1.open(seed=9), mel)])
    s2 = StreamServer(voc, max_streams=4, chunk=CHUNK, overlap=OVERLAP)
    others = [(s2.open(seed=s), _mel(s, 100)) for s in (1, 2)]  # the target lands in row 2
    target = (s2.open(seed=9), mel)
    crowded = _serve_all(s2, others + [target])
    np.testing.assert_array_equal(list(alone.values())[0], crowded[target[0]])


def test_incremental_step_api(voc):
    """feed/step/close: nothing before a full window is buffered; close()
    flushes the tail; the pieces equal the offline path."""
    mel = _mel(11, 90)
    server = StreamServer(voc, max_streams=2, chunk=CHUNK, overlap=OVERLAP)
    h = server.open(seed=11)
    step = CHUNK - 2 * OVERLAP
    server.feed(h, mel[: step + OVERLAP - 1])  # one frame short of a window
    assert server.pending() == 0 and server.step() == {}
    server.feed(h, mel[step + OVERLAP - 1:])
    pieces = []
    while server.pending():
        pieces.extend(server.step().values())
    server.close(h)
    while server.pending():
        pieces.extend(server.step().values())
    want = voc.mel_to_wav_chunked(mel, chunk=CHUNK, overlap=OVERLAP, seed=11)
    assert_matches_sequential(np.concatenate(pieces), want)
    with pytest.raises(KeyError):  # a finished stream is gone
        server.feed(h, mel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_row_server_is_the_b1_program(dtype):
    """max_streams=1 runs the B = 1 window shape: bit for bit equal to
    stream_mel_to_wav, in bf16 too, at both noise scales (the row's f32 scale
    rounds to the prior's dtype as the float of the B = 1 path does)."""
    v = port_vocoder(ms=True, buckets=(CHUNK,), dtype=dtype)
    mel = _mel(3, 130)
    for ns, sid in ((0.667, 1), (1.0, 2)):
        server = StreamServer(v, max_streams=1, chunk=CHUNK, overlap=OVERLAP)
        h = server.open(seed=4, sid=sid, noise_scale=ns)
        got = np.concatenate([w for _, w in server.run({h: iter(_pieces(mel, [29] * 9))})])
        np.testing.assert_array_equal(got, _sequential(v, mel, 4, sid=sid, noise_scale=ns))


def test_warmup_and_idle_rows(voc):
    """``warmup`` decodes one batch of idle (length-0) rows; a closed stream
    with nothing buffered leaves at once."""
    server = StreamServer(voc, max_streams=3, chunk=CHUNK, overlap=OVERLAP)
    assert server._decode_batch([]) == []
    server.warmup()
    h = server.open(seed=1)
    server.close(h)
    assert server.pending() == 0 and server.step() == {} and not server._streams


@pytest.mark.parametrize("route", ["module_graph", "kernels"])
def test_server_matches_jax(route):
    """The port's server against the JAX package's: two streams on a 3-row
    server at noise_scale 0, f32, atol 5e-4."""
    cfg, chunk, overlap = (VOC_CFG, 64, 16) if route == "module_graph" else (TINY_CFG, 32, 8)
    jhps, thps = tiny_hparams(cfg)
    params = jax_synth_params(jhps, seed=6)
    mels = [_mel(20, 90), _mel(21, 57)]

    def serve(server):
        hs = [server.open(seed=s, noise_scale=0.0) for s in (1, 2)]
        got = {h: [] for h in hs}
        for h, wav in server.run({h: iter(_pieces(m, [19] * 6)) for h, m in zip(hs, mels)}):
            got[h].append(wav)
        return [np.concatenate(got[h]) for h in hs]

    with jax.default_matmul_precision("highest"):
        jvoc = JaxVocoder(jhps, jax.tree.map(jnp.asarray, params), dtype=jnp.float32,
                          buckets=(chunk,))
        want = serve(JaxStreamServer(jvoc, max_streams=3, chunk=chunk, overlap=overlap))
    tvoc = TorchVocoder(thps, state_dict_from_jax_params(params), dtype=torch.float32,
                   buckets=(chunk,), device="cpu")
    got = serve(StreamServer(tvoc, max_streams=3, chunk=chunk, overlap=overlap))
    for g, w, m in zip(got, want, mels):
        assert g.shape == w.shape == (len(m) * thps.data.hop_length,)
        np.testing.assert_allclose(g, w, atol=5e-4)


def test_bench_streaming_tool_on_the_cpu(capsys):
    """The tool at a small size: one operating point, N in {1, 2}; it prints
    its tables, each naming the device, and N = 1 equals B = 1 exactly."""
    _, thps = tiny_hparams(TINY_CFG)
    state = init_synthesizer(build_synthesizer(thps), 0).state_dict()
    out = bench_streaming.main(["--rounds", "1", "--iters", "1", "--points", "64:16",
                                "--streams", "1,2", "--stream-point", "64:16"],
                               hps=thps, state=state, device="cpu", seam_frames=160)
    text = capsys.readouterr().out
    assert text.count("[cpu: host times, not a device measurement") == 3
    assert "first_audio_ms" in text and "aggregate_rtf" in text and "warm_ms" in text
    assert "eager_ms" in text and "capture_ms" in text
    (point,) = out["points"]
    assert point["buffer_ms"] == pytest.approx(48 * 16 / 22050 * 1e3)
    assert np.isfinite(point["compute_ms"]) and np.isfinite(point["seam"])
    assert all(np.isfinite(r["eager_ms"]) for r in out["points"] + out["streams"])
    assert [r["streams"] for r in out["streams"]] == [1, 2]
    assert out["streams"][0]["max_diff"] == 0.0
    assert [r["chunk"] for r in out["warmup"]] == [64]
