"""The port's data pipeline against the JAX package's, on the CPU.

- ``AudioSpecDataset``: entries (the seeded shuffle, globs, ``|sid``),
  header lengths, and every item's spectrogram, wav and sid against JAX's,
  element for element (spectrograms within 1e-6; the same numpy arithmetic
  gives the same bits), with and without the ``.spec.npy`` cache, and on a
  float32 wav that goes to scipy. A cache being written is never read half
  written.
- The native reader: samples equal to scipy's; stereo and non-wav files are
  left to scipy; the library is built under the package's ``_build/``.
- ``BucketSampler``: the same batches in the same order as JAX's for
  boundaries with empty and dropped buckets, replicas 1-4, every rank,
  epochs 0-3, shuffle on and off; the same padded boundary for each batch.
- ``pad_to_bucket``: JAX's arrays exactly, with and without sids, and a
  sample cut at its bucket with a warning.
- ``BucketedLoader``: an epoch equal to JAX's loader's; ``iter_from(k)`` the
  tail of the epoch for every k; an abandoned iterator releases its thread.
"""

import gc
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from smart_vocoder_torch.config import HParams as TorchHParams
from smart_vocoder_torch.data import AudioSpecDataset, BucketedLoader, BucketSampler
from smart_vocoder_torch.data import native_wavio
from smart_vocoder_torch.data.pipeline import pad_to_bucket
from smart_vocoder_torch.tools.make_corpus import write_corpus as make_corpus
from smart_vocoder_tpu.config import HParams as JaxHParams
from smart_vocoder_tpu.data import AudioSpecDataset as JaxDataset
from smart_vocoder_tpu.data import BucketedLoader as JaxLoader
from smart_vocoder_tpu.data import BucketSampler as JaxSampler
from smart_vocoder_tpu.data.pipeline import pad_to_bucket as jax_pad_to_bucket

SR, HOP = 22050, 256
DATA = dict(max_wav_value=32768.0, sampling_rate=SR, filter_length=1024, hop_length=HOP,
            win_length=1024)


def write_corpus(root, frames, sids=None, f32_index=None, glob_line=False):
    """Mono PCM16 tones of the given spec-frame lengths (one float32 wav at
    ``f32_index``) and a filelist; returns the filelist's path."""
    rng = np.random.default_rng(0)
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i, f in enumerate(frames):
        n = f * HOP + int(rng.integers(0, HOP))  # not a hop multiple: the trim
        t = np.arange(n) / SR
        wav = np.sin(2 * np.pi * (150 + 37 * i) * t) * 0.3 + rng.normal(0, 0.01, n)
        path = os.path.join(wav_dir, f"u{i:03d}.wav")
        if i == f32_index:
            wavfile.write(path, SR, wav.astype(np.float32))
        else:
            wavfile.write(path, SR, (wav * 32767).astype(np.int16))
        lines.append(path if sids is None else f"{path}|{sids[i]}")
    if glob_line:
        lines = [os.path.join(wav_dir, "u00*.wav")] + [ln for ln in lines if "/u00" not in ln]
    filelist = os.path.join(root, "files.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(lines) + "\n")
    return filelist


def datasets(filelist, cache_specs=False):
    return (AudioSpecDataset(filelist, TorchHParams(**DATA), cache_specs=cache_specs),
            JaxDataset(filelist, JaxHParams(**DATA), cache_specs=cache_specs))


@pytest.mark.parametrize("cache_specs", [False, True])
def test_dataset_matches_jax(tmp_path, cache_specs):
    filelist = write_corpus(str(tmp_path), [40, 75, 33, 120, 64, 90, 51, 47, 200, 38, 66, 101],
                            f32_index=3, glob_line=True)
    ours, ref = datasets(filelist, cache_specs)
    assert ours.entries == ref.entries and len(ours) == 12
    assert ours.lengths == ref.lengths
    for rnd in range(2 if cache_specs else 1):  # the second pass reads the cache
        for i in range(len(ours)):
            spec, wav, sid = ours[i]
            spec_j, wav_j, sid_j = ref[i]
            assert spec.dtype == np.float32 and wav.dtype == spec_j.dtype
            np.testing.assert_allclose(spec, spec_j, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(wav, wav_j)
            assert wav.shape == (spec.shape[0] * HOP, 1) and sid is sid_j is None
        if cache_specs:
            assert all(os.path.exists(p + ".spec.npy") for p, _ in ours.entries)


def test_spec_cache_is_never_read_half_written(tmp_path, monkeypatch):
    """A loader thread that reads an utterance's cache while another thread
    writes it gets the spectrogram, not a half-written file. The reader runs
    at the worst moment: the writer has opened its file (``np.save`` on a
    path truncates it first) and written nothing yet."""
    from smart_vocoder_torch.data import dataset as dataset_lib

    filelist = write_corpus(str(tmp_path), [40])
    ds = AudioSpecDataset(filelist, TorchHParams(**DATA), cache_specs=True)
    save, read = np.save, []

    def reader():
        try:
            read.append(ds[0][0])
        except Exception as e:  # noqa: BLE001 -- reported by the assertion below
            read.append(e)

    def racing_save(file, array, *args, **kwargs):
        if threading.current_thread() is threading.main_thread():
            if isinstance(file, (str, os.PathLike)):
                open(file, "wb").close()
            thread = threading.Thread(target=reader)
            thread.start()
            thread.join()
        return save(file, array, *args, **kwargs)

    monkeypatch.setattr(dataset_lib.np, "save", racing_save)
    spec = ds[0][0]
    assert len(read) == 1 and isinstance(read[0], np.ndarray), read
    np.testing.assert_array_equal(read[0], spec)
    np.testing.assert_array_equal(np.load(ds.entries[0][0] + ".spec.npy"), spec)
    assert sorted(os.listdir(os.path.dirname(ds.entries[0][0]))) == ["u000.wav",
                                                                     "u000.wav.spec.npy"]


def test_dataset_sids_match_jax(tmp_path):
    sids = [3, 0, 2, 1, 1, 4]
    filelist = write_corpus(str(tmp_path), [40, 50, 60, 70, 80, 90], sids=sids)
    ours, ref = datasets(filelist)
    assert ours.entries == ref.entries
    assert [ours[i][2] for i in range(6)] == [ref[i][2] for i in range(6)]
    assert sorted(ours[i][2] for i in range(6)) == sorted(sids)


def test_native_reader_matches_scipy(tmp_path):
    assert native_wavio.available()
    assert str(native_wavio.BUILD_DIR).endswith(os.path.join("smart_vocoder_torch", "_build"))
    rng = np.random.default_rng(0)
    data = (rng.uniform(-0.8, 0.8, SR * 2) * 32767).astype(np.int16)
    path = os.path.join(str(tmp_path), "a.wav")
    wavfile.write(path, SR, data)
    audio, sr = native_wavio.read_wav_norm_f32(path, 32768.0)
    assert sr == SR
    np.testing.assert_array_equal(audio, data.astype(np.float32) / 32768.0)

    stereo = os.path.join(str(tmp_path), "st.wav")
    wavfile.write(stereo, SR, np.zeros((100, 2), np.int16))
    garbage = os.path.join(str(tmp_path), "g.wav")
    with open(garbage, "wb") as f:
        f.write(b"not a wav at all")
    assert native_wavio.read_wav_norm_f32(stereo) is None
    assert native_wavio.read_wav_norm_f32(garbage) is None


# lengths over every bucket of these boundaries except (300, 400], which stays
# empty, and some outside them (dropped)
BOUNDARIES = [32, 100, 200, 300, 400, 500, 600]


def sampler_lengths():
    rng = np.random.default_rng(7)
    spans = [(33, 100), (101, 200), (201, 300), (401, 500), (501, 600)]
    lengths = [int(rng.integers(*spans[i % len(spans)])) for i in range(53)]
    return lengths + [5, 32, 601, 9000]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("replicas", [1, 2, 3, 4])
def test_sampler_matches_jax(replicas, shuffle):
    lengths = sampler_lengths()
    for rank in range(replicas):
        ours = BucketSampler(lengths, 3, BOUNDARIES, num_replicas=replicas, rank=rank,
                             shuffle=shuffle)
        ref = JaxSampler(lengths, 3, list(BOUNDARIES), num_replicas=replicas, rank=rank,
                         shuffle=shuffle)
        assert ours.boundaries == ref.boundaries and 400 not in ours.boundaries
        assert len(ours) == len(ref) > 0
        for epoch in range(4):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(ours), list(ref)
            assert got == want, (rank, epoch)
            assert [ours.bucket_boundary(b) for b in got] == [ref.bucket_boundary(b)
                                                              for b in want]


def random_items(rng, frames, with_sid):
    items = []
    for i, f in enumerate(frames):
        spec = rng.random((f, 513), dtype=np.float32)
        wav = rng.uniform(-1, 1, (f * HOP, 1)).astype(np.float32)
        items.append((spec, wav, (i % 3 if i % 2 else None) if with_sid else None))
    return items


@pytest.mark.parametrize("with_sid", [False, True])
def test_pad_to_bucket_matches_jax(with_sid):
    rng = np.random.default_rng(1)
    items = random_items(rng, [40, 97, 12, 100, 63], with_sid)
    got = pad_to_bucket(items, 100, HOP, with_sid)
    want = jax_pad_to_bucket(items, 100, HOP, with_sid)
    for name in ("spec", "spec_lengths", "wav", "wav_lengths", "sid"):
        g, w = getattr(got, name), getattr(want, name)
        if not with_sid and name == "sid":
            assert g is None and w is None
            continue
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # a sample longer than its bucket is cut, with a warning, as JAX's is
    long = random_items(rng, [120, 30], with_sid)
    with pytest.warns(UserWarning, match="exceeds its bucket"):
        got = pad_to_bucket(long, 100, HOP, with_sid)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_pad_to_bucket(long, 100, HOP, with_sid)
    np.testing.assert_array_equal(got.spec.numpy(), np.asarray(want.spec))
    np.testing.assert_array_equal(got.wav_lengths.numpy(), np.asarray(want.wav_lengths))


def test_batch_to_moves_without_copying():
    """``Batch.to`` hands each tensor to ``Tensor.to`` as it is: on its own
    device it is the same tensor, not a copy. (``dataclasses.astuple``, which
    it used, deep-copies every tensor first: for the loader's pinned batch
    that was a host copy into unpinned memory, then a blocking transfer.)"""
    rng = np.random.default_rng(0)
    batch = pad_to_bucket(random_items(rng, [40, 30], True), 50, HOP, True)
    moved = batch.to("cpu", non_blocking=True)
    for name in ("spec", "spec_lengths", "wav", "wav_lengths", "sid"):
        assert getattr(moved, name) is getattr(batch, name), name
    assert batch.to(torch.float64).spec.dtype == torch.float64


def loaders(tmp_path, n=14, sids=True):
    rng = np.random.default_rng(3)
    frames = [int(v) for v in rng.integers(35, 130, n)]
    filelist = write_corpus(str(tmp_path), frames, sids=[i % 4 for i in range(n)] if sids
                            else None)
    ours, ref = datasets(filelist)
    s_ours = BucketSampler(ours.lengths, 2, [32, 64, 100, 160])
    s_ref = JaxSampler(ref.lengths, 2, [32, 64, 100, 160])
    s_ours.set_epoch(3)
    s_ref.set_epoch(3)
    return (BucketedLoader(ours, s_ours, with_sid=sids, num_workers=2, prefetch=2),
            JaxLoader(ref, s_ref, with_sid=sids, num_workers=2, prefetch=2))


def test_loader_epoch_and_iter_from(tmp_path):
    loader, ref = loaders(tmp_path)
    full = list(loader)
    want = list(ref)
    assert len(full) == len(want) == len(loader) >= 4
    for a, b in zip(full, want):
        for name in ("spec", "spec_lengths", "wav", "wav_lengths", "sid"):
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          np.asarray(getattr(b, name)), err_msg=name)
    for k in range(len(full) + 1):
        tail = list(loader.iter_from(k))
        assert len(tail) == len(full) - k
        for a, b in zip(full[k:], tail):
            assert torch.equal(a.spec, b.spec) and torch.equal(a.wav, b.wav)
            assert torch.equal(a.sid, b.sid)
    loader.close()


def test_abandoned_iterator_releases_thread(tmp_path):
    """Taking one batch and dropping the iterator (the eval's pattern) ends
    its producer thread, though the queue behind it is full."""
    loader, _ = loaders(tmp_path, n=24, sids=False)

    def producers():
        return sum(t.name.startswith("Thread") and t.is_alive() for t in threading.enumerate())

    base = producers()
    for _ in range(5):
        it = iter(loader)
        assert next(it).spec.shape[0] == 2
        del it
        gc.collect()
    deadline = time.time() + 10
    while time.time() < deadline and producers() > base:
        time.sleep(0.1)
    assert producers() <= base, "producer threads leaked"
    loader.close()


def test_make_corpus_fills_the_buckets(tmp_path):
    """The synthetic corpus of the card's smoke run: lengths spread evenly
    from ``min_frames`` to ``max_frames`` (every iitp_base bucket from 300 to
    1000 used), mono PCM16 at 22.05 kHz, ``path|sid`` lines with speakers."""
    files = make_corpus(str(tmp_path), clips=14, min_frames=345, max_frames=1000, speakers=3)
    ds = AudioSpecDataset(files, TorchHParams(**DATA))
    assert sorted(ds.lengths) == list(np.linspace(345, 1000, 14).round().astype(int))
    sampler = BucketSampler(ds.lengths, 1, [32, 300, 400, 500, 600, 700, 800, 900, 1000])
    assert [len(b) > 0 for b in sampler.buckets] == [False] + [True] * 7
    assert sorted({sid for _, sid in ds.entries}) == [0, 1, 2]
    sr, data = wavfile.read(ds.entries[0][0])
    assert sr == SR and data.dtype == np.int16 and data.ndim == 1
