"""Filelist-driven audio dataset (reference data_utils.py:14-80); counterpart
of ``smart_vocoder_tpu/data/dataset.py``.

Features are made on the host at load time, as the reference makes them:
read the 16-bit wav (the native reader, else scipy), divide by
``max_wav_value``, trim to a hop multiple and take the linear magnitude
spectrogram in numpy (``stft_magnitude_np``, the same function as
``ops.stft.stft_magnitude``), so the loader's threads never touch the card.
Lengths for bucketing come from the RIFF header without reading the audio.

Filelist format: one wav path per line, optionally ``path|speaker_id``; lines
with glob characters are expanded (filelists/train_files_ss.txt:1).
"""

from __future__ import annotations

import glob as globlib
import os
import random
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np
from scipy.io import wavfile

from smart_vocoder_torch.data import native_wavio


def load_filepaths(filename: str) -> List[Tuple[str, Optional[int]]]:
    """Read a filelist; expand glob lines; parse optional ``|sid`` suffixes."""
    entries: List[Tuple[str, Optional[int]]] = []
    with open(filename, encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            sid: Optional[int] = None
            if "|" in line:
                path, sid_str = line.split("|", 1)
                sid = int(sid_str)
            else:
                path = line
            if any(ch in path for ch in "*?["):
                entries.extend((p, sid) for p in sorted(globlib.glob(path, recursive=True)))
            else:
                entries.append((path, sid))
    return entries


def load_wav(full_path: str) -> Tuple[np.ndarray, int]:
    """A wav's raw values as float32 and its sample rate (ref: utils.py:133-135)."""
    sampling_rate, data = wavfile.read(full_path)
    return data.astype(np.float32), sampling_rate


def hann_window_np(win_length: int) -> np.ndarray:
    """Periodic Hann window, as ``torch.hann_window(periodic=True)`` in
    ``ops.stft`` (mel_processing.py:61), computed in f64 and rounded once."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def stft_magnitude_np(y: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """Host numpy form of ``ops.stft.stft_magnitude`` for the loader's threads:
    y (L,) float32 -> (n_frames, n_fft//2+1) float32."""
    p = int((n_fft - hop) / 2)
    y = np.pad(y, (p, p), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx] * hann_window_np(win)
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    return np.sqrt(spec.real**2 + spec.imag**2 + 1e-6).astype(np.float32)


def _wav_data_frames(path: str) -> Optional[int]:
    """Sample-frame count from a RIFF/WAVE header (``data`` size over
    ``block_align``), walking past LIST/fact/... chunks; ``None`` for anything
    that is not a well-formed wav."""
    try:
        with open(path, "rb") as f:
            riff = f.read(12)
            if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
                return None
            block_align = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return None
                cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if cid == b"fmt ":
                    fmt = f.read(size)
                    if len(fmt) < 16:
                        return None
                    block_align = struct.unpack("<H", fmt[12:14])[0]
                elif cid == b"data":
                    if not block_align:
                        return None
                    return size // block_align
                else:
                    f.seek(size + (size & 1), os.SEEK_CUR)
    except OSError:
        return None


class AudioSpecDataset:
    """(spec, wav, sid) tuples from a filelist (ref: data_utils.py:14-80).

    ``cache_specs=True`` keeps each spectrogram as ``<wav>.spec.npy`` beside
    the audio and reads it back while it is newer than the wav and has the
    wav's frame count."""

    def __init__(self, filelist: str, hps_data, cache_specs: bool = False):
        self.entries = load_filepaths(filelist)
        self.max_wav_value = hps_data.max_wav_value
        self.sampling_rate = hps_data.sampling_rate
        self.filter_length = hps_data.filter_length
        self.hop_length = hps_data.hop_length
        self.win_length = hps_data.win_length
        self.cache_specs = cache_specs
        # the reference shuffles once with a fixed seed (data_utils.py:30-31)
        random.Random(1234).shuffle(self.entries)
        self._estimate_lengths()

    def _estimate_lengths(self) -> None:
        """Spec frames per entry for bucketing: the header's sample frames
        over the hop, else the reference's ``file_size // 2`` estimate
        (data_utils.py:34-46)."""
        self.lengths = []
        for path, _ in self.entries:
            frames = _wav_data_frames(path)
            if frames is None:
                frames = os.path.getsize(path) // 2
            self.lengths.append(frames // self.hop_length)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, index: int):
        path, sid = self.entries[index]
        native = native_wavio.read_wav_norm_f32(path, self.max_wav_value)
        if native is not None:
            audio_norm, sr = native
        else:
            audio, sr = load_wav(path)
            audio_norm = audio / self.max_wav_value
        if sr != self.sampling_rate:
            raise ValueError(f"{sr} SR doesn't match target {self.sampling_rate} SR ({path})")
        # a hop multiple, so that spec frames * hop == wav samples exactly
        usable = (len(audio_norm) // self.hop_length) * self.hop_length
        audio_norm = audio_norm[:usable]

        spec = None
        cache_path = path + ".spec.npy"
        if self.cache_specs and os.path.exists(cache_path) and (
            os.path.getmtime(cache_path) >= os.path.getmtime(path)
        ):
            spec = np.load(cache_path)
            if spec.shape[0] != usable // self.hop_length:
                spec = None  # stale, or other DSP parameters
        if spec is None:
            spec = stft_magnitude_np(audio_norm, self.filter_length, self.hop_length,
                                     self.win_length)
            if self.cache_specs:
                _save_atomic(cache_path, spec)
        return spec, audio_norm[:, None], sid


def _save_atomic(path: str, array: np.ndarray) -> None:
    """``np.save`` under a name of this thread's, then moved into place: a
    loader thread that reads the cache (a padded bucket repeats utterances
    within a batch) never sees a file half written."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.save(f, array)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
