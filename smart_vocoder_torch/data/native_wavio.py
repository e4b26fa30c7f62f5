"""ctypes binding of the repo's native wav reader (``native/wavio.cpp``);
counterpart of ``smart_vocoder_tpu/data/native_wavio.py``.

At first use ``g++`` compiles ``native/wavio.cpp`` into
``smart_vocoder_torch/_build/libwavio-<hash>.so`` (git-ignored; named by a
hash of the source and flags, written under a temporary name and moved into
place, so processes that start together do not clash). ``native/`` is only
read. Files the reader does not handle (not mono PCM16), a missing compiler
or ``SMARTVOC_NO_NATIVE`` in the environment leave the caller to scipy. The
reader runs without the interpreter lock, so the loader's threads decode in
parallel. This is host file I/O, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "wavio.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared"]  # native/Makefile's


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int16),
        ("bits_per_sample", ctypes.c_int16),
        ("n_frames", ctypes.c_int64),
        ("data_offset", ctypes.c_int64),
        ("format", ctypes.c_int16),
    ]


class _Library:
    """The compiled reader, loaded once per process (``None`` if it cannot be)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self._failed = False

    def get(self):
        with self._lock:
            if self._lib is None and not self._failed:
                try:
                    self._lib = self._load()
                except (OSError, subprocess.SubprocessError) as e:
                    logger.info("native wavio unavailable (%s); using scipy", e)
                    self._failed = True
            return self._lib

    @staticmethod
    def _load():
        if os.environ.get("SMARTVOC_NO_NATIVE"):
            raise OSError("SMARTVOC_NO_NATIVE is set")
        digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"libwavio-{digest[:12]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                           stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.wavio_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
        lib.wavio_info.restype = ctypes.c_int
        lib.wavio_read_f32.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_float,
        ]
        lib.wavio_read_f32.restype = ctypes.c_int64
        return lib


LIBRARY = _Library()


def available() -> bool:
    return LIBRARY.get() is not None


def read_wav_norm_f32(path: str, scale: float = 32768.0) -> Optional[Tuple[np.ndarray, int]]:
    """A mono PCM16 wav as float32 samples divided by ``scale``, and its
    sample rate; ``None`` when the native reader cannot take the file (the
    caller falls back to scipy)."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    info = _WavInfo()
    if lib.wavio_info(path.encode(), ctypes.byref(info)) != 0:
        return None
    if info.format != 1 or info.channels != 1 or info.bits_per_sample != 16:
        return None
    out = np.empty(info.n_frames, np.float32)
    n = lib.wavio_read_f32(path.encode(), out, info.n_frames, float(scale))
    if n < 0:
        return None
    return out[:n], int(info.sample_rate)
