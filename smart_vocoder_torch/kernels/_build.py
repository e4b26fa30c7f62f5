"""Build the package's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of this package -- and nothing else --
for ``sm_90a`` into a shared library with a plain C interface under
``smart_vocoder_torch/_build/`` (git-ignored), named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at once.
A failed build or load raises; nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "kernels" / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, out, w, bias, B, T, C, tile, R, nb, k0..k2, np, d0..d2, mode, in_bf16, stream
    "svt_mrf_stage": [_P] * 4 + [_I] * 15 + [_P],
    # u, out, wup, bup, w, bias, wpost, B, Tu, Cin, C, kup, sup, pup, tile, H, kpost,
    # nb, k0..k2, np, d0..d2, mode, in_bf16, stream
    "svt_up_mrf_stage": [_P] * 7 + [_I] * 20 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def build() -> Path:
    """Compile the sources unless the library for their hash exists; the
    compiler's report (registers, shared memory, spills) goes to a .log beside it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libsvt_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
