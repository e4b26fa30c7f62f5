"""Build the package's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of this package (with the ``*.cuh``
headers beside them) -- and nothing else -- for ``sm_90a``, one process per
source, all started together, then links the objects into a shared library
with a plain C interface under ``smart_vocoder_torch/_build/`` (git-ignored),
named by a hash of the sources, headers and flags, so an edited source
rebuilds and an unchanged one loads at once.
A failed build or load raises; nothing is downloaded. The first load and the
launch counts are safe under threads: a multi-card ``Vocoder`` launches from
one worker thread a device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "kernels" / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, out, w (packed bf16 tiles), bias, B, T, C, tile, R, nb, k0..k2, np, d0..d2, mode,
    # in_bf16, mask_edges, out_bf16, stream
    "svt_mrf_stage": [_P] * 4 + [_I] * 17 + [_P],
    # the same with w as flat f32 [branch][w1, w2]
    "svt_mrf_stage_fma": [_P] * 4 + [_I] * 17 + [_P],
    # u, out, w (packed bf16 tiles: upsample, then MRF), bup, bias, wpost, B, Tu, Cin, C,
    # kup, sup, pup, tile, H, kpost, nb, k0..k2, np, d0..d2, mode, in_bf16, stream
    "svt_up_mrf_stage": [_P] * 6 + [_I] * 20 + [_P],
    # u, out, wup, bup, w, bias, wpost (all f32), then as svt_up_mrf_stage
    "svt_up_mrf_stage_fma": [_P] * 7 + [_I] * 20 + [_P],
    # x, out, s0, s1, acc, w (packed bf16 tiles), bias, B, T, C, tile, nb, k0..k2, np,
    # d0..d2, n_launched (out), stream
    "svt_mrf_stage_unpacked": [_P] * 7 + [_I] * 12 + [ctypes.POINTER(_I), _P],
    # the same, all f32, w as flat [branch][w1 of every pair, w2 of every pair]
    "svt_mrf_stage_unpacked_fma": [_P] * 7 + [_I] * 12 + [ctypes.POINTER(_I), _P],
    # x, mask, x_out, skip, w (packed bf16 tiles), b_in, b_rs, B, T, H, tile, n_layers,
    # final_mask, last_skip_only, stream
    "svt_wn_stack": [_P] * 7 + [_I] * 7 + [_P],
    # the same, all f32, w as [layer][w_in, w_rs], without last_skip_only
    "svt_wn_stack_fma": [_P] * 7 + [_I] * 6 + [_P],
    # x, g, dx, xs, hs, dys, dhs, wf (packed bf16 tiles), b1, b2, wb (packed flipped
    # tiles), zero, dw1, db1, dw2, db2, B, T, C, tile_r, tile_d, k, np, d0..d2, splits,
    # n_launched (out), stream
    "svt_mrf_branch_bwd": [_P] * 16 + [_I] * 11 + [ctypes.POINTER(_I), _P],
    # x, g, dx, xs, hs, dtmp, w1, b1, w2, b2, w1f, w2f, dw1, db1, dw2, db2 (all f32), B, T,
    # C, tile, k, np, d0..d2, n_launched (out), stream
    "svt_mrf_branch_bwd_fma": [_P] * 16 + [_I] * 9 + [ctypes.POINTER(_I), _P],
}

SMEM_LIMIT = 232448  # bytes of dynamic shared memory a Hopper block may use


def pick_tile(smem_bytes) -> int:
    """The largest time tile (rows) whose ``smem_bytes(tile)`` fits in a block."""
    for tile in (256, 128, 64, 32):
        if smem_bytes(tile) <= SMEM_LIMIT:
            return tile
    raise ValueError("the kernel does not fit in shared memory at any tile size")


# Kernel launches under each wrapper's name, counted where the wrapper calls
# its entry point: one per call, or what the entry point reports it launched
# ("mrf_stage_variant": mrf_stage with an option of the A/B variants set).
LAUNCHES: dict[str, int] = {"mrf_stage": 0, "up_mrf_stage": 0, "mrf_stage_unpacked": 0,
                            "wn_stack": 0, "fused_gate": 0, "mrf_branch_bwd": 0,
                            "mrf_stage_variant": 0,
                            # the f32 FMA bodies of six of the above (true-f32 weights)
                            "mrf_stage_fma": 0, "up_mrf_stage_fma": 0,
                            "mrf_stage_variant_fma": 0, "mrf_stage_unpacked_fma": 0,
                            "wn_stack_fma": 0, "mrf_branch_bwd_fma": 0}
_COUNT_LOCK = threading.Lock()  # a += from two threads can lose one of them
_LOAD_LOCK = threading.Lock()   # one build and one load, whatever thread asks first


def count_launches(name: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += n


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch(name: str, fn, *args, launched: ctypes.c_int | None = None) -> None:
    """Call the entry point ``fn`` on PyTorch's current stream (appended as
    the last argument), raise on a refused launch, and count its kernels
    under ``name``: one, or ``launched``, the entry point's own count, for
    one that launches several."""
    import torch

    rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    count_launches(name, 1 if launched is None else launched.value)


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
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libsvt_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}.{threading.get_ident()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    log, failed = [], []
    for src, proc in zip(_sources(), procs):
        log.append(f"== {src.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    so.with_suffix(".log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{''.join(log)[-4000:]}")
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's argtypes declared
    (built and loaded once: a thread that asks meanwhile waits)."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
