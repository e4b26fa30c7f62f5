"""Same-process A/B of the unpacked stage's GEMM pass width.

``csrc/mrf_pair.cu`` runs each conv at C >= 128 as one pass of all C columns
(C / 64 ``wgmma`` slices that share each A fragment): 16 warps at C = 128,
8 warps and a 3-slot ring at C = 256, whose 128 accumulators a thread 512
threads cannot hold. This tool builds a copy of the sources in which
``PairGeometry`` and ``pair_conv`` split the GEMM into C / N passes of N
columns on 16 warps, each pass reading A again, and times it beside the tree:

- ``tree``: the sources as they are;
- ``n128``: passes of 128 columns (at C = 128 the tree's own geometry; at
  C = 256 two passes);
- ``n64``: passes of 64 columns (one slice a pass).

Each build gets the weight layout and tile its geometry reads. Shapes: x
(2, 64000, 128), (16, 2048, 128), (1, 8192, 256) and (16, 256, 256), bf16,
kernel sizes (3, 7, 11), dilations (1, 3, 5); each result is held to the
plain version (max |diff| printed); device ms over 5 launches, the builds
interleaved, ROUNDS times (every other round in reverse order), then each
leg's median and range. With a second argument, the root of another
checkout (an earlier commit unpacked with ``git archive``), its
``mrf_pair.cu`` is built as one more leg (``other``), so a change to the
pair kernel is timed against its parent in one call.

    python -m smart_vocoder_torch.tools.ab_pair_pass [ROUNDS [CHECKOUT]]   (ROUNDS: 2)

Needs the card and ``nvcc``; builds into ``smart_vocoder_torch/_build/ab/``.
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from smart_vocoder_torch.kernels import _build
from smart_vocoder_torch.kernels import mrf as K
from smart_vocoder_torch.tools.ab_stage_mma import device_ms

KS, DIL = (3, 7, 11), (1, 3, 5)
SHAPES = ((2, 64000, 128), (16, 2048, 128), (1, 8192, 256), (16, 256, 256))
VARIANTS = {"tree": None, "n128": 128, "n64": 64}  # name -> columns of a pass
# what a split build replaces in kernels.mrf (the library, and _split_layout's)
PATCHED = ("load_library", "_conv_tiles", "unpacked_smem_bytes", "pair_geometry")

# The pass-split geometry and GEMM, put in place of the tree's PairGeometry,
# smem_bytes and pair_conv in csrc/mrf_pair.cuh (everything from the struct to
# the state type and the pair's body).
SPLIT_SOURCE = r"""
constexpr int kPassN = PASS_N;

template <int C>
struct PairGeometry {
  static constexpr bool kWide = C >= 128;
  static constexpr int THREADS = kMmaThreads;
  static constexpr int PASS = kWide ? kPassN : C;  // columns of a pass
  static constexpr int NS = kWide ? PASS / 64 : 1;
  static constexpr int TN = PASS;                  // ring tile columns
  static constexpr int KT = kWide ? 64 : C;
  static constexpr int STAGES = kStages;
  static constexpr int MAX_ROWS = THREADS / 2;
  __host__ __device__ static constexpr int tiles(int k) {
    return kWide ? k * (C / 64) * (C / PASS) : k;
  }
};

template <int C>
constexpr size_t smem_bytes(int tile, int h, int d) {
  using G = PairGeometry<C>;
  return static_cast<size_t>(2 * tile + 2 * (h * d + h) + 2 * h) * (C + kPad) * 2 +
         static_cast<size_t>(G::STAGES) * G::KT * (G::TN + kPad) * 2;
}

template <int C, typename Epi>
__device__ __forceinline__ void pair_conv(WeightRing& ring, uint32_t a, int a_row0, int n_rows,
                                          int k, int dil, const float* __restrict__ bias,
                                          Epi epi) {
  constexpr int SW = C + kPad;
  using G = PairGeometry<C>;
  const int half = (k - 1) / 2 * dil;
  if constexpr (!G::kWide) {
    gemm_rows<C, C, C, SW, false>(
        ring, a, 0, a_row0, n_rows, k,
        [&](int t, int& shift, int& col) {
          shift = t * dil - half;
          col = 0;
        },
        bias, epi);
  } else {
    constexpr int KC = C / 64;
    const auto step = [&](int i, int& shift, int& col) {
      shift = (i / KC) * dil - half;
      col = (i % KC) * 64;
    };
    for (int p = 0; p < C / G::PASS; ++p) {
      if constexpr (G::NS == 1) {
        gemm_rows_wgmma<SW, false, 1, 64, G::THREADS, G::STAGES>(
            ring, a, 0, a_row0, n_rows, k * KC, step, bias + p * G::PASS,
            [&](int r, int c, float v0, float v1) { epi(r, p * G::PASS + c, v0, v1); });
      } else {
        gemm_rows_wgmma<SW, false, G::NS, G::TN, G::THREADS, G::STAGES>(
            ring, a, 0, a_row0, n_rows, k * KC, step, bias + p * G::PASS,
            [&](int r, int c, const float2 (&v)[G::NS]) {
#pragma unroll
              for (int s = 0; s < G::NS; ++s) epi(r, p * G::PASS + s * 64 + c, v[s].x, v[s].y);
            });
      }
    }
  }
}

"""


def _split_sources(n: int, src) -> None:
    """Rewrites the copy ``src/mrf_pair.cuh`` (the pair's geometry, GEMM and
    kernel, which ``mrf_pair.cu`` includes) to passes of n columns."""
    path = src / "mrf_pair.cuh"
    text = path.read_text()
    start = text.index("template <int C>\nstruct PairGeometry")
    end = text.index("template <int MODE>\nusing PairState")
    ring = "ring_start<C, G::KT,"
    if text.count(ring) != 1:
        raise RuntimeError(f"{path}: no single '{ring}'")
    text = (text[:start] + SPLIT_SOURCE.replace("PASS_N", str(n)) + text[end:]).replace(
        ring, "ring_start<G::TN, G::KT,")
    path.write_text(text)


def build(variants: dict, src_dirs: dict) -> dict[str, ctypes.CDLL]:
    """One library of ``mrf_pair.cu`` per variant: a copy of the sources (this
    package's, or ``src_dirs[name]``), split to passes of n columns where n is
    given; all nvcc runs at once."""
    out = _build.BUILD_DIR / "ab"
    procs = {}
    for name, n in variants.items():
        src = out / f"pair_{name}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(src_dirs.get(name, _build.SRC_DIR), src)
        if n is not None:
            _split_sources(n, src)
        so = out / f"pair_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(src / "mrf_pair.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        fn = lib.svt_mrf_stage_unpacked
        fn.argtypes, fn.restype = _build._SIGNATURES["svt_mrf_stage_unpacked"], ctypes.c_int
        libs[name] = lib
    return libs


def _split_layout(n: int) -> dict:
    """The module functions a build of passes of n columns reads: its weight
    tiles [pass][tap][Cin / 64] of 64 x n, its block and its ring."""
    def conv_tiles(w):
        k, c, _ = w.shape
        if c <= 64:
            return K._tile_layout(w)
        m = min(n, c)
        tiles = w.reshape(k, c // 64, 64, c // m, m).permute(3, 0, 1, 2, 4)
        return K._tile_layout(tiles.reshape(-1, 64, m), wgmma=True)

    def smem_bytes(c, tile, h, d):
        rows = 64 if c >= 128 else c
        return ((2 * tile + 2 * (h * d + h) + 2 * h) * (c + K.MMA_PAD) * 2
                + K.MMA_STAGES * rows * (min(n, c) + K.MMA_PAD) * 2)

    return {"_conv_tiles": conv_tiles, "unpacked_smem_bytes": smem_bytes,
            "pair_geometry": lambda c: K.PairGeometry(512, K.MMA_STAGES)}


def main(rounds: int = 2, checkout: str | None = None) -> dict[str, dict[str, float]]:
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    cases = {}
    for shape in SHAPES:
        c = shape[2]
        br = [tuple((torch.randn(s, generator=gen, device=dev) * 0.03).bfloat16().float()
                    for s in ((3, k, c, c), (3, c), (3, k, c, c), (3, c))) for k in KS]
        x = (torch.randn(shape, generator=gen, device=dev) * 0.5).bfloat16()
        cases[str(shape)] = (x, br, K.mrf_stage_plain(x, br, KS, DIL, K.BF16))
    variants, src_dirs = dict(VARIANTS), {}
    if checkout:
        variants["other"] = None
        src_dirs["other"] = Path(checkout) / "smart_vocoder_torch" / "kernels" / "csrc"
    libs = build(variants, src_dirs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"unpacked stage pass widths  [{card}]", flush=True)
    times = {name: {label: [] for label in cases} for name in libs}
    real = {attr: getattr(K, attr) for attr in PATCHED}
    try:
        legs = list(libs.items())
        for r in range(rounds):  # each round in the other order
            for name, lib in (legs if r % 2 == 0 else legs[::-1]):
                for attr, fn in real.items():
                    setattr(K, attr, fn)
                if variants[name] is not None:
                    for attr, fn in _split_layout(variants[name]).items():
                        setattr(K, attr, fn)
                K.load_library = lambda lib=lib: lib
                row = []
                for label, (x, br, want) in cases.items():
                    packed = K.pack_mrf_stage(br, dev)

                    def call():
                        return K.mrf_stage_unpacked(x, br, KS, DIL, packed=packed)

                    err = (call().float() - want.float()).abs().max().item()
                    times[name][label].append(device_ms(call))
                    row.append(f"{label} {times[name][label][-1]:.3f} ms (err {err:.1e})")
                print(f"{name:5s} " + " | ".join(row), flush=True)
    finally:
        for attr, fn in real.items():
            setattr(K, attr, fn)
    results = {name: {label: statistics.median(v) for label, v in per.items()}
               for name, per in times.items()}
    for name, per in times.items():
        print(f"{name:5s} median (min-max) of {rounds}: " + " | ".join(
            f"{label} {results[name][label]:.3f} ({min(v):.3f}-{max(v):.3f})"
            for label, v in per.items()), flush=True)
    return results


if __name__ == "__main__":
    main(*map(int, sys.argv[1:2]), *sys.argv[2:3])
