// One residual pair of the unpacked MRF stage on the tensor cores: the block
// geometry, its shared memory, the pair's GEMM and the pair kernel, shared by
// the stage (mrf_pair.cu) and the training backward's replay (mrf_train.cu).
// See mrf_pair.cu for the design and what bounds it.
#pragma once

#include "mrf_common.cuh"
#include "mrf_mma.cuh"

#include <type_traits>

namespace {

// What the replay's last pair does: write h_j only (no conv2, no next state).
constexpr int kHOnly = -1;

// The block and its ring by channel count (kernels/mrf.py:pair_geometry
// mirrors them). At C >= 128 a GEMM is one pass of all C columns, NS = C / 64
// slices of m64n64k16, over ring tiles of 64 input channels by C: at C = 256
// its 128 accumulators a thread need 8 warps (255 registers), and the 33 KB
// slots leave room for 3.
template <int C>
struct PairGeometry {
  static constexpr bool kWide = C >= 128;
  static constexpr int THREADS = C == 256 ? 256 : kMmaThreads;
  static constexpr int NS = kWide ? C / 64 : 1;
  static constexpr int KT = kWide ? 64 : C;        // ring tile rows
  static constexpr int STAGES = C == 256 ? 3 : kStages;
  static constexpr int MAX_ROWS = THREADS / 2;     // rows its warpgroups cover
  // ring tiles of one conv with k taps
  __host__ __device__ static constexpr int tiles(int k) { return kWide ? k * (C / 64) : k; }
};

// Shared memory of one block, in bytes: the two bf16 operand buffers and the
// ring (kernels/mrf.py:unpacked_smem_bytes mirrors it).
template <int C>
constexpr size_t smem_bytes(int tile, int h, int d) {
  using G = PairGeometry<C>;
  return static_cast<size_t>(2 * tile + 2 * (h * d + h) + 2 * h) * (C + kPad) * 2 +
         static_cast<size_t>(G::STAGES) * G::KT * (C + kPad) * 2;
}

// One GEMM of the pair over the operand buffer at `a`: k taps of dilation
// `dil`, output rows [0, n_rows) reading buffer rows from a_row0; epi(r, c,
// v0, v1) for output row r, columns c, c + 1.
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
    gemm_rows_wgmma<SW, false, G::NS, C, G::THREADS, G::STAGES>(
        ring, a, 0, a_row0, n_rows, k * KC,
        [&](int i, int& shift, int& col) {
          shift = (i / KC) * dil - half;
          col = (i % KC) * 64;
        },
        bias, [&](int r, int c, const float2 (&v)[G::NS]) {
#pragma unroll
          for (int s = 0; s < G::NS; ++s) epi(r, s * 64 + c, v[s].x, v[s].y);
        });
  }
}

// The state type of a mode: bf16 values in BF16 mode; f32 in F32_STORAGE
// mode, whose conv operands alone are rounded to bf16.
template <int MODE>
using PairState = std::conditional_t<MODE == kBF16, __nv_bfloat16, float>;

// One residual pair over one time tile in MODE (BF16 or F32_STORAGE). REPLAY
// (the training backward's replay, mrf_train.cu; BF16 only) also writes
// conv1's masked output h_j over the tile's own rows to `hout`, and with
// op == kHOnly stops there.
template <int C, bool REPLAY, int MODE>
__device__ __forceinline__ void mrf_pair_body(const PairState<MODE>* __restrict__ xin,
                                              PairState<MODE>* __restrict__ xout,
                                              float* __restrict__ acc,
                                              __nv_bfloat16* __restrict__ hout,
                                              const __nv_bfloat16* __restrict__ w,
                                              const float* __restrict__ b1,
                                              const float* __restrict__ b2, int T, int tile,
                                              int k, int d, int op, int nb) {
  static_assert(MODE == kBF16 || (MODE == kF32Storage && !REPLAY), "BF16 or F32_STORAGE");
  constexpr int SW = C + kPad;
  using G = PairGeometry<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = (k - 1) / 2;
  const int HA = h * d + h;  // operand rows beyond the tile on each side
  const int LA = tile + 2 * HA, LB = tile + 2 * h;
  __nv_bfloat16* opA = reinterpret_cast<__nv_bfloat16*>(smem);  // local rows [0, LA)
  __nv_bfloat16* opB = opA + LA * SW;                            // rows [h*d, h*d + LB)
  // the ring holds conv1's and conv2's tiles, or conv1's alone for kHOnly
  const int n_convs = REPLAY && op == kHOnly ? 1 : 2;
  WeightRing ring{w, smem_u32(opB + LB * SW), n_convs * G::tiles(k),
                  G::kWide ? n_convs * G::tiles(k) : 0, 0};
  ring_start<C, G::KT, G::kWide || C == kWgmmaC, G::THREADS, G::STAGES>(ring);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - HA;  // global row of local row 0
  const size_t base = static_cast<size_t>(b) * T * C;
  if constexpr (MODE == kBF16) {
    for (int i = threadIdx.x; i < LA * (C / 8); i += G::THREADS) {
      const int r = i / (C / 8), c = (i % (C / 8)) * 8, g = g0 + r;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (g >= 0 && g < T) {
        raw = *reinterpret_cast<const uint4*>(xin + base + static_cast<size_t>(g) * C + c);
      }
      const uint32_t wds[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        put_lrelu<kBF16>(opA, 0, r * SW + c + 2 * e, __uint_as_float(wds[e] << 16),
                         __uint_as_float(wds[e] & 0xFFFF0000u));
      }
    }
  } else {
    // f32 rows from device memory (the state outgrows L2 at the batch
    // shapes): kLoads 16-byte loads in flight a thread before their operands
    // are written
    constexpr int CPR = C / 4, kLoads = 4;
    const int n = LA * CPR;
    for (int i0 = threadIdx.x; i0 < n; i0 += kLoads * G::THREADS) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * G::THREADS, g = g0 + i / CPR;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < n && g >= 0 && g < T) {
          v[u] = __ldg(reinterpret_cast<const float4*>(xin + base + static_cast<size_t>(g) * C +
                                                       (i % CPR) * 4));
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * G::THREADS;
        if (i < n) {
          const int idx = (i / CPR) * SW + (i % CPR) * 4;
          put_lrelu<kF32Storage>(opA, 0, idx, v[u].x, v[u].y);
          put_lrelu<kF32Storage>(opA, 0, idx + 2, v[u].z, v[u].w);
        }
      }
    }
  }
  // conv1 over local rows [h*d, h*d + LB); the ring's barrier orders the fill
  const uint32_t sA = smem_u32(opA), sB = smem_u32(opB);
  pair_conv<C>(ring, sA, h * d, LB, k, d, b1, [&](int rr, int c, float v0, float v1) {
    const int g = g0 + h * d + rr;
    const bool in = g >= 0 && g < T;
    const float h0 = in ? store_as<MODE>(v0) : 0.f, h1 = in ? store_as<MODE>(v1) : 0.f;
    put_lrelu<MODE>(opB, 0, rr * SW + c, h0, h1);
    if constexpr (REPLAY) {
      if (in && rr >= h && rr < h + tile) {
        *reinterpret_cast<__nv_bfloat162*>(hout + base + static_cast<size_t>(g) * C + c) =
            __floats2bfloat162_rn(h0, h1);
      }
    }
  });
  if constexpr (REPLAY) {
    if (op == kHOnly) return;
  }
  // conv2 over the tile's valid rows: local row HA + rr is opB row h + rr
  const int rows = min(tile, T - t0);
  pair_conv<C>(ring, sB, h, rows, k, 1, b2, [&](int rr, int c, float v0, float v1) {
    const size_t idx = base + static_cast<size_t>(t0 + rr) * C + c;
    float2 xr;
    if constexpr (MODE == kBF16) {
      xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xin + idx));
    } else {
      xr = *reinterpret_cast<const float2*>(xin + idx);
    }
    float n[2] = {store_as<MODE>(store_as<MODE>(v0) + xr.x),
                  store_as<MODE>(store_as<MODE>(v1) + xr.y)};
    pair_output(op, nb, xout, acc, idx, n);
  });
}

// The pair in BF16 mode: the stage of a bf16 x, and the training replay.
template <int C, bool REPLAY>
__global__ void __launch_bounds__(PairGeometry<C>::THREADS, 1)
    mrf_pair_mma_kernel(const __nv_bfloat16* __restrict__ xin, __nv_bfloat16* __restrict__ xout,
                        float* __restrict__ acc, __nv_bfloat16* __restrict__ hout,
                        const __nv_bfloat16* __restrict__ w, const float* __restrict__ b1,
                        const float* __restrict__ b2, int T, int tile, int k, int d, int op,
                        int nb) {
  mrf_pair_body<C, REPLAY, kBF16>(xin, xout, acc, hout, w, b1, b2, T, tile, k, d, op, nb);
}

// The pair in F32_STORAGE mode: f32 x, states, branch sum and output, each
// conv operand rounded once to bf16 (mrf_pair.cu, svt_mrf_stage_unpacked_f32s).
template <int C>
__global__ void __launch_bounds__(PairGeometry<C>::THREADS, 1)
    mrf_pair_f32s_kernel(const float* __restrict__ xin, float* __restrict__ xout,
                         float* __restrict__ acc, const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ b1, const float* __restrict__ b2, int T,
                         int tile, int k, int d, int op, int nb) {
  mrf_pair_body<C, false, kF32Storage>(xin, xout, acc, nullptr, w, b1, b2, T, tile, k, d, op,
                                       nb);
}

}  // namespace
