// The unpacked MRF stage on Hopper's tensor cores (sm_90a), plain C interface.
//
// svt_mrf_stage_unpacked replaces smart_vocoder_tpu/kernels/mrf.py:
// fused_mrf_stage for a bf16 x (BF16 mode: every conv operand, stored value
// and residual sum is a bf16 value, the branch sum f32), at C = 32, 64, 128
// and 256. An f32 x keeps f32 weights, which a product of bf16 pairs does not
// compute: it runs the FMA body of mrf_stage_fma.cu (svt_mrf_stage_unpacked_fma).
//
// One launch runs one residual pair of one branch, x_new = x +
// c2(lrelu(c1_d(lrelu(x)))), over time tiles with that pair's own halo
// (HA = h*d + h rows a side, at most 30), so the buffers fit at C = 256; a
// stage is n_branches * n_pairs launches, the branch states and the f32
// branch sum going through global memory (they live in L2 at the serving
// shapes). One block per (time tile, batch row), 16 warps (8 at C = 256):
// - opA holds lrelu(x) over tile + 2 HA rows as bf16, zeros outside [0, T);
// - conv1 is k row-shifted GEMMs over opA (tap t reads t*d - h*d rows
//   further); its epilogue rounds acc + bias to bf16, zeroes it outside
//   [0, T), applies the bf16 leaky and writes conv2's operand into opB
//   (tile + 2h rows);
// - conv2 is k GEMMs over opB; its epilogue rounds, adds the bf16 residual
//   (read from global memory at the output row) and rounds again, then writes
//   the next state, sets or adds the f32 branch sum, or writes
//   (sum + x) / n_branches for the stage's last pair.
//
// What bounds it on the card: arithmetic. A stage is 252*C*C FLOP a row:
// 0.53 ms at x (2, 64000, 128) and 0.14 ms at (1, 8192, 256) at 989 TFLOP/s,
// against ~0.1 ms of bytes. The MMA by channel count (helpers in mrf_mma.cuh):
// - C = 32: `mma.sync.m16n8k16`, both operands through `ldmatrix`, weight
//   tiles of 32 x 32 per tap, as stage 4;
// - C = 64: `wgmma.m64n64k16`, A from registers through `ldmatrix`, the weight
//   tile of 64 x 64 per tap through a shared-memory descriptor, as stage 3;
// - C = 128 and 256: the same `wgmma` body with N as one pass of C columns
//   (NS = C / 64 slices of m64n64k16 that share each A fragment), K in chunks
//   of 64: a ring tile is 64 input channels by C columns. C = 128: 16 warps,
//   64 accumulators a thread, ~10% faster than two 64-column passes that each
//   read A again; C = 256: 8 warps, 128 accumulators, ~12% faster than two
//   128-column passes on 16 warps (tools/ab_pair_pass.py, PERF.md §6).
// A warpgroup owns 64 rows of a GEMM, so tile + 2h <= 32 * warps: the tile is
// the largest of 240, 128, 64, 32 whose buffers fit (kernels/mrf.py:
// unpacked_tile mirrors smem_bytes): 240 at C <= 128, 64 at C = 256. The
// weights are packed once per weight set by the caller (kernels/mrf.py:
// pack_mrf_stage) and streamed through the cp.async ring (4 slots; 3 at
// C = 256).
// Registers and shared memory per instantiation: PERF.md §6.

#include "mrf_common.cuh"
#include "mrf_mma.cuh"

namespace {

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

template <int C>
__global__ void __launch_bounds__(PairGeometry<C>::THREADS, 1)
    mrf_pair_mma_kernel(const __nv_bfloat16* __restrict__ xin, __nv_bfloat16* __restrict__ xout,
                        float* __restrict__ acc, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ b1, const float* __restrict__ b2, int T,
                        int tile, int k, int d, int op, int nb) {
  constexpr int SW = C + kPad;
  using G = PairGeometry<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = (k - 1) / 2;
  const int HA = h * d + h;  // operand rows beyond the tile on each side
  const int LA = tile + 2 * HA, LB = tile + 2 * h;
  __nv_bfloat16* opA = reinterpret_cast<__nv_bfloat16*>(smem);  // local rows [0, LA)
  __nv_bfloat16* opB = opA + LA * SW;                            // rows [h*d, h*d + LB)
  WeightRing ring{w, smem_u32(opB + LB * SW), 2 * G::tiles(k), G::kWide ? 2 * G::tiles(k) : 0,
                  0};
  ring_start<C, G::KT, G::kWide || C == kWgmmaC, G::THREADS, G::STAGES>(ring);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - HA;  // global row of local row 0
  const size_t base = static_cast<size_t>(b) * T * C;
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
  // conv1 over local rows [h*d, h*d + LB); the ring's barrier orders the fill
  const uint32_t sA = smem_u32(opA), sB = smem_u32(opB);
  pair_conv<C>(ring, sA, h * d, LB, k, d, b1, [&](int rr, int c, float v0, float v1) {
    const int g = g0 + h * d + rr;
    const bool in = g >= 0 && g < T;
    put_lrelu<kBF16>(opB, 0, rr * SW + c, in ? store_as<kBF16>(v0) : 0.f,
                     in ? store_as<kBF16>(v1) : 0.f);
  });
  // conv2 over the tile's valid rows: local row HA + rr is opB row h + rr
  const int rows = min(tile, T - t0);
  pair_conv<C>(ring, sB, h, rows, k, 1, b2, [&](int rr, int c, float v0, float v1) {
    const size_t idx = base + static_cast<size_t>(t0 + rr) * C + c;
    const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xin + idx));
    float n[2] = {store_as<kBF16>(store_as<kBF16>(v0) + xr.x),
                  store_as<kBF16>(store_as<kBF16>(v1) + xr.y)};
    pair_output(op, nb, xout, acc, idx, n);
  });
}

template <int C>
int launch_pairs(const __nv_bfloat16* x, __nv_bfloat16* out, __nv_bfloat16* s0,
                 __nv_bfloat16* s1, float* acc, const __nv_bfloat16* w, const float* bias,
                 int B, int T, int tile, const Branches& br, int* n_launched, cudaStream_t s) {
  using G = PairGeometry<C>;
  const dim3 grid((T + tile - 1) / tile, B);
  return chain_pairs(
      x, out, s0, s1, bias, C, br, n_launched,
      [&](const __nv_bfloat16* cur, __nv_bfloat16* dst, int op, int k, int d, int j,
          size_t woff, const float* b1, const float* b2) {
        const int h = (k - 1) / 2;
        if (tile + 2 * h > G::MAX_ROWS) return cudaErrorInvalidValue;
        const size_t smem = smem_bytes<C>(tile, h, d);
        cudaFuncSetAttribute(mrf_pair_mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
        // the pair's conv1 and conv2 tiles lie one after the other
        mrf_pair_mma_kernel<C><<<grid, G::THREADS, smem, s>>>(
            cur, dst, acc, w + woff + 2 * j * static_cast<size_t>(k) * C * C, b1, b2, T, tile,
            k, d, op, br.nb);
        return cudaGetLastError();
      });
}

}  // namespace

// x, out, s0, s1: bf16 (B, T, C); acc: f32 (B, T, C) where nb > 1; w: the
// stage's bf16 tiles [branch][pair][conv1, conv2][tap][Cin / 64] (C >= 128;
// [tap] at C <= 64) as kernels/mrf.py:pack_mrf_weights lays them out; bias:
// f32 [branch][b1 of every pair, b2 of every pair][C].
extern "C" int svt_mrf_stage_unpacked(const void* x, void* out, void* s0, void* s1, float* acc,
                                      const void* w, const float* bias, int B, int T, int C,
                                      int tile, int nb, int k0, int k1, int k2, int np, int d0,
                                      int d1, int d2, int* n_launched, void* stream) {
  const Branches br{nb, {k0, k1, k2}, np, {d0, d1, d2}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;  // kernels launched: nb * np when all went
  cudaGetLastError();
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* sb0 = static_cast<__nv_bfloat16*>(s0);
  auto* sb1 = static_cast<__nv_bfloat16*>(s1);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
#define SVT_PAIR_CASE(CC) \
  case CC:                \
    return launch_pairs<CC>(xb, ob, sb0, sb1, acc, wb, bias, B, T, tile, br, n_launched, s);
  switch (C) {
    SVT_PAIR_CASE(32)
    SVT_PAIR_CASE(64)
    SVT_PAIR_CASE(128)
    SVT_PAIR_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SVT_PAIR_CASE
}
