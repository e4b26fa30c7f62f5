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
// Registers and shared memory per instantiation: PERF.md §6. The geometry,
// the pair's GEMM and the kernel are in mrf_pair.cuh, which the training
// backward's replay (mrf_train.cu) shares.

#include "mrf_pair.cuh"

namespace {

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
        cudaFuncSetAttribute(mrf_pair_mma_kernel<C, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        // the pair's conv1 and conv2 tiles lie one after the other
        mrf_pair_mma_kernel<C, false><<<grid, G::THREADS, smem, s>>>(
            cur, dst, acc, nullptr, w + woff + 2 * j * static_cast<size_t>(k) * C * C, b1, b2,
            T, tile, k, d, op, br.nb);
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
