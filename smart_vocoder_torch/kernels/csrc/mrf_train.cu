// Backward of one ResBlock1 branch of the MRF stage for Hopper (sm_90a), plain
// C interface.
//
// svt_mrf_branch_bwd replaces smart_vocoder_tpu/kernels/mrf_train.py:
// mrf_branch_bwd (_branch_bwd_kernel): given the stage input x and the
// cotangent g of one branch's output, it returns dx and the gradients of the
// branch's 2 * n_pairs convolutions (dw1, db1, dw2, db2, accumulated in f32).
// It computes the function of the TPU kernel, not its block structure.
//
// The forward saves only (x, weights), so the backward first replays the
// chain. The TPU kernel replays a whole branch in VMEM over a tile with a
// ~22-radius halo; a Hopper block has 227 KB of shared memory, where x, g,
// three x_j, three h_j and the gradients of such a tile do not fit at C = 128.
// So, like the forward (mrf_pair_kernel in mrf_stage_fma.cu), the work is cut per
// residual pair x_{j+1} = x_j + c2(lrelu(h_j)), h_j = c1_d(lrelu(x_j)), each
// with its own small halo:
//
//   replay_pair_kernel, j = 0 .. n-1: recomputes h_j (and x_{j+1}, except after
//     the last pair) from x_j and writes them to scratch that the wrapper
//     allocates. Nothing is kept from the forward pass.
//   bwd_pair_kernel, j = n-1 .. 0: from the cotangent dxb of x_{j+1},
//       dy = dxb                           (zero outside [0, T))
//       dw2[t] += lrelu(h_j)[. + t - r2]^T dy,   db2 += sum dy
//       dq = conv(dy, flip(w2)^T),  dh = dq * dlrelu(h_j)   (zero outside [0, T))
//       dw1[t] += lrelu(x_j)[. + (t - r2) d]^T dh,  db1 += sum dh
//       dp = conv_d(dh, flip(w1)^T),  dxb' = dxb + dp * dlrelu(x_j)
//     over a tile of rows; dy carries a halo of r1 + r2 = r2 (d + 1) rows and dh
//     one of r1 = r2 d (at most 30 and 25 rows for k = 11, d = 5). Only the
//     tile's own rows enter dw and db, so no row is counted twice.
//
// Blocks run in parallel, so where the TPU grid accumulates dw/db in revisited
// VMEM blocks, each block here adds its partial sums with f32 atomics into
// buffers the wrapper zeroed: one atomic per weight, tap and block (about
// 1/64-1/128 of the block's FMAs). The order of those additions changes from
// run to run, so dw/db are reproducible only to f32 summation order.
//
// Rounding points (bf16 x): every replayed conv output, dq, dp, dq * dlrelu(h)
// and dxb + dp * dlrelu(x) are rounded to bf16, as the TPU kernel's casts do;
// the dw/db products take those bf16 values and sum in f32. dlrelu(v) is 1 for
// v > 0, else the slope (bf16(0.1) for a bf16 x): v == 0 takes the slope.
//
// What bounds it on the card: arithmetic. One branch backward is the replay
// (5/6 of a forward), the dx convs and the dw products, ~2.8x the forward's
// FLOPs, against tensors of a few MB. All of it runs as f32 FMA loops on the
// CUDA cores (conv_rows for the convs, an 8 x 8 register tile per thread for
// the per-tap products); tensor cores are later work.

#include "mrf_common.cuh"

namespace {

// d/dv max(v, slope v): 1 for v > 0, else the slope (in x's own precision).
__device__ __forceinline__ float dleaky(float v, int mode) {
  return v > 0.f ? 1.f : (mode == kBF16 ? rbf(0.1f) : 0.1f);
}

// Rows [row0, row0 + rows) of the haloed (rows x C) tile of `src` that starts at
// global row g0, as conv operands lrelu(v) (or v itself with `raw`), zeros
// outside [0, T).
template <int C, typename St>
__device__ __forceinline__ void load_tile(St* __restrict__ dst, const void* __restrict__ src,
                                          size_t base, int g0, int rows, int T, int mode,
                                          bool raw) {
  constexpr int S = C + 1;
  constexpr bool kBf = std::is_same<St, __nv_bfloat16>::value;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C, g = g0 + r;
    const float v =
        (g >= 0 && g < T) ? load_act(src, base + static_cast<size_t>(g) * C + c, kBf) : 0.f;
    dst[r * S + c] = from_f<St>(raw ? v : operand(v, mode));
  }
}

// Replays one residual pair: writes h_j over the tile's rows and, unless
// `last`, x_{j+1}. Same arithmetic and rounding as mrf_pair_kernel.
template <int C, typename St>
__global__ void __launch_bounds__(kThreads)
    replay_pair_kernel(const void* __restrict__ xin, void* __restrict__ hout,
                       void* __restrict__ xout, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, int T, int tile, int k, int d, int last) {
  constexpr int S = C + 1;
  constexpr bool kBf = std::is_same<St, __nv_bfloat16>::value;
  constexpr int mode = kBf ? kBF16 : kF32;
  extern __shared__ __align__(16) unsigned char train_smem[];
  const int r2 = (k - 1) / 2, r1 = r2 * d;
  const int H2 = last ? 0 : r2;  // rows of h_j beyond the tile that conv2 reads
  const int HA = r1 + H2;
  St* opA = reinterpret_cast<St*>(train_smem);  // lrelu(x_j), rows [0, tile + 2*HA)
  St* opB = opA + (tile + 2 * HA) * S;          // lrelu(h_j), rows [r1, tile + 2*HA - r1)
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - HA;  // global row of local row 0
  const size_t base = static_cast<size_t>(b) * T * C;
  load_tile<C, St>(opA, xin, base, g0, tile + 2 * HA, T, mode, false);
  __syncthreads();
  conv_rows<C>(opA, w1, b1, k, d, r1, tile + 2 * HA - r1, [&](int r, int c, float v) {
    const int g = g0 + r;
    const bool inside = g >= 0 && g < T;
    const float xt = inside ? store(v, mode) : 0.f;
    opB[(r - r1) * S + c] = from_f<St>(operand(xt, mode));
    if (inside && r >= HA && r < HA + tile) {
      store_out(hout, base + static_cast<size_t>(g) * C + c, xt, kBf);
    }
  });
  if (last) return;
  __syncthreads();
  const int rows = min(tile, T - t0);
  conv_rows<C>(
      opB, w2, b2, k, 1, HA, HA + rows,
      [&](int r, int c, float v) {
        const size_t idx = base + static_cast<size_t>(g0 + r) * C + c;
        const float nx = store(store(v, mode) + load_act(xin, idx, kBf), mode);
        store_out(xout, idx, nx, kBf);
      },
      r1);
}

// gw[t][ci][co] += sum over the tile's rows r of A[r + t*dil][ci] * D[d_row0 + r][co]
// for every tap t: the weight gradient of one conv from its operand tile A
// (local row 0 = the first row tap 0 reads) and its output cotangent D.
// Each thread owns a TI x TI register tile of one tap's C x C matrix, strided
// over channels so a warp reads consecutive shared-memory words; where C x C
// has fewer tiles than the block has threads, the rows are split among
// thread groups. Every thread ends each tap with one atomic per element.
template <int C, typename St>
__device__ __forceinline__ void dw_taps(const St* __restrict__ A, int dil,
                                        const St* __restrict__ D, int d_row0, int rows, int k,
                                        float* __restrict__ gw) {
  constexpr int S = C + 1;
  constexpr int TI = C >= 64 ? 8 : 4;
  constexpr int N = C / TI;  // register tiles per side
  constexpr int NT = N * N;
  constexpr int SLOTS = NT < kThreads ? NT : kThreads;
  constexpr int RS = kThreads / SLOTS;  // row splits
  constexpr int PASSES = NT / SLOTS;
  const int slot = threadIdx.x % SLOTS, rs = threadIdx.x / SLOTS;
  for (int t = 0; t < k; ++t) {
    const St* At = A + t * dil * S;
    float* gt = gw + static_cast<size_t>(t) * C * C;
    for (int pass = 0; pass < PASSES; ++pass) {
      const int tix = pass * SLOTS + slot;
      const int jg = tix % N, ig = tix / N;
      float acc[TI][TI];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
#pragma unroll
        for (int j = 0; j < TI; ++j) acc[i][j] = 0.f;
      }
      for (int r = rs; r < rows; r += RS) {
        float a[TI], dv[TI];
#pragma unroll
        for (int i = 0; i < TI; ++i) a[i] = to_f(At[r * S + ig + i * N]);
#pragma unroll
        for (int j = 0; j < TI; ++j) dv[j] = to_f(D[(d_row0 + r) * S + jg + j * N]);
#pragma unroll
        for (int i = 0; i < TI; ++i) {
#pragma unroll
          for (int j = 0; j < TI; ++j) acc[i][j] = fmaf(a[i], dv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < TI; ++i) {
#pragma unroll
        for (int j = 0; j < TI; ++j) {
          atomicAdd(gt + (ig + i * N) * C + jg + j * N, acc[i][j]);
        }
      }
    }
  }
}

// gdb[c] += sum over rows [row0, row0 + rows) of D[.][c].
template <int C, typename St>
__device__ __forceinline__ void col_sums(const St* __restrict__ D, int row0, int rows,
                                         float* __restrict__ gdb) {
  constexpr int S = C + 1;
  constexpr int G = kThreads / C;  // row groups
  const int c = threadIdx.x % C, grp = threadIdx.x / C;
  float s = 0.f;
  for (int r = grp; r < rows; r += G) s += to_f(D[(row0 + r) * S + c]);
  atomicAdd(gdb + c, s);
}

// Backward of one residual pair over one tile (see the file comment).
// w1f / w2f are the tap-flipped, in/out-transposed weights.
template <int C, typename St>
__global__ void __launch_bounds__(kThreads)
    bwd_pair_kernel(const void* __restrict__ din, const void* __restrict__ xj,
                    const void* __restrict__ hj, void* __restrict__ dout,
                    const float* __restrict__ w1f, const float* __restrict__ w2f,
                    float* __restrict__ dw1, float* __restrict__ db1, float* __restrict__ dw2,
                    float* __restrict__ db2, int T, int tile, int k, int d) {
  constexpr int S = C + 1;
  constexpr bool kBf = std::is_same<St, __nv_bfloat16>::value;
  constexpr int mode = kBf ? kBF16 : kF32;
  extern __shared__ __align__(16) unsigned char train_smem[];
  const int r2 = (k - 1) / 2, r1 = r2 * d, HD = r1 + r2;
  // bufA: dy over global rows [t0 - HD, t0 + tile + HD); later lrelu(x_j) over
  //       [t0 - r1, t0 + tile + r1).
  // bufB: lrelu(h_j) over [t0 - r2, t0 + tile + r2); later dh over
  //       [t0 - r1, t0 + tile + r1).
  St* bufA = reinterpret_cast<St*>(train_smem);
  St* bufB = bufA + (tile + 2 * HD) * S;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const size_t base = static_cast<size_t>(b) * T * C;

  load_tile<C, St>(bufA, din, base, t0 - HD, tile + 2 * HD, T, mode, true);
  load_tile<C, St>(bufB, hj, base, t0 - r2, tile + 2 * r2, T, mode, false);
  __syncthreads();
  // rows at or beyond T hold zeros in dy, so the ragged tile needs no clipping
  dw_taps<C, St>(bufB, 1, bufA, HD, tile, k, dw2);
  col_sums<C, St>(bufA, HD, tile, db2);
  __syncthreads();

  const int g0 = t0 - HD;
  conv_rows<C>(bufA, w2f, nullptr, k, 1, r2, tile + 2 * HD - r2, [&](int r, int c, float v) {
    const int g = g0 + r;
    float dh = 0.f;
    if (g >= 0 && g < T) {
      const float h = load_act(hj, base + static_cast<size_t>(g) * C + c, kBf);
      dh = store(store(v, mode) * dleaky(h, mode), mode);
    }
    bufB[(r - r2) * S + c] = from_f<St>(dh);
  });
  __syncthreads();
  load_tile<C, St>(bufA, xj, base, t0 - r1, tile + 2 * r1, T, mode, false);
  __syncthreads();
  dw_taps<C, St>(bufA, d, bufB, r1, tile, k, dw1);
  col_sums<C, St>(bufB, r1, tile, db1);

  const int rows = min(tile, T - t0);
  conv_rows<C>(bufB, w1f, nullptr, k, d, r1, r1 + rows, [&](int r, int c, float v) {
    const size_t idx = base + static_cast<size_t>(t0 + r - r1) * C + c;
    const float dp = store(v, mode) * dleaky(load_act(xj, idx, kBf), mode);
    store_out(dout, idx, store(load_act(din, idx, kBf) + store(dp, mode), mode), kBf);
  });
}

struct BranchBwdArgs {
  const void *x, *g;
  void *dx, *xs, *hs, *dtmp;
  const float *w1, *b1, *w2, *b2, *w1f, *w2f;
  float *dw1, *db1, *dw2, *db2;
};

template <int C, typename St>
int launch_branch_bwd(const BranchBwdArgs& a, int B, int T, int tile, int k, int np,
                      const int* dil, int* n_launched, cudaStream_t s) {
  const dim3 grid((T + tile - 1) / tile, B);
  const size_t n = static_cast<size_t>(B) * T * C;  // elements of one (B, T, C) tensor
  const size_t wconv = static_cast<size_t>(k) * C * C;
  const int r2 = (k - 1) / 2;
  auto at = [n](void* p, int i) { return static_cast<void*>(static_cast<St*>(p) + i * n); };
  // x_0 = x; x_1 .. x_{np-1} and h_0 .. h_{np-1} in the wrapper's scratch
  auto state = [&](int j) { return j == 0 ? const_cast<void*>(a.x) : at(a.xs, j - 1); };

  for (int j = 0; j < np; ++j) {
    const int last = j == np - 1, r1 = r2 * dil[j], H2 = last ? 0 : r2;
    const size_t smem = sizeof(St) * (2 * static_cast<size_t>(tile) + 2 * (r1 + H2) + 2 * H2) *
                        (C + 1);
    cudaFuncSetAttribute(replay_pair_kernel<C, St>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    replay_pair_kernel<C, St><<<grid, kThreads, smem, s>>>(
        state(j), at(a.hs, j), last ? nullptr : state(j + 1), a.w1 + j * wconv, a.b1 + j * C,
        a.w2 + j * wconv, a.b2 + j * C, T, tile, k, dil[j], last);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*n_launched;
  }
  const void* cur = a.g;
  for (int j = np - 1; j >= 0; --j) {
    const int r1 = r2 * dil[j];
    void* dst = j == 0 ? a.dx : at(a.dtmp, (np - 1 - j) % 2);
    const size_t smem = sizeof(St) * (2 * static_cast<size_t>(tile) + 2 * (r1 + r2) + 2 * r1) *
                        (C + 1);
    cudaFuncSetAttribute(bwd_pair_kernel<C, St>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    bwd_pair_kernel<C, St><<<grid, kThreads, smem, s>>>(
        cur, state(j), at(a.hs, j), dst, a.w1f + j * wconv, a.w2f + j * wconv,
        a.dw1 + j * wconv, a.db1 + j * C, a.dw2 + j * wconv, a.db2 + j * C, T, tile, k, dil[j]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*n_launched;
    cur = dst;
  }
  return 0;
}

}  // namespace

// x, g: (B, T, C) in St (bf16 or f32); dx the same. xs: (np - 1, B, T, C), hs:
// (np, B, T, C), dtmp: (2, B, T, C) scratch in St. w1, w2, w1f, w2f: (np, k, C, C)
// f32, b1, b2: (np, C) f32. dw1, dw2: (np, k, C, C) f32 and db1, db2: (np, C) f32,
// zeroed by the caller. n_launched: kernels launched, 2 * np when all went.
extern "C" int svt_mrf_branch_bwd(const void* x, const void* g, void* dx, void* xs, void* hs,
                                  void* dtmp, const float* w1, const float* b1, const float* w2,
                                  const float* b2, const float* w1f, const float* w2f,
                                  float* dw1, float* db1, float* dw2, float* db2, int B, int T,
                                  int C, int tile, int k, int np, int d0, int d1, int d2,
                                  int is_bf16, int* n_launched, void* stream) {
  const BranchBwdArgs a{x, g, dx, xs, hs, dtmp, w1, b1, w2, b2, w1f, w2f, dw1, db1, dw2, db2};
  const int dil[3] = {d0, d1, d2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;
  cudaGetLastError();  // clear an earlier, unrelated error
#define SVT_BWD_CASE(CC)                                                                       \
  case CC:                                                                                     \
    return is_bf16 ? launch_branch_bwd<CC, __nv_bfloat16>(a, B, T, tile, k, np, dil,           \
                                                          n_launched, s)                       \
                   : launch_branch_bwd<CC, float>(a, B, T, tile, k, np, dil, n_launched, s);
  switch (C) {
    SVT_BWD_CASE(32)
    SVT_BWD_CASE(64)
    SVT_BWD_CASE(128)
    SVT_BWD_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SVT_BWD_CASE
}
