// Fused HiFi-GAN MRF decoder stages for Hopper (sm_90a), plain C interface.
//
// svt_mrf_stage replaces smart_vocoder_tpu/kernels/mrf.py:fused_mrf_stage_packed
// (decoder stage 3); svt_up_mrf_stage replaces fused_up_mrf_stage (stage 4:
// lrelu -> ConvTranspose1d -> MRF -> optional lrelu(0.01) -> conv_post -> tanh).
// Both compute the function of the TPU kernels, not their block structure.
//
// One block per (time tile, batch row). The block keeps its tile plus a halo
// of R rows on each side in shared memory as f32, with zeros outside [0, T),
// and runs the branches one after another: for each residual pair, conv1
// reads the operand buffer opA and writes lrelu(conv1) as the operand of
// conv2 into opB; conv2 adds into the branch state xb and writes the next
// operand into opA. Every conv output is zeroed outside [0, T) (the TPU
// kernels' validity mask). Each conv computes only the rows that later convs
// still need (the valid region shrinks by the conv's radius), so no read
// falls outside what was written. The last conv of a branch adds xb into an
// f32 accumulator over the central rows; the block writes acc / n_branches.
//
// What bounds it on the card: arithmetic. Stage 3 at B=32 x 1000 frames is
// ~4.2 TFLOP and stage 4 ~2.1 TFLOP; the tensors they read and write are
// ~50 MB, so the stage is compute-bound by three orders of magnitude. This
// first version runs the convolutions as f32 FMA loops on the CUDA cores
// (67 TFLOP/s peak at 700 W, far below the 989 TFLOP/s of bf16 tensor
// cores): each thread owns 8 rows x 4 output channels, reads its weights as
// one float4 through L1/L2 and its activations from shared memory with a
// padded row stride (C + 1 floats), which keeps the per-warp reads free of
// bank conflicts. The halo (R = 60 for kernel sizes 3/7/11, dilations
// 1/3/5) costs ~1.3x redundant work at a 128-row tile. Tensor cores (wgmma
// on bf16 operands, two passes for the hi/lo modes), TMA loads and
// pipelining are later work.
//
// Precision modes (mode):
//   0 BF16         operands, stored intermediates, residual sums and output
//                  are bf16; the leaky slope and its product too.
//   1 F32_STORAGE  f32 storage and output; each conv operand rounded to bf16.
//   2 F32          no activation rounding (the JAX f32 and hi/lo modes).
// Weights and biases arrive already rounded by the wrapper, as f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRM = 8;  // output rows per thread per pass
constexpr int kCM = 4;  // output channels per thread (one float4 of weights)
constexpr int kBF16 = 0, kF32Storage = 1;

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max(v, slope * v); in bf16 mode the slope and the product are bf16, as JAX
// evaluates `x * 0.1` on a bf16 array.
__device__ __forceinline__ float leaky(float v, float slope, int mode) {
  return mode == kBF16 ? fmaxf(v, rbf(v * rbf(slope))) : fmaxf(v, v * slope);
}

// The conv operand lrelu(v) of a stored value v.
__device__ __forceinline__ float operand(float v, int mode) {
  const float a = leaky(v, 0.1f, mode);
  return mode == kF32Storage ? rbf(a) : a;
}

__device__ __forceinline__ float store(float v, int mode) {
  return mode == kBF16 ? rbf(v) : v;
}

__device__ __forceinline__ float load_act(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_out(void* p, size_t i, float v, int is_bf16) {
  if (is_bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Rows [lo, hi) of a same-length dilated conv over the shared-memory operand
// `src` (row stride C + 1): out[r][c] = bias[c] + sum_t sum_ci
// src[r + t*dil - (k-1)/2*dil][ci] * w[t][ci][c]. Calls epi(r, c, value).
template <int C, typename Epi>
__device__ __forceinline__ void conv_rows(const float* __restrict__ src,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias, int k, int dil,
                                          int lo, int hi, Epi epi) {
  constexpr int S = C + 1;
  constexpr int CG = C / kCM;
  constexpr int RG = kThreads / CG;
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const int c0 = cg * kCM;
  const int half = (k - 1) / 2 * dil;
  const float4 b4 = *reinterpret_cast<const float4*>(bias + c0);
  for (int r0 = lo; r0 < hi; r0 += RG * kRM) {
    float acc[kRM][kCM];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int j = 0; j < kCM; ++j) acc[i][j] = 0.f;
    }
    int base[kRM];
    for (int t = 0; t < k; ++t) {
      const int off = t * dil - half;
#pragma unroll
      for (int i = 0; i < kRM; ++i) base[i] = (min(r0 + rg + i * RG, hi - 1) + off) * S;
      const float* wt = w + static_cast<size_t>(t) * C * C + c0;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(wt + ci * C));
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          const float a = src[base[i] + ci];
          acc[i][0] = fmaf(a, w4.x, acc[i][0]);
          acc[i][1] = fmaf(a, w4.y, acc[i][1]);
          acc[i][2] = fmaf(a, w4.z, acc[i][2]);
          acc[i][3] = fmaf(a, w4.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = r0 + rg + i * RG;
      if (r < hi) {
        epi(r, c0 + 0, acc[i][0] + b4.x);
        epi(r, c0 + 1, acc[i][1] + b4.y);
        epi(r, c0 + 2, acc[i][2] + b4.z);
        epi(r, c0 + 3, acc[i][3] + b4.w);
      }
    }
  }
}

struct Branches {
  int nb, k[3], np, d[3];
};

// Runs every branch over the block's buffers and adds each branch output
// over rows [acc_lo, acc_lo + acc_rows) into acc. `fill(lo, hi)` writes the
// stage input rows [lo, hi) into xb and its operand into opA (no sync).
template <int C, typename Fill>
__device__ void run_branches(float* xb, float* opA, float* opB, float* acc, int acc_lo,
                             int acc_rows, int g0, int T, const float* __restrict__ w,
                             const float* __restrict__ bias, const Branches& br, int mode,
                             Fill fill) {
  constexpr int S = C + 1;
  size_t woff = 0, boff = 0;
  for (int b = 0; b < br.nb; ++b) {
    const int k = br.k[b], h = (k - 1) / 2;
    int rb = 0;
    for (int j = 0; j < br.np; ++j) rb += h * br.d[j] + h;
    int lo = acc_lo - rb, hi = acc_lo + acc_rows + rb;
    fill(lo, hi);
    __syncthreads();
    const size_t wconv = static_cast<size_t>(k) * C * C;
    const float* w1 = w + woff;
    const float* w2 = w1 + br.np * wconv;
    const float* b1 = bias + boff;
    const float* b2 = b1 + br.np * C;
    for (int j = 0; j < br.np; ++j) {
      lo += h * br.d[j];
      hi -= h * br.d[j];
      conv_rows<C>(opA, w1 + j * wconv, b1 + j * C, k, br.d[j], lo, hi,
                   [&](int r, int c, float v) {
                     const int g = g0 + r;
                     const float xt = (g >= 0 && g < T) ? store(v, mode) : 0.f;
                     opB[r * S + c] = operand(xt, mode);
                   });
      __syncthreads();
      lo += h;
      hi -= h;
      const bool last = j == br.np - 1;
      conv_rows<C>(opB, w2 + j * wconv, b2 + j * C, k, 1, lo, hi,
                   [&](int r, int c, float v) {
                     const int g = g0 + r;
                     const float xt = (g >= 0 && g < T) ? store(v, mode) : 0.f;
                     const float nx = store(xt + xb[r * S + c], mode);
                     xb[r * S + c] = nx;
                     if (last) {
                       acc[(r - acc_lo) * C + c] += nx;
                     } else {
                       opA[r * S + c] = operand(nx, mode);
                     }
                   });
      __syncthreads();
    }
    woff += 2 * br.np * wconv;
    boff += 2 * br.np * C;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    mrf_stage_kernel(const void* __restrict__ x, void* __restrict__ out,
                     const float* __restrict__ w, const float* __restrict__ bias, int T,
                     int tile, int R, Branches br, int mode, int in_bf16) {
  constexpr int S = C + 1;
  extern __shared__ float smem[];
  const int L = tile + 2 * R;
  float* xb = smem;
  float* opA = xb + L * S;
  float* opB = opA + L * S;
  float* acc = opB + L * S;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - R;  // global row of buffer row 0
  for (int i = threadIdx.x; i < tile * C; i += kThreads) acc[i] = 0.f;
  const size_t xbase = static_cast<size_t>(b) * T * C;

  run_branches<C>(xb, opA, opB, acc, R, tile, g0, T, w, bias, br, mode,
                  [&](int lo, int hi) {
                    for (int i = threadIdx.x; i < (hi - lo) * C; i += kThreads) {
                      const int r = lo + i / C, c = i % C, g = g0 + r;
                      const float v = (g >= 0 && g < T)
                                          ? load_act(x, xbase + static_cast<size_t>(g) * C + c,
                                                     in_bf16)
                                          : 0.f;
                      xb[r * S + c] = v;
                      opA[r * S + c] = operand(v, mode);
                    }
                  });

  for (int i = threadIdx.x; i < tile * C; i += kThreads) {
    const int g = t0 + i / C;
    if (g < T) {
      store_out(out, xbase + static_cast<size_t>(t0) * C + i, acc[i] / br.nb, mode == kBF16);
    }
  }
}

template <int CIN, int C>
__global__ void __launch_bounds__(kThreads)
    up_mrf_stage_kernel(const void* __restrict__ u, void* __restrict__ out,
                        const float* __restrict__ wup, const float* __restrict__ bup,
                        const float* __restrict__ w, const float* __restrict__ bias,
                        const float* __restrict__ wpost, int Tu, int tile, int H, int kup,
                        int sup, int pup, int kpost, Branches br, int mode, int in_bf16) {
  constexpr int S = C + 1;
  constexpr int SU = CIN + 1;
  extern __shared__ float smem[];
  const int T = Tu * sup;
  const int P = kpost > 0 ? (kpost - 1) / 2 : 0;
  const int L = tile + 2 * H;
  float* x0 = smem;
  float* xb = x0 + L * S;
  float* opA = xb + L * S;
  float* opB = opA + L * S;
  float* acc = opB + L * S;
  float* ubuf = opA;  // the u tile lives in opA/opB until the branches start
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - H;
  const int acc_rows = tile + 2 * P;
  for (int i = threadIdx.x; i < acc_rows * C; i += kThreads) acc[i] = 0.f;

  // u rows feeding output rows [g0, g0 + L): m in [m_lo, m_hi].
  const int m_lo = -floor_div(-(g0 + pup - kup + 1), sup);
  const int m_hi = floor_div(g0 + L - 1 + pup, sup);
  const size_t ubase = static_cast<size_t>(b) * Tu * CIN;
  for (int i = threadIdx.x; i < (m_hi - m_lo + 1) * CIN; i += kThreads) {
    const int m = m_lo + i / CIN, ci = i % CIN;
    const float v = (m >= 0 && m < Tu)
                        ? load_act(u, ubase + static_cast<size_t>(m) * CIN + ci, in_bf16)
                        : 0.f;
    ubuf[(m - m_lo) * SU + ci] = operand(v, mode);
  }
  __syncthreads();

  // Transposed conv: x[n][c] = bup[c] + sum_{m, t: n = m*s - p + t} u'[m][ci] wup[t][ci][c].
  {
    constexpr int CG = C / kCM;
    constexpr int RG = kThreads / CG;
    const int cg = threadIdx.x % CG, c0 = cg * kCM;
    const float4 b4 = *reinterpret_cast<const float4*>(bup + c0);
    for (int r = threadIdx.x / CG; r < L; r += RG) {
      const int n = g0 + r;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      const int mh = floor_div(n + pup, sup);
      for (int m = mh, t = n + pup - mh * sup; t < kup; --m, t += sup) {
        const float* urow = ubuf + (m - m_lo) * SU;
        const float* wt = wup + static_cast<size_t>(t) * CIN * C + c0;
#pragma unroll 8
        for (int ci = 0; ci < CIN; ++ci) {
          const float a = urow[ci];
          const float4 w4 = __ldg(reinterpret_cast<const float4*>(wt + ci * C));
          a0 = fmaf(a, w4.x, a0);
          a1 = fmaf(a, w4.y, a1);
          a2 = fmaf(a, w4.z, a2);
          a3 = fmaf(a, w4.w, a3);
        }
      }
      const bool valid = n >= 0 && n < T;
      x0[r * S + c0 + 0] = valid ? store(a0 + b4.x, mode) : 0.f;
      x0[r * S + c0 + 1] = valid ? store(a1 + b4.y, mode) : 0.f;
      x0[r * S + c0 + 2] = valid ? store(a2 + b4.z, mode) : 0.f;
      x0[r * S + c0 + 3] = valid ? store(a3 + b4.w, mode) : 0.f;
    }
  }
  __syncthreads();

  run_branches<C>(xb, opA, opB, acc, H - P, acc_rows, g0, T, w, bias, br, mode,
                  [&](int lo, int hi) {
                    for (int i = threadIdx.x; i < (hi - lo) * C; i += kThreads) {
                      const int r = lo + i / C, c = i % C;
                      const float v = x0[r * S + c];
                      xb[r * S + c] = v;
                      opA[r * S + c] = operand(v, mode);
                    }
                  });

  const size_t obase = static_cast<size_t>(b) * T;
  if (kpost == 0) {
    for (int i = threadIdx.x; i < tile * C; i += kThreads) {
      const int g = t0 + i / C;
      if (g < T) store_out(out, (obase + t0) * C + i, acc[i] / br.nb, mode == kBF16);
    }
    return;
  }
  // Decoder tail over the stage result rows [H - P, H + tile + P): the
  // branches computed them exactly, so conv_post sees real neighbours.
  float* z = opA;
  for (int i = threadIdx.x; i < acc_rows * C; i += kThreads) {
    const float res = store(acc[i] / br.nb, mode);
    z[(i / C) * S + i % C] = leaky(res, 0.01f, mode);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < tile; o += kThreads) {
    const int g = t0 + o;
    if (g >= T) continue;
    float y = 0.f;
    for (int t = 0; t < kpost; ++t) {
      const float* zr = z + (o + t) * S;
      const float* wt = wpost + t * C;
#pragma unroll 8
      for (int c = 0; c < C; ++c) y = fmaf(zr[c], __ldg(wt + c), y);
    }
    store_out(out, obase + g, tanhf(y), mode == kBF16);
  }
}

}  // namespace

extern "C" int svt_mrf_stage(const void* x, void* out, const float* w, const float* bias,
                             int B, int T, int C, int tile, int R, int nb, int k0, int k1,
                             int k2, int np, int d0, int d1, int d2, int mode, int in_bf16,
                             void* stream) {
  const Branches br{nb, {k0, k1, k2}, np, {d0, d1, d2}};
  const dim3 grid((T + tile - 1) / tile, B);
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(tile + 2 * R) * (C + 1) +
                                       static_cast<size_t>(tile) * C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear an earlier, unrelated error
#define SVT_MRF_CASE(CC)                                                                    \
  case CC:                                                                                  \
    cudaFuncSetAttribute(mrf_stage_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         static_cast<int>(smem));                                           \
    mrf_stage_kernel<CC><<<grid, kThreads, smem, s>>>(x, out, w, bias, T, tile, R, br,     \
                                                       mode, in_bf16);                      \
    break;
  switch (C) {
    SVT_MRF_CASE(32)
    SVT_MRF_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SVT_MRF_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svt_up_mrf_stage(const void* u, void* out, const float* wup, const float* bup,
                                const float* w, const float* bias, const float* wpost, int B,
                                int Tu, int Cin, int C, int kup, int sup, int pup, int tile,
                                int H, int kpost, int nb, int k0, int k1, int k2, int np,
                                int d0, int d1, int d2, int mode, int in_bf16, void* stream) {
  const Branches br{nb, {k0, k1, k2}, np, {d0, d1, d2}};
  const int T = Tu * sup;
  const int P = kpost > 0 ? (kpost - 1) / 2 : 0;
  const dim3 grid((T + tile - 1) / tile, B);
  const size_t smem = sizeof(float) * (4 * static_cast<size_t>(tile + 2 * H) * (C + 1) +
                                       static_cast<size_t>(tile + 2 * P) * C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
#define SVT_UP_CASE(CI, CC)                                                             \
  if (Cin == CI && C == CC) {                                                           \
    cudaFuncSetAttribute(up_mrf_stage_kernel<CI, CC>,                                   \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,                   \
                         static_cast<int>(smem));                                       \
    up_mrf_stage_kernel<CI, CC><<<grid, kThreads, smem, s>>>(                           \
        u, out, wup, bup, w, bias, wpost, Tu, tile, H, kup, sup, pup, kpost, br, mode,  \
        in_bf16);                                                                       \
    return static_cast<int>(cudaGetLastError());                                        \
  }
  SVT_UP_CASE(64, 32)
#undef SVT_UP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
