// Helpers shared by the MRF kernels (mrf_stage.cu, mrf_train.cu): the rounding
// points of the precision modes, typed loads and stores, and the tiled
// convolution loop over a shared-memory operand. Included by each source, so
// everything here has internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename St>
__device__ __forceinline__ St from_f(float v) {
  if constexpr (std::is_same<St, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);  // exact: callers store bf16 values only
  }
}

// Rows [lo, hi) of a same-length dilated conv over the shared-memory operand
// `src` (row stride C + 1, its row 0 holding row `src_lo`): out[r][c] =
// bias[c] + sum_t sum_ci src[r + t*dil - (k-1)/2*dil][ci] * w[t][ci][c]
// (no bias for a null `bias`). Calls epi(r, c, value).
template <int C, typename St, typename Epi>
__device__ __forceinline__ void conv_rows(const St* __restrict__ src,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias, int k, int dil,
                                          int lo, int hi, Epi epi, int src_lo = 0) {
  constexpr int S = C + 1;
  constexpr int CG = C / kCM;
  constexpr int RG = kThreads / CG;
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const int c0 = cg * kCM;
  const int half = (k - 1) / 2 * dil;
  const float4 b4 = bias != nullptr ? *reinterpret_cast<const float4*>(bias + c0)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
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
      for (int i = 0; i < kRM; ++i) {
        base[i] = (min(r0 + rg + i * RG, hi - 1) + off - src_lo) * S;
      }
      const float* wt = w + static_cast<size_t>(t) * C * C + c0;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(wt + ci * C));
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          const float a = to_f(src[base[i] + ci]);
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

}  // namespace
