// Helpers shared by the MRF kernels (mrf_stage.cu, mrf_pair.cu,
// mrf_stage_fma.cu, mrf_train.cu, wn_stack.cu): the rounding points of the
// precision modes, typed loads and stores, the tiled FMA convolution loop over
// a shared-memory operand, and the unpacked stage's chaining of pairs.
// Included by each source, so everything here has internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRM = 8;  // output rows per thread per pass
constexpr int kCM = 4;  // output channels per thread (one float4 of weights)
constexpr int kBF16 = 0, kF32Storage = 1, kF32 = 2;  // precision modes

// One MRF stage: nb branches of kernel sizes k[], each np residual pairs of
// dilations d[].
struct Branches {
  int nb, k[3], np, d[3];
};

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

// The unpacked MRF stage (fused_mrf_stage) runs one residual pair of one
// branch per launch (mrf_pair.cu on the tensor cores, mrf_stage_fma.cu on
// f32). What a pair does with its output: write the next branch state, set or
// add the f32 branch sum in branch order, as the TPU kernel's accumulator
// does, or, for the stage's last pair, write (sum + x) / n_branches.
enum PairOp { kState = 0, kAccSet = 1, kAccAdd = 2, kOut = 3 };

// V consecutive values at p (one, or two as one vector access).
template <int V>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[V]) {
  if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vals(float* p, const float (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_vals(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// The pair's new state n (V consecutive values at idx of the (B, T, C)
// tensors) as the PairOp op says.
template <int V, typename St>
__device__ __forceinline__ void pair_output(int op, int nb, St* __restrict__ xout,
                                            float* __restrict__ acc, size_t idx, float (&n)[V]) {
  float a[V];
  switch (op) {
    case kState:
      store_vals(xout + idx, n);
      break;
    case kAccSet:
      store_vals(acc + idx, n);
      break;
    case kAccAdd:
      load_vals(acc + idx, a);
#pragma unroll
      for (int e = 0; e < V; ++e) a[e] += n[e];
      store_vals(acc + idx, a);
      break;
    default:
      if (nb > 1) {
        load_vals(acc + idx, a);
#pragma unroll
        for (int e = 0; e < V; ++e) n[e] = a[e] + n[e];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) n[e] = n[e] / nb;
      store_vals(xout + idx, n);
  }
}

// A stage as nb * np launches of a one-pair kernel, in the TPU kernel's
// order: pair j of a branch reads the branch state (x for j = 0) and writes
// the next (s0 and s1 in turn), or, for the branch's last pair, sets or adds
// the f32 sum or writes the stage output. launch(cur, dst, op, k, d, j, woff,
// b1, b2) launches pair j of a branch of kernel size k, woff counting the
// weight elements of the branches before it, and returns its error; *n_launched
// counts the launches that went.
template <typename T, typename Launch>
int chain_pairs(const T* x, T* out, T* s0, T* s1, const float* bias, int C, const Branches& br,
                int* n_launched, Launch launch) {
  size_t woff = 0, boff = 0;
  for (int i = 0; i < br.nb; ++i) {
    const int k = br.k[i];
    const T* cur = x;
    for (int j = 0; j < br.np; ++j) {
      const bool last = j == br.np - 1;
      const int op = !last ? kState : i == br.nb - 1 ? kOut : i == 0 ? kAccSet : kAccAdd;
      T* dst = !last ? (j % 2 == 0 ? s0 : s1) : out;
      const cudaError_t err = launch(cur, dst, op, k, br.d[j], j, woff, bias + boff + j * C,
                                     bias + boff + (br.np + j) * C);
      if (err != cudaSuccess) return static_cast<int>(err);
      ++*n_launched;
      cur = dst;
    }
    woff += 2 * static_cast<size_t>(br.np) * k * C * C;
    boff += 2 * br.np * C;
  }
  return 0;
}

}  // namespace
