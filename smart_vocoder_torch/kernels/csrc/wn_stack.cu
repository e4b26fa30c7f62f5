// Fused WN (WaveNet-gate) layers for Hopper (sm_90a), plain C interface.
//
// svt_wn_stack replaces smart_vocoder_tpu/kernels/wn_stack.py:fused_wn_stack
// (_wn_kernel): one launch runs one chunk of up to `layers_per_call` WN
// layers of an unconditioned stack (the prior's 16 layers, each flow step's
// 8), as one pallas_call does. Per layer: the k=5 conv H -> 2H plus bias,
// tanh(a) * sigmoid(b), the 1x1 res/skip conv, x = (x + res) * mask, and the
// skip summed in f32 over the chunk. The row packing by 2 and the column
// permutations of the TPU kernel are lane tricks and are not carried over.
//
// One block per (time tile, batch row). The block keeps its tile plus a halo
// of 2 rows per layer of the chunk in shared memory as f32: the state x, the
// gate output, the mask and the f32 skip sum of the tile's own rows. Layer j
// computes rows [2(j+1), L - 2(j+1)) of the haloed buffer, so the last layer
// ends exactly on the tile and no read leaves the written region. Rows
// outside [0, T) hold x = 0 and mask = 0, which is the zero padding of the
// TPU kernel; the update (x + res) * mask keeps them at 0.
//
// What bounds it on the card: arithmetic. A layer is ~0.89 MFLOP per time
// step (5*192*384 + 192*384 multiply-adds), the 48 layers of the prior and
// the flow ~1.4 TFLOP per B=32 x 1000-frame step, on ~25 MB of activations
// per layer. This first version runs f32 FMA loops on the CUDA cores: each
// thread owns kRM rows x 4 channels of both gate halves (or of res and skip),
// reads its weights as float4 through L1/L2 (__ldg; one layer's weights,
// 5*192*384 values, do not fit in shared memory) and its activations from
// shared memory with a padded row stride. Tensor cores are later work.
//
// Precision (is_bf16): the JAX kernel's rounding points, in x.dtype:
//   weights and biases arrive rounded to x.dtype (as f32 values);
//   each conv accumulates in f32 and adds its bias in f32;
//   the gate output is rounded to bf16 before the 1x1 conv;
//   x = (x + bf16(res)) * mask is evaluated in bf16;
//   the skip sum is f32 within the chunk, rounded to bf16 at its end, and
//   summed across chunks in bf16 (skip_io holds the running sum).
// With is_bf16 = 0 nothing is rounded (the f32 mode).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 192;
constexpr int kRM = 10;  // output rows per thread per pass
constexpr int kTaps = 5;

__device__ __forceinline__ float rnd(float v, int is_bf16) {
  return is_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float load_act(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_act(void* p, size_t i, float v, int is_bf16) {
  if (is_bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// Rows [lo, hi) of a same-length conv with `taps` taps (dilation 1) from the
// shared-memory buffer src (row stride H + 1) to 2H outputs, weights
// w[t][ci][2H]. Each thread computes channels c0..c0+3 of both halves:
// epi(r, c, first-half value, second-half value), biases added.
template <int H, typename Epi>
__device__ __forceinline__ void conv_pairs(const float* __restrict__ src,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias, int taps, int lo,
                                           int hi, Epi epi) {
  constexpr int S = H + 1;
  constexpr int CG = H / 4;
  constexpr int RG = kThreads / CG;
  static_assert(kThreads % CG == 0, "threads must cover whole rows of channel groups");
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const int c0 = cg * 4;
  const int half = (taps - 1) / 2;
  const float4 ba = *reinterpret_cast<const float4*>(bias + c0);
  const float4 bb = *reinterpret_cast<const float4*>(bias + H + c0);
  for (int r0 = lo; r0 < hi; r0 += RG * kRM) {
    float a[kRM][4], b[kRM][4];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = b[i][j] = 0.f;
    }
    int base[kRM];
    for (int t = 0; t < taps; ++t) {
#pragma unroll
      for (int i = 0; i < kRM; ++i) base[i] = (min(r0 + rg + i * RG, hi - 1) + t - half) * S;
      const float* wt = w + static_cast<size_t>(t) * H * 2 * H + c0;
#pragma unroll 2
      for (int ci = 0; ci < H; ++ci) {
        const float4 wa = __ldg(reinterpret_cast<const float4*>(wt + ci * 2 * H));
        const float4 wb = __ldg(reinterpret_cast<const float4*>(wt + ci * 2 * H + H));
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          const float v = src[base[i] + ci];
          a[i][0] = fmaf(v, wa.x, a[i][0]);
          a[i][1] = fmaf(v, wa.y, a[i][1]);
          a[i][2] = fmaf(v, wa.z, a[i][2]);
          a[i][3] = fmaf(v, wa.w, a[i][3]);
          b[i][0] = fmaf(v, wb.x, b[i][0]);
          b[i][1] = fmaf(v, wb.y, b[i][1]);
          b[i][2] = fmaf(v, wb.z, b[i][2]);
          b[i][3] = fmaf(v, wb.w, b[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = r0 + rg + i * RG;
      if (r < hi) {
        epi(r, c0 + 0, a[i][0] + ba.x, b[i][0] + bb.x);
        epi(r, c0 + 1, a[i][1] + ba.y, b[i][1] + bb.y);
        epi(r, c0 + 2, a[i][2] + ba.z, b[i][2] + bb.z);
        epi(r, c0 + 3, a[i][3] + ba.w, b[i][3] + bb.w);
      }
    }
  }
}

// w_in: n_layers x (5, H, 2H) [tap][in][tanh half | sigmoid half];
// w_rs: n_layers x (H, 2H) [in][res half | skip half] (a skip-only layer
// arrives with a zero res half); biases n_layers x 2H.
template <int H>
__global__ void __launch_bounds__(kThreads)
    wn_stack_kernel(const void* __restrict__ xin, const float* __restrict__ mask,
                    void* __restrict__ xout, void* __restrict__ skip_io,
                    const float* __restrict__ w_in, const float* __restrict__ b_in,
                    const float* __restrict__ w_rs, const float* __restrict__ b_rs, int T,
                    int tile, int n_layers, int final_mask, int is_bf16) {
  constexpr int S = H + 1;
  extern __shared__ float smem[];
  const int R = 2 * n_layers;  // (k - 1) / 2 rows per layer
  const int L = tile + 2 * R;
  float* xs = smem;              // L x S: the state x
  float* acts = xs + L * S;      // L x S: the gate output
  float* skip = acts + L * S;    // tile x H: f32 skip sum of the tile's rows
  float* ms = skip + tile * H;   // L: the mask
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - R;
  const size_t xbase = static_cast<size_t>(b) * T * H;

  for (int i = threadIdx.x; i < L * H; i += kThreads) {
    const int r = i / H, c = i % H, g = g0 + r;
    xs[r * S + c] = (g >= 0 && g < T) ? load_act(xin, xbase + static_cast<size_t>(g) * H + c,
                                                 is_bf16)
                                      : 0.f;
  }
  for (int r = threadIdx.x; r < L; r += kThreads) {
    const int g = g0 + r;
    ms[r] = (g >= 0 && g < T) ? mask[static_cast<size_t>(b) * T + g] : 0.f;
  }
  for (int i = threadIdx.x; i < tile * H; i += kThreads) skip[i] = 0.f;
  __syncthreads();

  for (int j = 0; j < n_layers; ++j) {
    const int lo = 2 * (j + 1), hi = L - 2 * (j + 1);
    conv_pairs<H>(xs, w_in + static_cast<size_t>(j) * kTaps * H * 2 * H, b_in + j * 2 * H,
                  kTaps, lo, hi, [&](int r, int c, float ta, float sg) {
                    acts[r * S + c] = rnd(tanhf(ta) * (1.f / (1.f + expf(-sg))), is_bf16);
                  });
    __syncthreads();
    conv_pairs<H>(acts, w_rs + static_cast<size_t>(j) * H * 2 * H, b_rs + j * 2 * H, 1, lo,
                  hi, [&](int r, int c, float res, float sk) {
                    const float x = rnd(xs[r * S + c] + rnd(res, is_bf16), is_bf16);
                    xs[r * S + c] = rnd(x * ms[r], is_bf16);
                    if (r >= R && r < R + tile) skip[(r - R) * H + c] += sk;
                  });
    __syncthreads();
  }

  for (int i = threadIdx.x; i < tile * H; i += kThreads) {
    const int r = i / H, c = i % H, g = t0 + r;
    if (g >= T) continue;
    const size_t o = xbase + static_cast<size_t>(g) * H + c;
    store_act(xout, o, xs[(R + r) * S + c], is_bf16);
    float s = rnd(load_act(skip_io, o, is_bf16) + rnd(skip[i], is_bf16), is_bf16);
    if (final_mask) s = rnd(s * ms[R + r], is_bf16);
    store_act(skip_io, o, s, is_bf16);
  }
}

}  // namespace

extern "C" int svt_wn_stack(const void* x, const float* mask, void* x_out, void* skip,
                            const float* w_in, const float* b_in, const float* w_rs,
                            const float* b_rs, int B, int T, int H, int tile, int n_layers,
                            int final_mask, int is_bf16, void* stream) {
  const dim3 grid((T + tile - 1) / tile, B);
  const int L = tile + 4 * n_layers;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(L) * (H + 1) + static_cast<size_t>(tile) * H + L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear an earlier, unrelated error
  switch (H) {
    case 192:
      cudaFuncSetAttribute(wn_stack_kernel<192>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
      wn_stack_kernel<192><<<grid, kThreads, smem, s>>>(x, mask, x_out, skip, w_in, b_in, w_rs,
                                                        b_rs, T, tile, n_layers, final_mask,
                                                        is_bf16);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
