// Fused WN (WaveNet-gate) layers for Hopper (sm_90a), plain C interface.
//
// svt_wn_stack replaces smart_vocoder_tpu/kernels/wn_stack.py:fused_wn_stack
// (_wn_kernel) for a bf16 x: one launch runs one chunk of up to
// `layers_per_call` WN layers of an unconditioned stack (the prior's 16
// layers, each flow step's 8), as one pallas_call does. Per layer: the k=5
// conv H -> 2H plus bias, tanh(a) * sigmoid(b), the 1x1 res/skip conv,
// x = (x + res) * mask, and the skip summed in f32 over the chunk. The row
// packing by 2 and the column permutations of the TPU kernel are lane tricks
// and are not carried over. svt_wn_stack_fma is the same for an f32 x (f32
// weights, which a product of bf16 pairs does not compute), on the CUDA cores.
//
// One block per (time tile, batch row). The block keeps its tile plus a halo
// of 2 rows per layer of the chunk in shared memory: the state x, the gate
// output, the mask and the f32 skip sum of the tile's own rows. Layer j
// computes rows [2(j+1), L - 2(j+1)) of the haloed buffer, so the last layer
// ends exactly on the tile and no read leaves the written region. Rows
// outside [0, T) hold x = 0 and mask = 0, which is the zero padding of the
// TPU kernel; the update (x + res) * mask keeps them at 0.
//
// What bounds it on the card: arithmetic. A layer is ~0.89 MFLOP per time
// step (5*192*384 + 192*384 multiply-adds), 16 layers at B=32 x 1000 frames
// 0.45 TFLOP, 0.46 ms at 989 TFLOP/s, on ~25 MB of activations per launch.
// The tensor-core kernel (wn_stack_mma_kernel, 16 warps, helpers in
// mrf_mma.cuh):
// - every conv is row-shifted GEMMs on `wgmma` (bf16 x bf16 -> f32): the
//   in-conv 5 taps x 3 chunks of 64 input channels, the 1x1 conv 3 chunks;
//   A, the state or the gate output, comes from a bf16 operand buffer
//   through `ldmatrix` (rows padded by 16 bytes), the weight tiles through
//   shared-memory descriptors from the 4-slot cp.async ring;
// - N runs in three passes of two m64n64k16 slices that share each A
//   fragment: the weights are packed (kernels/wn_stack.py:_pack_chunk) so
//   that pass p holds tanh columns 64p.. beside sigmoid columns H + 64p..
//   (and res beside skip for the 1x1 conv), so one thread holds both halves
//   of a gate and its epilogue forms tanh * sigmoid in registers and writes
//   it, rounded to bf16, into the gate operand buffer; the 1x1 epilogue
//   updates the state and adds the skip. The skip-only last layer runs one
//   slice a pass (its tiles carry zeros beside the skip columns, which no
//   MMA reads);
// - the tile is 64 rows at 4 layers a chunk (the f32 skip sum, two operand
//   buffers and the ring fill 185 KB; kernels/wn_stack.py:wn_tile mirrors
//   smem_bytes), so a GEMM covers 64-76 rows: one or two warpgroups of the
//   four carry it.
//
// Precision, the JAX kernel's rounding points in x.dtype:
//   weights and biases arrive rounded to x.dtype (biases as f32 values);
//   each conv accumulates in f32 and adds its bias in f32;
//   the gate output is rounded to bf16 before the 1x1 conv;
//   x = (x + bf16(res)) * mask is evaluated in bf16 (x is a bf16 value);
//   the skip sum is f32 within the chunk, rounded to bf16 at its end, and
//   summed across chunks in bf16 (skip_io holds the running sum).
// The FMA kernel rounds nothing (the f32 mode).

#include "mrf_common.cuh"
#include "mrf_mma.cuh"

namespace {

constexpr int kTaps = 5;
constexpr int kWnPass = 128;  // columns of one ring tile: two 64-column slices

// Shared memory of the tensor-core kernel, in bytes (kernels/wn_stack.py:
// wn_smem_bytes mirrors it): the f32 skip sum, the state and gate operand
// buffers, the mask (padded to 16 bytes) and the ring.
__host__ __device__ constexpr size_t smem_bytes(int H, int tile, int n_layers) {
  const int L = tile + 4 * n_layers;
  return static_cast<size_t>(tile) * (H + kPad) * 4 + 2 * static_cast<size_t>(L) * (H + kPad) * 2 +
         static_cast<size_t>((L + 3) / 4 * 4) * 4 +
         static_cast<size_t>(kStages) * 64 * (kWnPass + kPad) * 2;
}

// w: n_layers x [in-conv tiles [pass][tap][Cin / 64], 1x1 tiles [pass][Cin / 64]],
// each 64 x 128 ([tanh | sigmoid] or [res | skip] columns of the pass; a
// skip-only layer [skip | zeros]); b_in, b_rs: n_layers x 2H f32 in the same
// column order.
template <int H>
__global__ void __launch_bounds__(kMmaThreads, 1)
    wn_stack_mma_kernel(const __nv_bfloat16* __restrict__ xin, const float* __restrict__ mask,
                        __nv_bfloat16* __restrict__ xout, __nv_bfloat16* __restrict__ skip_io,
                        const __nv_bfloat16* __restrict__ w, const float* __restrict__ b_in,
                        const float* __restrict__ b_rs, int T, int tile, int n_layers,
                        int final_mask, int last_skip_only) {
  constexpr int SW = H + kPad, SX = H + kPad;
  constexpr int KC = H / 64, NP = H / 64;  // K chunks, N passes
  constexpr int kLayerTiles = NP * (kTaps + 1) * KC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = 2 * n_layers;  // (k - 1) / 2 rows per layer
  const int L = tile + 2 * R;
  float* skip = reinterpret_cast<float*>(smem);                     // tile x SX
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(skip + tile * SX);  // L x SW: state
  __nv_bfloat16* acts = xs + L * SW;                                // L x SW: gate output
  float* ms = reinterpret_cast<float*>(acts + L * SW);              // L: the mask
  WeightRing ring{w, smem_u32(ms + (L + 3) / 4 * 4), kLayerTiles * n_layers,
                  kLayerTiles * n_layers, 0};
  ring_start<kWnPass, 64, true>(ring);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - R;
  const size_t xbase = static_cast<size_t>(b) * T * H;

  for (int i = threadIdx.x; i < L * (H / 8); i += kMmaThreads) {
    const int r = i / (H / 8), c = (i % (H / 8)) * 8, g = g0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (g >= 0 && g < T) {
      raw = *reinterpret_cast<const uint4*>(xin + xbase + static_cast<size_t>(g) * H + c);
    }
    *reinterpret_cast<uint4*>(xs + r * SW + c) = raw;
  }
  for (int r = threadIdx.x; r < L; r += kMmaThreads) {
    const int g = g0 + r;
    ms[r] = (g >= 0 && g < T) ? mask[static_cast<size_t>(b) * T + g] : 0.f;
  }
  for (int i = threadIdx.x; i < tile * SX; i += kMmaThreads) skip[i] = 0.f;

  const uint32_t sX = smem_u32(xs), sG = smem_u32(acts);
  for (int j = 0; j < n_layers; ++j) {
    const int lo = 2 * (j + 1), n = L - 4 * (j + 1);
    const float* bi = b_in + j * 2 * H;
    const float* br = b_rs + j * 2 * H;
    // in-conv and gate: rows lo.. read the state 2 rows either side
    for (int p = 0; p < NP; ++p) {
      gemm_rows_wgmma<SW, false, 2>(
          ring, sX, 0, lo, n, kTaps * KC,
          [&](int i, int& shift, int& col) {
            shift = i / KC - (kTaps - 1) / 2;
            col = (i % KC) * 64;
          },
          bi + p * kWnPass, [&](int rr, int c, const float2 (&v)[2]) {
            const float a0 = tanhf(v[0].x) * (1.f / (1.f + expf(-v[1].x)));
            const float a1 = tanhf(v[0].y) * (1.f / (1.f + expf(-v[1].y)));
            *reinterpret_cast<__nv_bfloat162*>(acts + (lo + rr) * SW + p * 64 + c) =
                __floats2bfloat162_rn(a0, a1);
          });
    }
    const auto step = [&](int i, int& shift, int& col) {
      shift = 0;
      col = i * 64;
    };
    if (last_skip_only && j == n_layers - 1) {
      // skip-only: one slice a pass, the skip columns
      for (int p = 0; p < NP; ++p) {
        gemm_rows_wgmma<SW, false, 1, kWnPass>(
            ring, sG, 0, lo, n, KC, step, br + p * kWnPass,
            [&](int rr, int c, float s0, float s1) {
              const int r = lo + rr;
              if (r >= R && r < R + tile) {
                float2* sk = reinterpret_cast<float2*>(skip + (r - R) * SX + p * 64 + c);
                const float2 sv = *sk;
                *sk = make_float2(sv.x + s0, sv.y + s1);
              }
            });
      }
    } else {
      for (int p = 0; p < NP; ++p) {
        gemm_rows_wgmma<SW, false, 2>(
            ring, sG, 0, lo, n, KC, step, br + p * kWnPass,
            [&](int rr, int c, const float2 (&v)[2]) {
              const int r = lo + rr, col = p * 64 + c;
              __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(xs + r * SW + col);
              const float2 x = __bfloat1622float2(*xp);
              const float m = ms[r];
              const float n0 = store_as<kBF16>(store_as<kBF16>(x.x + store_as<kBF16>(v[0].x)) * m);
              const float n1 = store_as<kBF16>(store_as<kBF16>(x.y + store_as<kBF16>(v[0].y)) * m);
              *xp = __floats2bfloat162_rn(n0, n1);
              if (r >= R && r < R + tile) {
                float2* sk = reinterpret_cast<float2*>(skip + (r - R) * SX + col);
                const float2 sv = *sk;
                *sk = make_float2(sv.x + v[1].x, sv.y + v[1].y);
              }
            });
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int i = threadIdx.x; i < tile * (H / 2); i += kMmaThreads) {
    const int r = i / (H / 2), c = (i % (H / 2)) * 2, g = t0 + r;
    if (g >= T) continue;
    const size_t o = xbase + static_cast<size_t>(g) * H + c;
    *reinterpret_cast<__nv_bfloat162*>(xout + o) =
        *reinterpret_cast<const __nv_bfloat162*>(xs + (R + r) * SW + c);
    const float2 run = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(skip_io + o));
    const float2 sk = *reinterpret_cast<const float2*>(skip + r * SX + c);
    float s0 = store_as<kBF16>(run.x + store_as<kBF16>(sk.x));
    float s1 = store_as<kBF16>(run.y + store_as<kBF16>(sk.y));
    if (final_mask) {
      s0 = store_as<kBF16>(s0 * ms[R + r]);
      s1 = store_as<kBF16>(s1 * ms[R + r]);
    }
    *reinterpret_cast<__nv_bfloat162*>(skip_io + o) = __floats2bfloat162_rn(s0, s1);
  }
}

// The f32 form on the CUDA cores.
constexpr int kWnThreads = 192;
constexpr int kWnRM = 10;  // output rows per thread per pass

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
  constexpr int RG = kWnThreads / CG;
  static_assert(kWnThreads % CG == 0, "threads must cover whole rows of channel groups");
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const int c0 = cg * 4;
  const int half = (taps - 1) / 2;
  const float4 ba = *reinterpret_cast<const float4*>(bias + c0);
  const float4 bb = *reinterpret_cast<const float4*>(bias + H + c0);
  for (int r0 = lo; r0 < hi; r0 += RG * kWnRM) {
    float a[kWnRM][4], b[kWnRM][4];
#pragma unroll
    for (int i = 0; i < kWnRM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = b[i][j] = 0.f;
    }
    int base[kWnRM];
    for (int t = 0; t < taps; ++t) {
#pragma unroll
      for (int i = 0; i < kWnRM; ++i) base[i] = (min(r0 + rg + i * RG, hi - 1) + t - half) * S;
      const float* wt = w + static_cast<size_t>(t) * H * 2 * H + c0;
#pragma unroll 2
      for (int ci = 0; ci < H; ++ci) {
        const float4 wa = __ldg(reinterpret_cast<const float4*>(wt + ci * 2 * H));
        const float4 wb = __ldg(reinterpret_cast<const float4*>(wt + ci * 2 * H + H));
#pragma unroll
        for (int i = 0; i < kWnRM; ++i) {
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
    for (int i = 0; i < kWnRM; ++i) {
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

// w: n_layers x [w_in (5, H, 2H) [tap][in][tanh half | sigmoid half], w_rs
// (H, 2H) [in][res half | skip half]] (a skip-only layer arrives with a zero
// res half); biases n_layers x 2H. All f32.
template <int H>
__global__ void __launch_bounds__(kWnThreads)
    wn_stack_fma_kernel(const float* __restrict__ xin, const float* __restrict__ mask,
                        float* __restrict__ xout, float* __restrict__ skip_io,
                        const float* __restrict__ w, const float* __restrict__ b_in,
                        const float* __restrict__ b_rs, int T, int tile, int n_layers,
                        int final_mask) {
  constexpr int S = H + 1;
  constexpr size_t kLayerW = static_cast<size_t>(kTaps + 1) * H * 2 * H;
  extern __shared__ float fsmem[];
  const int R = 2 * n_layers;
  const int L = tile + 2 * R;
  float* xs = fsmem;             // L x S: the state x
  float* acts = xs + L * S;      // L x S: the gate output
  float* skip = acts + L * S;    // tile x H: f32 skip sum of the tile's rows
  float* ms = skip + tile * H;   // L: the mask
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - R;
  const size_t xbase = static_cast<size_t>(b) * T * H;

  for (int i = threadIdx.x; i < L * H; i += kWnThreads) {
    const int r = i / H, c = i % H, g = g0 + r;
    xs[r * S + c] = (g >= 0 && g < T) ? xin[xbase + static_cast<size_t>(g) * H + c] : 0.f;
  }
  for (int r = threadIdx.x; r < L; r += kWnThreads) {
    const int g = g0 + r;
    ms[r] = (g >= 0 && g < T) ? mask[static_cast<size_t>(b) * T + g] : 0.f;
  }
  for (int i = threadIdx.x; i < tile * H; i += kWnThreads) skip[i] = 0.f;
  __syncthreads();

  for (int j = 0; j < n_layers; ++j) {
    const int lo = 2 * (j + 1), hi = L - 2 * (j + 1);
    const float* wl = w + j * kLayerW;
    conv_pairs<H>(xs, wl, b_in + j * 2 * H, kTaps, lo, hi, [&](int r, int c, float ta, float sg) {
      acts[r * S + c] = tanhf(ta) * (1.f / (1.f + expf(-sg)));
    });
    __syncthreads();
    conv_pairs<H>(acts, wl + static_cast<size_t>(kTaps) * H * 2 * H, b_rs + j * 2 * H, 1, lo, hi,
                  [&](int r, int c, float res, float sk) {
                    xs[r * S + c] = (xs[r * S + c] + res) * ms[r];
                    if (r >= R && r < R + tile) skip[(r - R) * H + c] += sk;
                  });
    __syncthreads();
  }

  for (int i = threadIdx.x; i < tile * H; i += kWnThreads) {
    const int r = i / H, c = i % H, g = t0 + r;
    if (g >= T) continue;
    const size_t o = xbase + static_cast<size_t>(g) * H + c;
    xout[o] = xs[(R + r) * S + c];
    const float s = skip_io[o] + skip[i];
    skip_io[o] = final_mask ? s * ms[R + r] : s;
  }
}

}  // namespace

extern "C" int svt_wn_stack(const void* x, const float* mask, void* x_out, void* skip,
                            const void* w, const float* b_in, const float* b_rs, int B, int T,
                            int H, int tile, int n_layers, int final_mask, int last_skip_only,
                            void* stream) {
  const dim3 grid((T + tile - 1) / tile, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear an earlier, unrelated error
  if (H != 192 || tile + 4 * n_layers - 4 > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(192, tile, n_layers);
  cudaFuncSetAttribute(wn_stack_mma_kernel<192>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  wn_stack_mma_kernel<192><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), mask, static_cast<__nv_bfloat16*>(x_out),
      static_cast<__nv_bfloat16*>(skip), static_cast<const __nv_bfloat16*>(w), b_in, b_rs, T,
      tile, n_layers, final_mask, last_skip_only);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svt_wn_stack_fma(const void* x, const float* mask, void* x_out, void* skip,
                                const float* w, const float* b_in, const float* b_rs, int B,
                                int T, int H, int tile, int n_layers, int final_mask,
                                void* stream) {
  const dim3 grid((T + tile - 1) / tile, B);
  const int L = tile + 4 * n_layers;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(L) * (H + 1) + static_cast<size_t>(tile) * H + L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  if (H != 192) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(wn_stack_fma_kernel<192>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  wn_stack_fma_kernel<192><<<grid, kWnThreads, smem, s>>>(
      static_cast<const float*>(x), mask, static_cast<float*>(x_out), static_cast<float*>(skip),
      w, b_in, b_rs, T, tile, n_layers, final_mask);
  return static_cast<int>(cudaGetLastError());
}
