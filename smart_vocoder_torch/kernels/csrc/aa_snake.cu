// BigVGAN's anti-aliased SnakeBeta in one pass: out = down2(SnakeBeta(up2(x))),
// channel by channel over rows of a (B, C, T) tensor.
//
// It replaces no TPU kernel: the JAX package has no BigVGAN. As torch's chain
// (replicate pad, grouped transposed conv, crop, five elementwise ops, replicate
// pad, grouped strided conv) the activation makes about ten passes over a
// signal twice the input's length; here each block reads its tile of x once
// (with a 6-sample halo, the replicate edges applied as clamped indices),
// keeps the 2T upsampled signal in shared memory, and writes its tile of the
// output once. With 12-tap filters the work is 24 FMA-FLOPs of the up filter
// and 24 of the down filter an input element, and two sines: a bf16 pass is
// bound by device memory (4 bytes an element against ~60 f32 operations) only
// if the sine is cheap, so sin^2 is taken as __sinf of an argument reduced by
// pi (sin^2 has period pi; two-part Cody-Waite with fma, as sinf reduces
// moderate arguments), where __sinf is accurate to 2^-21 absolute.
//
// up2:   y[2p]   = 2 sum_{d=-2..3} x[p-d] f[2d+5],  y[2p+1] = 2 sum_{d=-3..2} x[p-d] f[2d+6]
//        (x replicate-padded by 5, stride-2 transposed conv, 15 cropped each side)
// snake: z = y + sin^2(a_c y) * ib_c,  a_c = exp(log alpha_c), ib_c = 1 / (exp(log beta_c) + 1e-9)
// down2: out[q] = sum_{k=0..11} f[k] z[clamp(2q + k - 5, 0, 2T - 1)]
// All arithmetic is f32; x is f32 or bf16, out bf16 (the next conv's operand).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;  // outputs a block
constexpr int kThreads = 256;
constexpr int kTaps = 12;
constexpr int kHalo = 6;                  // input samples each side a tile reads
constexpr int kNx = kTile + 2 * kHalo;    // x[q0 - 6, q0 + tile + 6)
constexpr int kPairs = kTile + 6;         // p in [q0 - 3, q0 + tile + 3): y[2p], y[2p + 1]
constexpr int kNz = kTile + 5;            // z of each parity the down filter reads

struct Taps {
  float f[kTaps];
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float sin_sq(float v) {
  const float k = rintf(v * 0.318309886183790672f);  // v / pi
  float r = fmaf(-k, 3.14159274101257324f, v);      // pi rounded to f32
  r = fmaf(-k, -8.74227766e-8f, r);                 // pi - (pi rounded to f32)
  const float s = __sinf(r);                        // r in [-pi/2, pi/2]
  return s * s;
}

__device__ __forceinline__ float snake(float y, float a, float ib) {
  return fmaf(sin_sq(a * y), ib, y);
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
    aa_snake_kernel(const Tin* __restrict__ x, __nv_bfloat16* __restrict__ out,
                    const float* __restrict__ alpha, const float* __restrict__ inv_beta,
                    const Taps taps, int C, int T) {
  // z at j = m - (2 q0 - 5), split by the parity of j: z_even[j / 2], z_odd[(j - 1) / 2],
  // so that the down filter's neighbouring outputs read neighbouring words
  __shared__ float xs[kNx];
  __shared__ float z_even[kNz];
  __shared__ float z_odd[kNz];
  const long long row = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const Tin* xr = x + row * T;
  const int c = static_cast<int>(row % C);
  const float a = alpha[c], ib = inv_beta[c];
  const float* f = taps.f;

  for (int i = threadIdx.x; i < kNx; i += kThreads) {
    xs[i] = load(xr + min(max(q0 - kHalo + i, 0), T - 1));
  }
  __syncthreads();

  for (int u = threadIdx.x; u < kPairs; u += kThreads) {
    const int p = q0 - 3 + u;
    const int pc = min(max(p, 0), T - 1);
    const float* xp = xs + (pc - q0 + kHalo);  // xp[-d] = x[pc - d]
    float ye = 0.f, yo = 0.f;
    ye = fmaf(xp[2], f[1], ye);
    ye = fmaf(xp[1], f[3], ye);
    ye = fmaf(xp[0], f[5], ye);
    ye = fmaf(xp[-1], f[7], ye);
    ye = fmaf(xp[-2], f[9], ye);
    ye = fmaf(xp[-3], f[11], ye);
    yo = fmaf(xp[3], f[0], yo);
    yo = fmaf(xp[2], f[2], yo);
    yo = fmaf(xp[1], f[4], yo);
    yo = fmaf(xp[0], f[6], yo);
    yo = fmaf(xp[-1], f[8], yo);
    yo = fmaf(xp[-2], f[10], yo);
    float ze = snake(2.f * ye, a, ib), zo = snake(2.f * yo, a, ib);
    if (p < 0) zo = ze;           // m < 0 reads z[0], the even sample of p = 0
    if (p > T - 1) ze = zo;       // m > 2T - 1 reads z[2T - 1], the odd sample of p = T - 1
    // m = 2p sits at j = 2u - 1 (odd), m = 2p + 1 at j = 2u (even)
    if (u >= 1) z_odd[u - 1] = ze;
    if (u < kNz) z_even[u] = zo;
  }
  __syncthreads();

  __nv_bfloat16* orow = out + row * T + q0;
  const int n = min(kTile, T - q0);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    // out[q0 + i] = sum_k f[k] z[j = 2i + k]
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < kTaps / 2; ++h) {
      s = fmaf(z_even[i + h], f[2 * h], s);
      s = fmaf(z_odd[i + h], f[2 * h + 1], s);
    }
    orow[i] = __float2bfloat16_rn(s);
  }
}

template <typename Tin>
cudaError_t launch(const void* x, void* out, const float* alpha, const float* inv_beta,
                   const Taps& taps, int rows, int C, int T, cudaStream_t s) {
  const dim3 grid(rows, (T + kTile - 1) / kTile);
  aa_snake_kernel<Tin><<<grid, kThreads, 0, s>>>(static_cast<const Tin*>(x),
                                                 static_cast<__nv_bfloat16*>(out), alpha,
                                                 inv_beta, taps, C, T);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, T) f32 or bf16 with row = b * C + c; out: the same, bf16; alpha, inv_beta:
// (C,) f32 on the device; taps: the 12 filter taps in host memory.
extern "C" int svt_aa_snake(const void* x, void* out, const float* alpha, const float* inv_beta,
                            const float* taps, int rows, int C, int T, int in_bf16,
                            void* stream) {
  if (rows <= 0 || C <= 0 || T <= 0 || rows % C != 0 || (T + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.f[k] = taps[k];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // clear an earlier, unrelated error
  const cudaError_t err =
      in_bf16 ? launch<__nv_bfloat16>(x, out, alpha, inv_beta, t, rows, C, T, s)
              : launch<float>(x, out, alpha, inv_beta, t, rows, C, T, s);
  return static_cast<int>(err);
}
