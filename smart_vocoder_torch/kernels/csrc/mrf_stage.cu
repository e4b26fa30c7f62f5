// Fused HiFi-GAN MRF decoder stages for Hopper (sm_90a), plain C interface.
//
// svt_mrf_stage replaces smart_vocoder_tpu/kernels/mrf.py:fused_mrf_stage_packed
// (decoder stage 3); svt_up_mrf_stage replaces fused_up_mrf_stage (stage 4:
// lrelu -> ConvTranspose1d -> MRF -> optional lrelu(0.01) -> conv_post -> tanh);
// svt_mrf_stage_unpacked replaces fused_mrf_stage (the stage in x.dtype, at
// C = 128 and 256 too; its design is described at mrf_pair_kernel below).
// All compute the function of the TPU kernels, not their block structure.
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
//
// svt_mrf_stage takes two more options, the functions of the packed-MRF A/B
// variants (scripts/exp_mrf_variants.py:fused_variant): mask_edges = 0 drops
// the zeroing outside [0, T) after each conv ("nomask": the chain runs on the
// zero-extended input, so biases leak in from the padding within one radius
// of the ends), and out_bf16 = 1 under F32_STORAGE rounds the stage output to
// bf16 ("f32acc": f32 chain state, bf16 conv operands, bf16 output).

#include "mrf_common.cuh"

namespace {

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
                             bool mask, Fill fill) {
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
                     const float xt = (!mask || (g >= 0 && g < T)) ? store(v, mode) : 0.f;
                     opB[r * S + c] = operand(xt, mode);
                   });
      __syncthreads();
      lo += h;
      hi -= h;
      const bool last = j == br.np - 1;
      conv_rows<C>(opB, w2 + j * wconv, b2 + j * C, k, 1, lo, hi,
                   [&](int r, int c, float v) {
                     const int g = g0 + r;
                     const float xt = (!mask || (g >= 0 && g < T)) ? store(v, mode) : 0.f;
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
                     int tile, int R, Branches br, int mode, int in_bf16, int mask_edges,
                     int out_bf16) {
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

  run_branches<C>(xb, opA, opB, acc, R, tile, g0, T, w, bias, br, mode, mask_edges != 0,
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
      store_out(out, xbase + static_cast<size_t>(t0) * C + i, acc[i] / br.nb, out_bf16);
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

  run_branches<C>(xb, opA, opB, acc, H - P, acc_rows, g0, T, w, bias, br, mode, true,
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

// One residual pair of one branch of the unpacked stage (fused_mrf_stage),
// x_new = x + c2(lrelu(c1_d(lrelu(x)))), with each conv output rounded and
// zeroed outside [0, T) as the TPU kernel does (mrf.py:60-86).
//
// Why per pair: at C = 256 the whole-stage design above (three haloed
// buffers of tile + 2 * 60 rows) does not fit in 227 KB even in bf16 at a
// 32-row tile, and at any tile that fits the 60-row halo would multiply the
// work. One pair needs a halo of only h*d + 2h rows (at most 30 for k = 11,
// d = 5), so a block keeps two buffers: the operand lrelu(x) over
// tile + 2(h*d + h) rows and the operand of conv2 over tile + 2h rows, in the
// mode's own storage type St (bf16 in BF16 mode, where every stored value is
// a bf16 value; f32 in F32 mode). The residual x is read from global memory
// at the output row. A stage is n_branches * n_pairs launches; the branch
// states go through global memory (bf16 at B=32 x 1000 frames: ~0.5 GB per
// pass against the ~8.5 TFLOP of stage 2, so the launches stay bound by the
// FMA loop), and the last pair of each branch adds its output into an f32
// sum in branch order, as the TPU kernel's accumulator does, or writes
// (sum + x) / n_branches for the last branch.
enum PairOp { kState = 0, kAccSet = 1, kAccAdd = 2, kOut = 3 };

template <int C, typename St>
__global__ void __launch_bounds__(kThreads)
    mrf_pair_kernel(const void* __restrict__ xin, void* __restrict__ xout,
                    float* __restrict__ acc, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, int T, int tile, int k, int d, int op,
                    int nb) {
  constexpr int S = C + 1;
  constexpr bool kBf = std::is_same<St, __nv_bfloat16>::value;
  constexpr int mode = kBf ? kBF16 : 2;  // BF16 or F32
  extern __shared__ __align__(16) unsigned char pair_smem[];
  const int h = (k - 1) / 2;
  const int HA = h * d + h;  // operand rows beyond the tile on each side
  St* opA = reinterpret_cast<St*>(pair_smem);  // rows [0, tile + 2*HA)
  St* opB = opA + (tile + 2 * HA) * S;         // rows [h*d, tile + 2*HA - h*d)
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - HA;  // global row of local row 0
  const size_t base = static_cast<size_t>(b) * T * C;
  for (int i = threadIdx.x; i < (tile + 2 * HA) * C; i += kThreads) {
    const int r = i / C, c = i % C, g = g0 + r;
    const float v =
        (g >= 0 && g < T) ? load_act(xin, base + static_cast<size_t>(g) * C + c, kBf) : 0.f;
    opA[r * S + c] = from_f<St>(operand(v, mode));
  }
  __syncthreads();
  conv_rows<C>(opA, w1, b1, k, d, h * d, tile + 2 * HA - h * d, [&](int r, int c, float v) {
    const int g = g0 + r;
    const float xt = (g >= 0 && g < T) ? store(v, mode) : 0.f;
    opB[(r - h * d) * S + c] = from_f<St>(operand(xt, mode));
  });
  __syncthreads();
  const int rows = min(tile, T - t0);
  conv_rows<C>(
      opB, w2, b2, k, 1, HA, HA + rows,
      [&](int r, int c, float v) {
        const size_t idx = base + static_cast<size_t>(g0 + r) * C + c;
        const float nx = store(store(v, mode) + load_act(xin, idx, kBf), mode);
        switch (op) {
          case kState:
            store_out(xout, idx, nx, kBf);
            break;
          case kAccSet:
            acc[idx] = nx;
            break;
          case kAccAdd:
            acc[idx] += nx;
            break;
          default:
            store_out(xout, idx, (nb > 1 ? acc[idx] + nx : nx) / nb, kBf);
        }
      },
      h * d);
}

template <int C, typename St>
int launch_unpacked(const void* x, void* out, void* s0, void* s1, float* acc, const float* w,
                    const float* bias, int B, int T, int tile, const Branches& br,
                    int* n_launched, cudaStream_t s) {
  const dim3 grid((T + tile - 1) / tile, B);
  size_t woff = 0, boff = 0;
  for (int i = 0; i < br.nb; ++i) {
    const int k = br.k[i], h = (k - 1) / 2;
    const size_t wconv = static_cast<size_t>(k) * C * C;
    const void* cur = x;
    for (int j = 0; j < br.np; ++j) {
      const bool last = j == br.np - 1;
      const int op = !last ? kState : i == br.nb - 1 ? kOut : i == 0 ? kAccSet : kAccAdd;
      void* dst = !last ? (j % 2 == 0 ? s0 : s1) : out;
      const int d = br.d[j];
      const size_t smem = sizeof(St) * (2 * static_cast<size_t>(tile) + 2 * (h * d + 2 * h)) *
                          (C + 1);
      cudaFuncSetAttribute(mrf_pair_kernel<C, St>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
      mrf_pair_kernel<C, St><<<grid, kThreads, smem, s>>>(
          cur, dst, acc, w + woff + j * wconv, bias + boff + j * C,
          w + woff + (br.np + j) * wconv, bias + boff + (br.np + j) * C, T, tile, k, d, op,
          br.nb);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      ++*n_launched;
      cur = dst;
    }
    woff += 2 * br.np * wconv;
    boff += 2 * br.np * C;
  }
  return 0;
}

}  // namespace

extern "C" int svt_mrf_stage_unpacked(const void* x, void* out, void* s0, void* s1, float* acc,
                                      const float* w, const float* bias, int B, int T, int C,
                                      int tile, int nb, int k0, int k1, int k2, int np, int d0,
                                      int d1, int d2, int is_bf16, int* n_launched,
                                      void* stream) {
  const Branches br{nb, {k0, k1, k2}, np, {d0, d1, d2}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;  // kernels launched: nb * np when all went
  cudaGetLastError();
#define SVT_PAIR_CASE(CC)                                                                   \
  case CC:                                                                                  \
    return is_bf16 ? launch_unpacked<CC, __nv_bfloat16>(x, out, s0, s1, acc, w, bias, B, T, \
                                                        tile, br, n_launched, s)            \
                   : launch_unpacked<CC, float>(x, out, s0, s1, acc, w, bias, B, T, tile,   \
                                                br, n_launched, s);
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

extern "C" int svt_mrf_stage(const void* x, void* out, const float* w, const float* bias,
                             int B, int T, int C, int tile, int R, int nb, int k0, int k1,
                             int k2, int np, int d0, int d1, int d2, int mode, int in_bf16,
                             int mask_edges, int out_bf16, void* stream) {
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
                                                       mode, in_bf16, mask_edges, out_bf16); \
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
  SVT_UP_CASE(128, 64)
#undef SVT_UP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
