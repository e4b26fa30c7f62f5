// Fused HiFi-GAN MRF decoder stages on Hopper's tensor cores (sm_90a), plain
// C interface.
//
// svt_mrf_stage replaces smart_vocoder_tpu/kernels/mrf.py:fused_mrf_stage_packed
// (decoder stage 3); svt_up_mrf_stage replaces fused_up_mrf_stage (stage 4:
// lrelu -> ConvTranspose1d -> MRF -> optional lrelu(0.01) -> conv_post -> tanh).
// Both compute the function of the TPU kernels, not their block structure.
// They take bf16-valued weights (every serving mode); the same functions for
// true-f32 weights are the FMA kernels of mrf_stage_fma.cu.
//
// One block per (time tile, batch row). The block keeps its tile plus a halo
// of R rows on each side in shared memory, with zeros outside [0, T), and
// runs the branches one after another: for each residual pair, conv1 reads
// the operand buffer opA and writes lrelu(conv1) as the operand of conv2 into
// opB; conv2 adds into the branch state xb and writes the next operand into
// opA. Every conv output is zeroed outside [0, T) (the TPU kernels' validity
// mask). Each conv computes only the rows that later convs still need (the
// valid region shrinks by the conv's radius), so no read falls outside what
// was written. The last conv of a branch adds xb into an f32 sum over the
// central rows; the block writes sum / n_branches.
//
// What bounds it on the card: arithmetic. Stage 3 at B=32 x 1000 frames is
// ~4.2 TFLOP and stage 4 ~2.1 TFLOP; the tensors they read and write are
// ~50 MB. What the design does about it (helpers in mrf_mma.cuh):
// - Every conv is k shifted GEMMs on the tensor cores, bf16 operands and f32
//   accumulation: at C = 64 `wgmma.m64n64k16`, A from registers through
//   `ldmatrix` and the weight tile through a shared-memory descriptor, a
//   warpgroup owning a 64-row tile of the conv's shrinking row range; at
//   C = 32 `mma.sync.m16n8k16`, both operands through `ldmatrix`, a warp
//   owning a 16-row tile. 16 warps (four warpgroups) cover up to 256 rows, so
//   the tile is 128 rows with the 60-row halo (64 where the hi + lo planes
//   of F32 mode at C = 64 leave no room for more).
// - The operand buffers opA / opB hold operand(v) as bf16, written by the
//   epilogue of the conv before (bias, rounding, edge mask, residual add and
//   leaky on the accumulator fragments in registers). Rows are padded by 16
//   bytes, so the 8 row addresses of an `ldmatrix` fall on distinct banks.
//   The state xb and the branch sum stay f32.
// - F32 mode (hifi / x2: f32 activations, bf16-valued weights) runs two
//   passes as the TPU kernel does: the epilogue writes each operand as a hi
//   plane (the upper 16 bits) and a lo plane (the bf16 rounding of the rest),
//   and each k-step runs two MMAs into one accumulator.
// - The weights (1.03 MB of bf16 a stage at C = 64, resident in L2) are
//   streamed tap by tap through a ring of kStages shared-memory tiles with
//   `cp.async`, packed by the wrapper in the order of use, so the loads of
//   the next taps overlap the current MMAs, across conv boundaries too. A tile
//   serves every row of its conv (128-248 rows at a 128-row tile), so stage 3
//   at B=32 x 1000 frames pulls 32,000 blocks x 1.03 MB = 33 GB through L2.
// - Stage 4's ConvTranspose1d runs on the tensor cores as its polyphase form:
//   output rows n = s*j + phase are one GEMM over u rows j + const per tap of
//   that phase, K = Cin per tap. conv_post (C -> 1) and tanh stay scalar.
// What bounds the loop now: per tap the block meets at one barrier (it hands
// over the ring slot), and each warp then loads its A fragments, issues its
// MMAs and, on `wgmma`, waits for them before the next tap; the tensor cores
// idle meanwhile unless another warpgroup is in its MMAs. At C = 32 each warp
// also loads the whole weight tile itself, one byte of shared memory per 32
// FLOP, the SM's own ratio. A warp runs in order, so the order of the MMAs
// in the `mma.sync` k-step matters (the hi pass over every accumulator before
// the lo pass). The epilogue is templated on the mode: with the mode as a
// run-time value it took as long as the MMAs. mrf_mma.cuh says which MMA runs
// where, and what was measured.
//
// Precision modes (mode):
//   0 BF16         operands, stored intermediates, residual sums and output
//                  are bf16; the leaky slope and its product too.
//   1 F32_STORAGE  f32 storage and output; each conv operand rounded to bf16.
//   2 F32          no activation rounding: hi + lo operand planes (HILO).
// Biases arrive as f32 holding the rounded values; weights as packed bf16.
//
// svt_mrf_stage takes two more options, the functions of the packed-MRF A/B
// variants (scripts/exp_mrf_variants.py:fused_variant): mask_edges = 0 drops
// the zeroing outside [0, T) after each conv ("nomask": the chain runs on the
// zero-extended input, so biases leak in from the padding within one radius
// of the ends), and out_bf16 = 1 under F32_STORAGE rounds the stage output to
// bf16 ("f32acc": f32 chain state, bf16 conv operands, bf16 output).

#include "mrf_common.cuh"
#include "mrf_mma.cuh"

namespace {

// Shared-memory layout of a block, in bytes; kernels/mrf.py mirrors it to
// pick the tile. `rows` = tile + 2 * halo, `sum_rows` the rows of the branch
// sum, `n_state` the f32 state buffers (xb; stage 4 also keeps x0), `planes`
// 1 or 2 (hi + lo), KT the rows of a ring slot.
__host__ __device__ constexpr size_t smem_bytes(int C, int KT, int rows, int sum_rows,
                                                int n_state, int planes) {
  return static_cast<size_t>(n_state * rows + sum_rows) * (C + kPad) * 4 +
         static_cast<size_t>(2 * planes * rows + kStages * KT) * (C + kPad) * 2;
}

// Runs every branch over the block's buffers and adds each branch output
// over rows [acc_lo, acc_lo + acc_rows) into acc. `fill(lo, hi)` writes the
// stage input rows [lo, hi) into xb and its operand into opA (no sync).
template <int C, int KT, int MODE, typename Fill>
__device__ __forceinline__ void run_branches(WeightRing& ring, float* xb, __nv_bfloat16* opA,
                                             __nv_bfloat16* opB, int plane, float* acc,
                                             int acc_lo, int acc_rows, int g0, int T,
                                             const float* __restrict__ bias, const Branches& br,
                                             bool mask, Fill fill) {
  constexpr bool HILO = MODE == kF32;
  constexpr int SW = C + kPad;  // operand row stride, bf16 elements
  constexpr int SX = C + kPad;  // state row stride, floats
  const uint32_t sA = smem_u32(opA), sB = smem_u32(opB);
  const uint32_t lo_bytes = static_cast<uint32_t>(plane) * 2;
  size_t boff = 0;
  for (int b = 0; b < br.nb; ++b) {
    const int k = br.k[b], h = (k - 1) / 2;
    int rb = 0;
    for (int j = 0; j < br.np; ++j) rb += h * br.d[j] + h;
    int lo = acc_lo - rb, hi = acc_lo + acc_rows + rb;
    __syncthreads();  // the branch before may still read xb and opB
    fill(lo, hi);
    const float* b1 = bias + boff;
    const float* b2 = b1 + br.np * C;
    for (int j = 0; j < br.np; ++j) {
      const int d = br.d[j];
      lo += h * d;
      hi -= h * d;
      {
        const int lo1 = lo, half = h * d;
        gemm_rows<C, KT, C, SW, HILO>(
            ring, sA, lo_bytes, lo1, hi - lo1, k,
            [&](int t, int& shift, int& col) {
              shift = t * d - half;
              col = 0;
            },
            b1 + j * C,
            [&](int rr, int c, float v0, float v1) {
              const int r = lo1 + rr, g = g0 + r;
              const bool in = !mask || (g >= 0 && g < T);
              put_lrelu<MODE>(opB, plane, r * SW + c, in ? store_as<MODE>(v0) : 0.f,
                              in ? store_as<MODE>(v1) : 0.f);
            });
      }
      lo += h;
      hi -= h;
      const int lo2 = lo;
      const bool last = j == br.np - 1;
      gemm_rows<C, KT, C, SW, HILO>(
          ring, sB, lo_bytes, lo2, hi - lo2, k,
          [&](int t, int& shift, int& col) {
            shift = t - h;
            col = 0;
          },
          b2 + j * C,
          [&](int rr, int c, float v0, float v1) {
            const int r = lo2 + rr, g = g0 + r;
            const bool in = !mask || (g >= 0 && g < T);
            float2* xs = reinterpret_cast<float2*>(xb + r * SX + c);
            const float2 xv = *xs;
            const float n0 = store_as<MODE>((in ? store_as<MODE>(v0) : 0.f) + xv.x);
            const float n1 = store_as<MODE>((in ? store_as<MODE>(v1) : 0.f) + xv.y);
            if (last) {
              float2* as = reinterpret_cast<float2*>(acc + (r - acc_lo) * SX + c);
              float2 av = *as;
              av.x += n0;
              av.y += n1;
              *as = av;
            } else {
              *xs = make_float2(n0, n1);
              put_lrelu<MODE>(opA, plane, r * SW + c, n0, n1);
            }
          });
    }
    boff += 2 * br.np * C;
  }
  __syncthreads();  // the branch sum is complete
}

template <int C, int MODE>
__global__ void __launch_bounds__(kMmaThreads, 1)
    mrf_stage_kernel(const __nv_bfloat16* __restrict__ x, void* __restrict__ out,
                     const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias, int T,
                     int tile, int R, Branches br, int n_tiles, int mask_edges, int out_bf16) {
  constexpr int SW = C + kPad, SX = C + kPad;
  constexpr int planes = MODE == kF32 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = tile + 2 * R;
  float* xb = reinterpret_cast<float*>(smem);
  float* acc = xb + L * SX;
  __nv_bfloat16* opA = reinterpret_cast<__nv_bfloat16*>(acc + tile * SX);
  __nv_bfloat16* opB = opA + planes * L * SW;
  WeightRing ring{w, smem_u32(opB + planes * L * SW), n_tiles, 0, 0};
  ring_start<C, C>(ring);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - R;  // global row of buffer row 0
  for (int i = threadIdx.x; i < tile * SX; i += kMmaThreads) acc[i] = 0.f;
  const size_t xbase = static_cast<size_t>(b) * T * C;

  run_branches<C, C, MODE>(
      ring, xb, opA, opB, L * SW, acc, R, tile, g0, T, bias, br, mask_edges != 0,
      [&](int lo, int hi) {
        for (int i = threadIdx.x; i < (hi - lo) * (C / 8); i += kMmaThreads) {
          const int r = lo + i / (C / 8), c = (i % (C / 8)) * 8, g = g0 + r;
          float v[8];
          if (g >= 0 && g < T) {
            const uint4 raw =
                *reinterpret_cast<const uint4*>(x + xbase + static_cast<size_t>(g) * C + c);
            const uint32_t wds[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              v[2 * e] = __uint_as_float(wds[e] << 16);
              v[2 * e + 1] = __uint_as_float(wds[e] & 0xFFFF0000u);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = 0.f;
          }
          *reinterpret_cast<float4*>(xb + r * SX + c) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(xb + r * SX + c + 4) = make_float4(v[4], v[5], v[6], v[7]);
#pragma unroll
          for (int e = 0; e < 8; e += 2)
            put_lrelu<MODE>(opA, L * SW, r * SW + c + e, v[e], v[e + 1]);
        }
      });

  for (int i = threadIdx.x; i < tile * C; i += kMmaThreads) {
    const int r = i / C, c = i % C, g = t0 + r;
    if (g < T) {
      store_out(out, xbase + static_cast<size_t>(g) * C + c, acc[r * SX + c] / br.nb,
                out_bf16);
    }
  }
}

template <int CIN, int C, int MODE>
__global__ void __launch_bounds__(kMmaThreads, 1)
    up_mrf_stage_kernel(const void* __restrict__ u, void* __restrict__ out,
                        const __nv_bfloat16* __restrict__ w, const float* __restrict__ bup,
                        const float* __restrict__ bias, const float* __restrict__ wpost, int Tu,
                        int tile, int H, int kup, int sup, int pup, int kpost, Branches br,
                        int n_tiles, int in_bf16) {
  constexpr int SW = C + kPad, SX = C + kPad, SU = CIN + kPad;
  constexpr int KC = CIN / 64;  // 64-row weight tiles per tap of the upsample
  constexpr bool HILO = MODE == kF32;
  constexpr int planes = HILO ? 2 : 1;
  constexpr int mode = MODE;  // for the scalar helpers of mrf_common.cuh
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = Tu * sup;
  const int P = kpost > 0 ? (kpost - 1) / 2 : 0;
  const int L = tile + 2 * H;
  const int acc_rows = tile + 2 * P;
  float* x0 = reinterpret_cast<float*>(smem);
  float* xb = x0 + L * SX;
  float* acc = xb + L * SX;
  __nv_bfloat16* opA = reinterpret_cast<__nv_bfloat16*>(acc + acc_rows * SX);
  __nv_bfloat16* opB = opA + planes * L * SW;
  __nv_bfloat16* ubuf = opA;  // the u tile lives in opA/opB until the branches start
  WeightRing ring{w, smem_u32(opB + planes * L * SW), n_tiles, kup * KC, 0};
  ring_start<C, 64>(ring);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int g0 = t0 - H;
  for (int i = threadIdx.x; i < acc_rows * SX; i += kMmaThreads) acc[i] = 0.f;

  // u rows feeding output rows [g0, g0 + L): m in [m_lo, m_hi].
  const int m_lo = -floor_div(-(g0 + pup - kup + 1), sup);
  const int m_hi = floor_div(g0 + L - 1 + pup, sup);
  const int n_u = m_hi - m_lo + 1;
  const size_t ubase = static_cast<size_t>(b) * Tu * CIN;
  for (int i = threadIdx.x; i < n_u * (CIN / 2); i += kMmaThreads) {
    const int m = m_lo + i / (CIN / 2), ci = (i % (CIN / 2)) * 2;
    float v0 = 0.f, v1 = 0.f;
    if (m >= 0 && m < Tu) {
      const size_t at = ubase + static_cast<size_t>(m) * CIN + ci;
      v0 = load_act(u, at, in_bf16);
      v1 = load_act(u, at + 1, in_bf16);
    }
    put_lrelu<MODE>(ubuf, n_u * SU, (m - m_lo) * SU + ci, v0, v1);
  }

  // Transposed conv, x[n][c] = bup[c] + sum_{m, t: n = m*s - p + t} u'[m][ci] wup[t][ci][c],
  // phase by phase: rows n = s*j + phase take the taps t = (phase + p) mod s + i*s,
  // each from u row j + (phase + p - t) / s.
  for (int phase = 0; phase < sup; ++phase) {
    const int j_lo = -floor_div(-(g0 - phase), sup);
    const int j_hi = floor_div(g0 + L - 1 - phase, sup);
    const int t_first = (phase + pup) % sup;
    const int n_taps = (kup - t_first + sup - 1) / sup;
    gemm_rows<C, 64, 64, SU, HILO>(
        ring, smem_u32(ubuf), static_cast<uint32_t>(n_u * SU) * 2, j_lo - m_lo,
        j_hi - j_lo + 1, n_taps * KC,
        [&](int i, int& shift, int& col) {
          const int t = t_first + (i / KC) * sup;
          shift = (phase + pup - t) / sup;  // divides exactly
          col = (i % KC) * 64;
        },
        bup,
        [&](int jj, int c, float v0, float v1) {
          const int n = sup * (j_lo + jj) + phase, r = n - g0;
          const bool valid = n >= 0 && n < T;
          *reinterpret_cast<float2*>(x0 + r * SX + c) =
              make_float2(valid ? store_as<MODE>(v0) : 0.f, valid ? store_as<MODE>(v1) : 0.f);
        });
  }

  run_branches<C, 64, MODE>(ring, xb, opA, opB, L * SW, acc, H - P, acc_rows, g0, T, bias, br,
                            true, [&](int lo, int hi) {
                              for (int i = threadIdx.x; i < (hi - lo) * (C / 2);
                                   i += kMmaThreads) {
                                const int r = lo + i / (C / 2), c = (i % (C / 2)) * 2;
                                const float2 v = *reinterpret_cast<float2*>(x0 + r * SX + c);
                                *reinterpret_cast<float2*>(xb + r * SX + c) = v;
                                put_lrelu<MODE>(opA, L * SW, r * SW + c, v.x, v.y);
                              }
                            });

  const size_t obase = static_cast<size_t>(b) * T;
  if (kpost == 0) {
    for (int i = threadIdx.x; i < tile * C; i += kMmaThreads) {
      const int r = i / C, c = i % C, g = t0 + r;
      if (g < T) {
        store_out(out, (obase + g) * C + c, acc[r * SX + c] / br.nb, mode == kBF16);
      }
    }
    return;
  }
  // Decoder tail over the stage result rows [H - P, H + tile + P): the
  // branches computed them exactly, so conv_post sees real neighbours. z takes
  // xb's place with a row stride of C + 1 floats, which keeps one thread per
  // output row free of bank conflicts.
  constexpr int SZ = C + 1;
  float* z = xb;
  for (int i = threadIdx.x; i < acc_rows * C; i += kMmaThreads) {
    const int r = i / C, c = i % C;
    const float res = store(acc[r * SX + c] / br.nb, mode);
    z[r * SZ + c] = leaky(res, 0.01f, mode);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < tile; o += kMmaThreads) {
    const int g = t0 + o;
    if (g >= T) continue;
    float y = 0.f;
    for (int t = 0; t < kpost; ++t) {
      const float* zr = z + (o + t) * SZ;
      const float* wt = wpost + t * C;
#pragma unroll 8
      for (int c = 0; c < C; ++c) y = fmaf(zr[c], __ldg(wt + c), y);
    }
    store_out(out, obase + g, tanhf(y), mode == kBF16);
  }
}

// Tiles of the packed weights: one per tap of each of the 2 * np convs of
// each branch, after n_up tiles of the upsample.
int count_tiles(const Branches& br, int n_up) {
  int n = n_up;
  for (int b = 0; b < br.nb; ++b) n += 2 * br.np * br.k[b];
  return n;
}

template <typename Kernel, typename... Args>
int launch_stage(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<grid, kMmaThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w: the MRF weights as bf16 tiles [branch][pair][conv1, conv2][tap][Cin][Cout];
// bias: f32 [branch][b1 of every pair, b2 of every pair][C].
extern "C" int svt_mrf_stage(const void* x, void* out, const void* w, const float* bias, int B,
                             int T, int C, int tile, int R, int nb, int k0, int k1, int k2,
                             int np, int d0, int d1, int d2, int mode, int in_bf16,
                             int mask_edges, int out_bf16, void* stream) {
  const Branches br{nb, {k0, k1, k2}, np, {d0, d1, d2}};
  const int rows = tile + 2 * R;
  if (rows > kMaxRows || !in_bf16) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + tile - 1) / tile, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const int n_tiles = count_tiles(br, 0);
  cudaGetLastError();  // clear an earlier, unrelated error
#define SVT_MRF_CASE(CC, MD)                                                                 \
  if (C == CC && mode == MD) {                                                               \
    return launch_stage(mrf_stage_kernel<CC, MD>, grid,                                      \
                        smem_bytes(CC, CC, rows, tile, 1, MD == kF32 ? 2 : 1), s, xb, out,   \
                        wb, bias, T, tile, R, br, n_tiles, mask_edges, out_bf16);            \
  }
  SVT_MRF_CASE(32, kBF16)
  SVT_MRF_CASE(32, kF32Storage)
  SVT_MRF_CASE(32, kF32)
  SVT_MRF_CASE(64, kBF16)
  SVT_MRF_CASE(64, kF32Storage)
  SVT_MRF_CASE(64, kF32)
#undef SVT_MRF_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// w: the upsample's weights as bf16 tiles [phase][tap of the phase][Cin / 64][64][Cout],
// then the MRF tiles as for svt_mrf_stage. mode: 0 (BF16) or 2 (F32).
extern "C" int svt_up_mrf_stage(const void* u, void* out, const void* w, const float* bup,
                                const float* bias, const float* wpost, int B, int Tu, int Cin,
                                int C, int kup, int sup, int pup, int tile, int H, int kpost,
                                int nb, int k0, int k1, int k2, int np, int d0, int d1, int d2,
                                int mode, int in_bf16, void* stream) {
  const Branches br{nb, {k0, k1, k2}, np, {d0, d1, d2}};
  const int T = Tu * sup;
  const int P = kpost > 0 ? (kpost - 1) / 2 : 0;
  const int rows = tile + 2 * H;
  if (rows > kMaxRows || (mode != 0 && mode != 2) || kup - 2 * pup != sup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((T + tile - 1) / tile, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const int n_tiles = count_tiles(br, kup * (Cin / 64));
  cudaGetLastError();
#define SVT_UP_CASE(CI, CC, MD)                                                              \
  if (Cin == CI && C == CC && mode == MD) {                                                  \
    return launch_stage(up_mrf_stage_kernel<CI, CC, MD>, grid,                               \
                        smem_bytes(CC, 64, rows, tile + 2 * P, 2, MD == kF32 ? 2 : 1), s, u, \
                        out, wb, bup, bias, wpost, Tu, tile, H, kup, sup, pup, kpost, br,    \
                        n_tiles, in_bf16);                                                   \
  }
  SVT_UP_CASE(64, 32, kBF16)
  SVT_UP_CASE(64, 32, kF32)
  SVT_UP_CASE(128, 64, kBF16)
  SVT_UP_CASE(128, 64, kF32)
#undef SVT_UP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
