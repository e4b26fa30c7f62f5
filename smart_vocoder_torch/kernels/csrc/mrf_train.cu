// Backward of one ResBlock1 branch of the MRF stage on Hopper's tensor cores
// (sm_90a), plain C interface.
//
// svt_mrf_branch_bwd replaces smart_vocoder_tpu/kernels/mrf_train.py:
// mrf_branch_bwd (_branch_bwd_kernel) for a bf16 x: given the stage input x
// and the cotangent g of one branch's output, it returns dx and the gradients
// of the branch's 2 * n_pairs convolutions (dw1, db1, dw2, db2, summed in
// f32). Every product here is of two bf16 values, which the tensor cores form
// exactly, so only the order of summation differs from the plain version. An
// f32 x keeps the FMA body of mrf_train_fma.cu (svt_mrf_branch_bwd_fma).
//
// The forward saves only (x, weights), so the chain is replayed. The work is
// cut per residual pair x_{j+1} = x_j + c2(lrelu(h_j)), h_j = c1_d(lrelu(x_j))
// (r = (k - 1) / 2), into 2 n + 1 launches:
//
//   replay, j = 0 .. n-1: the unpacked stage's pair kernel (mrf_pair.cuh,
//     REPLAY) writes h_j over its tile and x_{j+1} (not after the last pair);
//   dx, j = n-1 .. 0 (mrf_pair_bwd_kernel): the pair kernel's body run on
//     cotangents. From dy = dxb, the cotangent of x_{j+1}, over the tile and
//     a halo of r(d + 1) rows (raw, zero outside [0, T)):
//       dq = conv(dy, flip(w2)^T)              over tile + 2rd rows
//       dh = bf16(bf16(dq) * dlrelu(h_j))     zero outside [0, T)
//       dp = conv_d(dh, flip(w1)^T)            over the tile
//       dxb' = bf16(dxb + bf16(bf16(dp) * dlrelu(x_j)))
//     Both convs are pair_conv over the ring of flipped, transposed weight
//     tiles (packed once per call by kernels/mrf_train.py); dh's own rows also
//     go to a scratch tensor for the weight gradients;
//   dw (mrf_dw_mma_kernel), one launch for the branch's 2 n convs:
//     dw[t] = sum over all B * T rows of lrelu(a)[row + (t - r) dil]^T grad[row]
//     with (a, grad, dil) = (h_j, dy_j, 1) for conv2 and (x_j, dh_j, d_j) for
//     conv1, and db = the column sums of grad.
//
// What bounds it on the card: arithmetic. A stage's backward is 714 C^2 T B
// FLOP (17/6 of its forward: 5 replayed convs, 6 dx convs and 6 weight
// products a branch), against tensors of a few MB. The replay and dx run the
// unpacked stage's GEMMs (wgmma from 64 channels, mma.sync at 32; one pass of
// all C columns). Their tile is the largest of 240, 128, 64, 32 whose GEMM
// rows (tile + 2rd in dx) the warpgroups cover and whose buffers fit:
// kernels/mrf.py:unpacked_tile for the replay, kernels/mrf_train.py:
// branch_bwd_tile for dx, which holds dy over tile + 2r(d + 1) rows, dh over
// tile + 2rd and the ring (227,040 B at C = 256, k = 11, d = 5, tile 64).
//
// The weight gradients are a GEMM with K = B * T, the time axis: M = Cin,
// N = Cout per tap, both operands K-major in shared memory, so both go through
// `ldmatrix.trans` (a tap's row shift is an address) into `mma.sync.m16n8k16`;
// lrelu is applied to the A fragments in registers. A block owns one (conv,
// tap, 64 x 64 output tile) and one of `splits` ranges of K (32 x 32 and four
// warps on K at C = 32), streamed in chunks of rows through a 3-slot cp.async
// ring that zero-fills rows outside the sequence; the split count is chosen by
// the wrapper (kernels/mrf_train.py:dw_splits) to fill the card where the dx
// grid cannot (16 batch rows x 4 tiles at (16, 256, 256)). Each block adds its
// partial tile with one f32 atomic per element, so dw and db repeat only to f32
// summation order from run to run.
//
// Rounding points: every replayed conv output, dq, dp, dq * dlrelu(h) and
// dxb + dp * dlrelu(x) are rounded to bf16; dlrelu(v) is 1 for v > 0, else
// bf16(0.1) (v == 0 takes the slope).
// Registers and shared memory per instantiation: PERF.md §6.

#include "mrf_pair.cuh"

namespace {

// Shared memory of one dx block, in bytes: dy over tile + 2(rd + r) rows, dh
// over tile + 2rd, and the ring (kernels/mrf_train.py:branch_bwd_smem_bytes
// mirrors it).
template <int C>
constexpr size_t bwd_smem_bytes(int tile, int h, int d) {
  using G = PairGeometry<C>;
  return static_cast<size_t>(2 * tile + 2 * (h * d + h) + 2 * h * d) * (C + kPad) * 2 +
         static_cast<size_t>(G::STAGES) * G::KT * (C + kPad) * 2;
}

__device__ __forceinline__ float dleaky_bf16(float v) { return v > 0.f ? 1.f : rbf(0.1f); }

// The dx step of pair j over one time tile (see the file comment). w: the
// pair's packed tiles, flip(w2)^T then flip(w1)^T; zero: C zero biases.
template <int C>
__global__ void __launch_bounds__(PairGeometry<C>::THREADS, 1)
    mrf_pair_bwd_kernel(const __nv_bfloat16* __restrict__ din,
                        const __nv_bfloat16* __restrict__ xj,
                        const __nv_bfloat16* __restrict__ hj, __nv_bfloat16* __restrict__ dout,
                        __nv_bfloat16* __restrict__ dh, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ zero, int T, int tile, int k, int d) {
  constexpr int SW = C + kPad;
  using G = PairGeometry<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = (k - 1) / 2, hd = h * d;
  const int HA = hd + h;  // dy rows beyond the tile on each side
  const int LA = tile + 2 * HA, LB = tile + 2 * hd;
  __nv_bfloat16* opA = reinterpret_cast<__nv_bfloat16*>(smem);  // dy, global rows t0 - HA + r
  __nv_bfloat16* opB = opA + LA * SW;                            // dh, global rows t0 - hd + r
  WeightRing ring{w, smem_u32(opB + LB * SW), 2 * G::tiles(k), G::kWide ? 2 * G::tiles(k) : 0,
                  0};
  ring_start<C, G::KT, G::kWide || C == kWgmmaC, G::THREADS, G::STAGES>(ring);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const size_t base = static_cast<size_t>(b) * T * C;
  for (int i = threadIdx.x; i < LA * (C / 8); i += G::THREADS) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8, g = t0 - HA + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (g >= 0 && g < T) {
      raw = *reinterpret_cast<const uint4*>(din + base + static_cast<size_t>(g) * C + c);
    }
    *reinterpret_cast<uint4*>(opA + r * SW + c) = raw;
  }
  // dq over rows [t0 - rd, t0 + tile + rd); the ring's barrier orders the fill
  pair_conv<C>(ring, smem_u32(opA), h, LB, k, 1, zero, [&](int rr, int c, float v0, float v1) {
    const int g = t0 - hd + rr;
    float o0 = 0.f, o1 = 0.f;
    if (g >= 0 && g < T) {
      const size_t idx = base + static_cast<size_t>(g) * C + c;
      const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hj + idx));
      o0 = rbf(rbf(v0) * dleaky_bf16(hv.x));
      o1 = rbf(rbf(v1) * dleaky_bf16(hv.y));
      if (rr >= hd && rr < hd + tile) {
        *reinterpret_cast<__nv_bfloat162*>(dh + idx) = __floats2bfloat162_rn(o0, o1);
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(opB + rr * SW + c) = __floats2bfloat162_rn(o0, o1);
  });
  // dp over the tile's valid rows: output row rr reads dh rows rr + t d
  const int rows = min(tile, T - t0);
  pair_conv<C>(ring, smem_u32(opB), hd, rows, k, d, zero, [&](int rr, int c, float v0, float v1) {
    const size_t idx = base + static_cast<size_t>(t0 + rr) * C + c;
    const float2 dy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(din + idx));
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xj + idx));
    *reinterpret_cast<__nv_bfloat162*>(dout + idx) =
        __floats2bfloat162_rn(rbf(dy.x + rbf(rbf(v0) * dleaky_bf16(xv.x))),
                              rbf(dy.y + rbf(rbf(v1) * dleaky_bf16(xv.y))));
  });
}

// The weight-gradient GEMM's block by channel count (kernels/mrf_train.py:
// dw_geometry mirrors it): a TM x TM output tile, chunks of KC rows, WK of the
// four warps splitting a chunk's rows (the others its 32 x 32 warp tiles).
template <int C>
struct DwGeometry {
  static constexpr int TM = C >= 64 ? 64 : 32;
  static constexpr int KC = C >= 64 ? 64 : 128;
  static constexpr int WK = C >= 64 ? 1 : 4;
  static constexpr int THREADS = 128;
  static constexpr int STAGES = 3;
  static constexpr int TILES = (C / TM) * (C / TM);  // output tiles of one tap
  static constexpr int SA = TM + kPad;               // row stride of a chunk, elements
  static constexpr int SLOT = 2 * KC * SA * 2;       // bytes: the operand and grad chunks
  static constexpr size_t smem() { return static_cast<size_t>(STAGES) * SLOT; }
};

// One conv of the weight-gradient launch: dw[t][ci][co] += sum over rows of
// lrelu(a)[row + (t - r) dil][ci] * grad[row][co], db[co] += sum of grad[.][co].
struct DwConv {
  const __nv_bfloat16* a;
  const __nv_bfloat16* grad;
  float* dw;
  float* db;
  int dil;
};
constexpr int kMaxDwConvs = 6;  // two per residual pair, three pairs
struct DwConvs {
  DwConv c[kMaxDwConvs];
};

// 16 bytes from global to shared memory, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// lrelu of two bf16 values, in bf16 (as put_lrelu's BF16 mode).
__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t v) {
  __nv_bfloat162 t = *reinterpret_cast<__nv_bfloat162*>(&v);
  t = __hmax2(t, __hmul2(t, __float2bfloat162_rn(0.1f)));
  return *reinterpret_cast<uint32_t*>(&t);
}

// Block (conv, tap, tile, split) of the weight gradients over R = B * T rows
// of sequences of length T (see the file comment).
template <int C>
__global__ void __launch_bounds__(DwGeometry<C>::THREADS, 4)
    mrf_dw_mma_kernel(const DwConvs convs, int R, int T, int k, int splits) {
  using G = DwGeometry<C>;
  constexpr int TM = G::TM, KC = G::KC, SA = G::SA, NTM = C / TM;
  constexpr int MNW = 4 / G::WK;  // warps over the output tile
  extern __shared__ __align__(16) unsigned char smem[];
  int bid = blockIdx.x;
  const int split = bid % splits;
  bid /= splits;
  const int tile = bid % G::TILES;
  bid /= G::TILES;
  const int tap = bid % k, conv = bid / k;
  DwConv cv = convs.c[0];
#pragma unroll
  for (int i = 1; i < kMaxDwConvs; ++i) {
    if (i == conv) cv = convs.c[i];  // no dynamic index into the parameters
  }
  const int m0 = (tile % NTM) * TM, n0 = (tile / NTM) * TM;
  const int shift = (tap - (k - 1) / 2) * cv.dil;
  const int nq = (R + KC - 1) / KC;
  const int q0 = static_cast<int>(static_cast<long long>(split) * nq / splits);
  const int q1 = static_cast<int>(static_cast<long long>(split + 1) * nq / splits);
  const uint32_t s0 = smem_u32(smem);

  // chunk q (rows q*KC ..) into its slot: lrelu's operand rows shifted by the
  // tap, zero outside [0, T) of their own sequence; the grad rows as they are
  auto load = [&](int q) {
    const uint32_t sa = s0 + ((q - q0) % G::STAGES) * G::SLOT, sg = sa + KC * SA * 2;
    for (int i = threadIdx.x; i < KC * (TM / 8); i += G::THREADS) {
      const int row = i / (TM / 8), pc = (i % (TM / 8)) * 8, rg = q * KC + row;
      const bool live = rg < R;
      const int b = live ? rg / T : 0;
      const int rs = rg - b * T + shift;
      const bool va = live && rs >= 0 && rs < T;
      cp_async16_zfill(sa + (row * SA + pc) * 2,
                       va ? cv.a + (static_cast<size_t>(b) * T + rs) * C + m0 + pc : cv.a, va);
      cp_async16_zfill(sg + (row * SA + pc) * 2,
                       live ? cv.grad + static_cast<size_t>(rg) * C + n0 + pc : cv.grad, live);
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wmn = warp % MNW, wk = warp / MNW;
  const int wm = wmn % (TM / 32), wn = wmn / (TM / 32);
  // db: the blocks of tap 0 and the first row of tiles sum their grad columns
  const bool with_db = tap == 0 && m0 == 0;
  constexpr int DG = G::THREADS / TM;  // row groups of the column sums
  const int dcol = threadIdx.x % TM, dgrp = threadIdx.x / TM;
  float dsum = 0.f;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
    }
  }
  for (int q = q0; q < q0 + G::STAGES - 1; ++q) {
    if (q < q1) load(q);
    cp_async_commit();
  }
  for (int q = q0; q < q1; ++q) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // chunk q landed; every warp is done with the slot reloaded next
    if (q + G::STAGES - 1 < q1) load(q + G::STAGES - 1);
    cp_async_commit();
    const uint32_t sa = s0 + ((q - q0) % G::STAGES) * G::SLOT, sg = sa + KC * SA * 2;
#pragma unroll
    for (int i = 0; i < KC / 16 / G::WK; ++i) {
      const int s = wk + i * G::WK;  // the k16 step of the chunk
      // A (M = Cin, K = rows) from the K-major operand chunk: ldmatrix.trans of
      // the 8 x 8 blocks (rows k 0-7 | 8-15) x (columns m 0-7 | 8-15)
      uint32_t a[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldsm_x4_trans(a[mi], sa + ((s * 16 + (lane & 7) + ((lane >> 4) << 3)) * SA + wm * 32 +
                                   mi * 16 + ((lane >> 3) & 1) * 8) *
                                      2);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[mi][e] = lrelu_bf16x2(a[mi][e]);
      }
      // B (K = rows, N = Cout) from the grad chunk, as the weight tiles are read
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldsm_x4_trans(bf[np],
                      sg + ((s * 16 + (lane & 15)) * SA + wn * 32 + np * 16 + (lane >> 4) * 8) * 2);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(acc[mi][2 * np], a[mi], bf[np][0], bf[np][1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], bf[np][2], bf[np][3]);
        }
      }
    }
    if (with_db) {
      const auto* gs = reinterpret_cast<const __nv_bfloat16*>(
          smem + ((q - q0) % G::STAGES) * G::SLOT + KC * SA * 2);
      for (int r = dgrp; r < KC; r += DG) dsum += __bfloat162float(gs[r * SA + dcol]);
    }
  }
  // accumulator fragment: lane holds rows (Cin) g, g + 8 at columns (Cout) 2 tig, 2 tig + 1
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ci = m0 + wm * 32 + mi * 16 + g + hf * 8;
        float* p = cv.dw + (static_cast<size_t>(tap) * C + ci) * C + n0 + wn * 32 + nt * 8 +
                   tig * 2;
        atomicAdd(p, acc[mi][nt][2 * hf]);
        atomicAdd(p + 1, acc[mi][nt][2 * hf + 1]);
      }
    }
  }
  if (with_db) atomicAdd(cv.db + n0 + dcol, dsum);
}

struct BwdArgs {
  const __nv_bfloat16 *x, *g;
  __nv_bfloat16 *dx, *xs, *hs, *dys, *dhs;
  const __nv_bfloat16 *wf, *wb;
  const float *b1, *b2, *zero;
  float *dw1, *db1, *dw2, *db2;
};

template <int C>
int launch_branch_bwd(const BwdArgs& a, int B, int T, int tile_r, int tile_d, int k, int np,
                      const int* dil, int splits, int* n_launched, cudaStream_t s) {
  using G = PairGeometry<C>;
  using D = DwGeometry<C>;
  const size_t n = static_cast<size_t>(B) * T * C;  // elements of one (B, T, C) tensor
  const size_t wconv = static_cast<size_t>(k) * C * C;
  const int h = (k - 1) / 2;
  // x_0 = x, x_1 .. in xs; the cotangent of x_{j+1}: g for the last pair, else dys[j]
  auto state = [&](int j) { return j == 0 ? a.x : a.xs + (j - 1) * n; };
  auto cot = [&](int j) { return j == np - 1 ? a.g : a.dys + j * n; };
  auto went = [&]() {
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++*n_launched;
    return static_cast<int>(err);
  };
  if (tile_r + 2 * h > G::MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid_r((T + tile_r - 1) / tile_r, B);
  for (int j = 0; j < np; ++j) {
    const bool last = j == np - 1;
    const size_t smem = smem_bytes<C>(tile_r, h, dil[j]);
    cudaFuncSetAttribute(mrf_pair_mma_kernel<C, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    mrf_pair_mma_kernel<C, true><<<grid_r, G::THREADS, smem, s>>>(
        state(j), last ? nullptr : a.xs + j * n, nullptr, a.hs + j * n, a.wf + 2 * j * wconv,
        a.b1 + j * C, a.b2 + j * C, T, tile_r, k, dil[j], last ? kHOnly : kState, 1);
    if (const int err = went()) return err;
  }
  const dim3 grid_d((T + tile_d - 1) / tile_d, B);
  for (int j = np - 1; j >= 0; --j) {
    if (tile_d + 2 * h * dil[j] > G::MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = bwd_smem_bytes<C>(tile_d, h, dil[j]);
    cudaFuncSetAttribute(mrf_pair_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    mrf_pair_bwd_kernel<C><<<grid_d, G::THREADS, smem, s>>>(
        cot(j), state(j), a.hs + j * n, j == 0 ? a.dx : a.dys + (j - 1) * n, a.dhs + j * n,
        a.wb + 2 * j * wconv, a.zero, T, tile_d, k, dil[j]);
    if (const int err = went()) return err;
  }
  DwConvs convs{};
  for (int j = 0; j < np; ++j) {
    convs.c[2 * j] = {a.hs + j * n, cot(j), a.dw2 + j * wconv, a.db2 + j * C, 1};
    convs.c[2 * j + 1] = {state(j), a.dhs + j * n, a.dw1 + j * wconv, a.db1 + j * C, dil[j]};
  }
  cudaFuncSetAttribute(mrf_dw_mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(D::smem()));
  const unsigned blocks = 2u * np * k * D::TILES * splits;
  mrf_dw_mma_kernel<C><<<blocks, D::THREADS, D::smem(), s>>>(convs, B * T, T, k, splits);
  return went();
}

}  // namespace

// x, g, dx: bf16 (B, T, C). Scratch, bf16: xs (np - 1, B, T, C) the replayed
// states, hs (np, ...) the conv1 outputs, dys (np - 1, ...) the cotangents of
// x_1 .. x_{np-1}, dhs (np, ...) the dh of every pair. wf: the branch's bf16
// tiles [pair][conv1, conv2] and wb: [pair][flip(w2)^T, flip(w1)^T], both as
// kernels/mrf.py:pack_mrf_weights lays them out; b1, b2: f32 (np, C); zero: C
// f32 zeros. dw1, dw2: (np, k, C, C) f32 and db1, db2: (np, C) f32, zeroed by
// the caller. tile_r, tile_d: the replay's and dx's time tiles; splits: the
// weight-gradient launch's K ranges. n_launched: kernels launched, 2 np + 1
// when all went.
extern "C" int svt_mrf_branch_bwd(const void* x, const void* g, void* dx, void* xs, void* hs,
                                  void* dys, void* dhs, const void* wf, const float* b1,
                                  const float* b2, const void* wb, const float* zero,
                                  float* dw1, float* db1, float* dw2, float* db2, int B, int T,
                                  int C, int tile_r, int tile_d, int k, int np, int d0, int d1,
                                  int d2, int splits, int* n_launched, void* stream) {
  using bf = __nv_bfloat16;
  BwdArgs a{};
  a.x = static_cast<const bf*>(x);
  a.g = static_cast<const bf*>(g);
  a.dx = static_cast<bf*>(dx);
  a.xs = static_cast<bf*>(xs);
  a.hs = static_cast<bf*>(hs);
  a.dys = static_cast<bf*>(dys);
  a.dhs = static_cast<bf*>(dhs);
  a.wf = static_cast<const bf*>(wf);
  a.wb = static_cast<const bf*>(wb);
  a.b1 = b1;
  a.b2 = b2;
  a.zero = zero;
  a.dw1 = dw1;
  a.db1 = db1;
  a.dw2 = dw2;
  a.db2 = db2;
  const int dil[3] = {d0, d1, d2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *n_launched = 0;
  cudaGetLastError();  // clear an earlier, unrelated error
  if (np < 1 || np > 3 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
#define SVT_BWD_CASE(CC) \
  case CC:               \
    return launch_branch_bwd<CC>(a, B, T, tile_r, tile_d, k, np, dil, splits, n_launched, s);
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
