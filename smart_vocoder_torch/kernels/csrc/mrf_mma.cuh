// Tensor-core building blocks of the MRF kernels (mrf_stage.cu, mrf_pair.cu)
// and the WN stack (wn_stack.cu): warp-level bf16 MMA with f32 accumulation,
// `ldmatrix` operand loads, the hi/lo split of an f32 operand, and a ring of
// weight tiles streamed through shared memory with `cp.async`.
//
// A convolution is k shifted GEMMs over one shared-memory operand: for tap t,
// D[rows, Cout] += A[rows + t*dil - half, Cin] * W_t[Cin, Cout]. A is a
// row-shifted window of the operand buffer, so nothing is gathered first:
// every lane of an `ldmatrix` gives the address of its own row, and any shift
// is just another row address.
//
// Two MMA bodies, chosen by the channel count C (the N of every GEMM):
// - C = 64: `wgmma.mma_async.m64n64k16` (bf16 x bf16 -> f32). A comes from
//   registers, loaded with `ldmatrix` from the shifted rows (a shared-memory
//   descriptor cannot name a window shifted by a number of rows that is no
//   multiple of 8); B, the weight tile, is read by the tensor cores through a
//   shared-memory descriptor, once per warpgroup and not once per warp. A
//   warpgroup owns a 64-row tile; its four warps hold 16 rows each, in the
//   accumulator layout of the warp-level MMA. The same body takes N as NS
//   slices of 64 columns that share each A fragment (the unpacked stage at
//   C = 128 and 256, kernels of mrf_pair.cu; the WN stack, wn_stack.cu, whose
//   two slices are a gate's tanh and sigmoid columns).
// - C = 32: `mma.sync.aligned.m16n8k16`, both operands through `ldmatrix`; a
//   warp owns a 16-row tile.
// A block is 16 warps (four warpgroups), which cover the 256 rows a GEMM may
// have. Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W) with
// tools/ab_stage_mma.py, which builds this file with kWgmmaC = 0 for the
// other leg: at C = 64 `wgmma` takes 1.58-1.61 ms against 2.16-2.18 for stage
// 3 at x (2, 128000, 64), and 21-33% less in the other modes (the weight
// tile is read once per 64 rows instead of once per 16). At C = 32 an
// `m64n32k16` body was 10-25% slower than `mma.sync` when both were tried,
// since the per-tap costs (barrier, fence, commit and wait) are spread over
// half the work. Two other `wgmma` bodies were slower than this one: the next
// tap's A loaded under the running wgmma, and both operands through
// descriptors over an operand buffer in planes of 8 channels (rows 16 bytes
// apart, where any row shift is a start address).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMmaThreads = 512;             // four warpgroups
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMT = 1;                       // row tiles a warp (warpgroup) owns in one GEMM
constexpr int kMaxRows = 16 * kMT * kMmaWarps;  // rows one GEMM may cover
constexpr int kStages = 4;                   // weight tiles in the ring
constexpr int kPad = 8;                      // bf16 / f32 elements of row padding

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the row address of row l % 8 of matrix
// l / 8. Lane i receives elements 2*(i%4), 2*(i%4)+1 of row i/4 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same, each matrix transposed: lane i receives rows 2*(i%4), 2*(i%4)+1
// of column i/4. This turns a [K][N] row-major tile into the MMA's B fragment.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The hi plane of an f32 operand: its upper 16 bits, a bf16 value by
// truncation (smart_vocoder_tpu/kernels/mrf.py:190-200). v - hi is exact in
// f32 and has 16 significant bits; the lo plane is its bf16 rounding, so
// hi + lo reconstructs v to ~2^-16 relative.
__device__ __forceinline__ float hi_part(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

// A value as the mode stores it: rounded to bf16 in BF16 mode.
template <int MODE>
__device__ __forceinline__ float store_as(float v) {
  if constexpr (MODE == kBF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Writes the conv operands lrelu(x0), lrelu(x1) of two stored values at
// element idx (even) of a bf16 operand buffer, at the mode's precision.
// BF16: the values are bf16 values, and the slope and the product are bf16
// too (packed bf16 arithmetic rounds the exact product once, as rounding the
// f32 product does). F32_STORAGE: the f32 leaky, rounded once. F32: the f32
// leaky as a hi pair and, `plane` elements further, a lo pair.
template <int MODE>
__device__ __forceinline__ void put_lrelu(__nv_bfloat16* op, int plane, int idx, float x0,
                                          float x1) {
  if constexpr (MODE == kBF16) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(x0, x1);  // exact
    *reinterpret_cast<__nv_bfloat162*>(op + idx) =
        __hmax2(t, __hmul2(t, __float2bfloat162_rn(0.1f)));
  } else if constexpr (MODE == kF32Storage) {
    *reinterpret_cast<__nv_bfloat162*>(op + idx) =
        __floats2bfloat162_rn(fmaxf(x0, x0 * 0.1f), fmaxf(x1, x1 * 0.1f));
  } else {
    const float a0 = fmaxf(x0, x0 * 0.1f), a1 = fmaxf(x1, x1 * 0.1f);
    const float h0 = hi_part(a0), h1 = hi_part(a1);
    *reinterpret_cast<uint32_t*>(op + idx) =
        (__float_as_uint(h0) >> 16) | (__float_as_uint(h1) & 0xFFFF0000u);
    *reinterpret_cast<__nv_bfloat162*>(op + plane + idx) =
        __floats2bfloat162_rn(a0 - h0, a1 - h1);
  }
}

// The weights of one launch as a sequence of tiles in the order the GEMMs
// consume them (packed so by kernels/mrf.py): n_up tiles of 64 x C (the
// upsample's taps, in chunks of 64 input channels; in the unpacked stage and
// the WN stack every tile: 64 input channels by the C columns of one pass),
// then tiles of C x C (one per tap of each MRF conv). C is the tile's width.
// A row-major tile (`mma.sync`, C = 32) is [K][C] and lands in its ring slot
// with the rows padded by kPad elements, which keeps the 8 row addresses of an
// `ldmatrix` on distinct banks. A FLAT tile (`wgmma`) is packed as `wgmma`
// reads a K-major B operand without swizzle, 8 x 8 core matrices of 128
// contiguous bytes [C / 8][K / 8][8 columns][8 rows], and lands as one flat
// copy at the start of its slot (the slots keep the padded size).
struct WeightRing {
  const __nv_bfloat16* g;  // packed tiles in global memory (they live in L2)
  uint32_t s;              // shared address of slot 0
  int n_tiles, n_up;
  int next;                // the tile the next GEMM step consumes
};

constexpr int kWgmmaC = 64;  // the channel count whose stage GEMMs run on `wgmma`

// THREADS: the block's threads, every one of which calls the ring; STAGES:
// its slots.
template <int C, int KT, bool FLAT = C == kWgmmaC, int THREADS = kMmaThreads,
          int STAGES = kStages>
__device__ __forceinline__ void ring_load(const WeightRing& r, int q) {
  constexpr int SW = C + kPad;
  constexpr int CPR = C / 8;  // 16-byte chunks per row
  if (q < r.n_tiles) {
    const bool up = q < r.n_up;
    const int rows = up ? 64 : C;
    const size_t off = up ? static_cast<size_t>(q) * 64 * C
                          : static_cast<size_t>(r.n_up) * 64 * C +
                                static_cast<size_t>(q - r.n_up) * C * C;
    const uint32_t dst = r.s + (q % STAGES) * (KT * SW * 2);
    for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
      if constexpr (FLAT) {
        cp_async16(dst + i * 16, r.g + off + i * 8);
      } else {
        const int row = i / CPR, ch = i % CPR;
        cp_async16(dst + (row * SW + ch * 8) * 2, r.g + off + row * C + ch * 8);
      }
    }
  }
  cp_async_commit();  // every thread commits one group per tile, empty or not
}

// Starts the ring: tiles 0 .. STAGES - 2 in flight.
template <int C, int KT, bool FLAT = C == kWgmmaC, int THREADS = kMmaThreads,
          int STAGES = kStages>
__device__ __forceinline__ void ring_start(WeightRing& r) {
  r.next = 0;
  for (int q = 0; q < STAGES - 1; ++q) ring_load<C, KT, FLAT, THREADS, STAGES>(r, q);
}

// The shared address of the next tile, landed and visible to the block. The
// barrier also orders every shared-memory write before it (the previous
// GEMM's epilogue) before every read after it, and shows that all warps are
// done with the tile before, whose slot the new load takes.
template <int C, int KT, bool FLAT = C == kWgmmaC, int THREADS = kMmaThreads,
          int STAGES = kStages>
__device__ __forceinline__ uint32_t ring_next(WeightRing& r) {
  cp_async_wait<STAGES - 2>();
  if constexpr (FLAT) {
    // the tensor cores read the tile through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  ring_load<C, KT, FLAT, THREADS, STAGES>(r, r.next + STAGES - 1);
  const uint32_t slot = r.s + (r.next % STAGES) * (KT * (C + kPad) * 2);
  ++r.next;
  return slot;
}

// One GEMM on the tensor cores: D[n_rows, C] = bias + sum over n_steps ring
// tiles i of A[a_row0 + row + shift_i, col_i .. col_i + KR) * tile_i[KR, C],
// where `step(i, shift, col)` names each step's window. A is a bf16 buffer in
// shared memory of row stride AS elements at shared address `a_hi`; with HILO
// a second plane lies `a_lo_bytes` further and every step multiplies both
// into the same accumulator. n_rows <= kMaxRows; lanes of a ragged last tile
// read the last valid row again. Every thread of the block must call this
// (the ring's barriers). Calls epi(row, col, v0, v1) for D[row][col], D[row][col+1].
//
// The `mma.sync` body: warp w of the 16 owns the 16-row tile w (if below
// ceil(n_rows / 16)).
template <int C, int KT, int KR, int AS, bool HILO, typename Step, typename Epi>
__device__ __forceinline__ void gemm_rows_mma(WeightRing& ring, uint32_t a_hi,
                                              uint32_t a_lo_bytes, int a_row0, int n_rows,
                                              int n_steps, Step step,
                                              const float* __restrict__ bias, Epi epi) {
  constexpr int NT = C / 8;  // 8-column tiles of the output
  constexpr int SW = C + kPad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_mt = (n_rows + 15) >> 4;
  float acc[kMT][NT][4];
  bool act[kMT];
  int arow[kMT];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    const int mt = warp + mi * kMmaWarps;
    act[mi] = mt < n_mt;
    arow[mi] = a_row0 + min(mt * 16 + (lane & 15), n_rows - 1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
    }
  }
  // ldmatrix x4 over a 16 x 16 block: lanes 0-15 rows 0-15 at column 0, lanes
  // 16-31 the same rows at column 8; for A and (transposed) for B alike.
  const uint32_t a_lane = a_hi + (lane >> 4) * 16;
  const uint32_t b_lane = ((lane & 15) * SW + (lane >> 4) * 8) * 2;
  for (int i = 0; i < n_steps; ++i) {
    const uint32_t b_tile = ring_next<C, KT>(ring) + b_lane;
    int shift, col;
    step(i, shift, col);
    uint32_t a_addr[kMT];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) a_addr[mi] = a_lane + ((arow[mi] + shift) * AS + col) * 2;
#pragma unroll
    for (int kk = 0; kk < KR; kk += 16) {
      uint32_t a[kMT][4], al[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        if (act[mi]) {
          ldsm_x4(a[mi], a_addr[mi] + kk * 2);
          if constexpr (HILO) ldsm_x4(al[mi], a_addr[mi] + a_lo_bytes + kk * 2);
        }
      }
      uint32_t b[NT / 2][4];  // B fragments of output columns 16*np .. 16*np + 15
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) ldsm_x4_trans(b[np], b_tile + (kk * SW + np * 16) * 2);
      // The hi pass over every accumulator, then the lo pass: a warp runs in
      // order, and the two MMAs of one accumulator depend on each other.
#pragma unroll
      for (int p = 0; p < (HILO ? 2 : 1); ++p) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            if (act[mi]) {
              mma_bf16(acc[mi][2 * np], p ? al[mi] : a[mi], b[np][0], b[np][1]);
              mma_bf16(acc[mi][2 * np + 1], p ? al[mi] : a[mi], b[np][2], b[np][3]);
            }
          }
        }
      }
    }
  }
  // accumulator fragment: lane holds rows g, g + 8 at columns 2*tig, 2*tig + 1
  const int g = lane >> 2, tig = lane & 3;
  float2 b2[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    b2[nt] = __ldg(reinterpret_cast<const float2*>(bias + nt * 8 + tig * 2));
  }
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    if (!act[mi]) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (warp + mi * kMmaWarps) * 16 + g + half * 8;
      if (r >= n_rows) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        epi(r, nt * 8 + tig * 2, acc[mi][nt][2 * half] + b2[nt].x,
            acc[mi][nt][2 * half + 1] + b2[nt].y);
      }
    }
  }
}

// The shared-memory descriptor of a K-major operand without swizzle: 8 x 8
// core matrices of 128 contiguous bytes, `lbo` bytes between the two of a k16
// block, `sbo` bytes between 8-column groups (of B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D(64 x 64, f32, the warpgroup's) += A(64 x 16, bf16, this warp's 16 rows as
// an `ldmatrix` x4 fragment) * B(16 x 64, bf16, shared memory). Asynchronous:
// `wgmma.fence` before, commit and wait after.
__device__ __forceinline__ void wgmma_k16(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The `wgmma` body: N = 64 * NS output columns as NS slices of 64 (one
// m64n64k16 accumulator each), over ring tiles of 64 rows by RTN columns (the
// first 64 * NS of which the GEMM reads). Warpgroup w of the four owns the
// 64-row tile w (if below ceil(n_rows / 64)), warp i of it the rows
// 16 i .. 16 i + 15. Per tap the warp loads its A fragments (KB k16 blocks at
// a time: all four, or two where the lo plane doubles them), issues their
// wgmmas for both planes and every slice as one group and waits for it: the
// A registers and the ring slot are free again when the block meets at the
// next tap's barrier, and the other warpgroups' wgmmas run meanwhile. An A
// fragment feeds all NS slices, so a wider N reads A once for more MMAs, at
// 32 accumulator registers a slice. Calls epi(row, col, v0, v1) for NS = 1,
// else epi(row, col, v) with v[s] the values of columns col, col + 1 of slice
// s (col < 64), so that one call sees column c of every slice. THREADS / 128
// warpgroups cover THREADS / 2 rows; STAGES is the ring's.
template <int AS, bool HILO, int NS = 1, int RTN = 64 * NS, int THREADS = kMmaThreads,
          int STAGES = kStages, typename Step, typename Epi>
__device__ __forceinline__ void gemm_rows_wgmma(WeightRing& ring, uint32_t a_hi,
                                                uint32_t a_lo_bytes, int a_row0, int n_rows,
                                                int n_steps, Step step,
                                                const float* __restrict__ bias, Epi epi) {
  constexpr int NT = 64 / 8, KS = 64 / 16;
  constexpr int KB = HILO ? 2 : 4;
  constexpr int kGroups = THREADS / 128;
  static_assert(RTN >= 64 * NS, "a ring tile holds every slice of the pass");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp >> 2, w4 = warp & 3;
  const int n_mt = (n_rows + 63) >> 6;
  float acc[kMT][NS][NT][4];
  bool act[kMT];
  int arow[kMT];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    const int mt = group + mi * kGroups;
    act[mi] = mt < n_mt;
    arow[mi] = a_row0 + min(mt * 64 + w4 * 16 + (lane & 15), n_rows - 1);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][s][nt][e] = 0.f;
      }
    }
  }
  const uint32_t a_lane = a_hi + (lane >> 4) * 16;
  for (int i = 0; i < n_steps; ++i) {
    // B: the two core matrices of a k16 block 128 bytes apart, 8-column groups
    // 64 / 8 * 128 bytes apart; a k16 block further is 256 bytes further, a
    // slice of 64 columns 8 KB further (the descriptor counts 16 bytes)
    const uint64_t b_desc =
        smem_desc(ring_next<RTN, 64, true, THREADS, STAGES>(ring), 128, 1024);
    int shift, col;
    step(i, shift, col);
    uint32_t a_addr[kMT];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) a_addr[mi] = a_lane + ((arow[mi] + shift) * AS + col) * 2;
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += KB) {
      uint32_t a[kMT][KB][4], al[kMT][KB][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        if (!act[mi]) continue;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          ldsm_x4(a[mi][kk], a_addr[mi] + (k0 + kk) * 32);
          if constexpr (HILO) ldsm_x4(al[mi][kk], a_addr[mi] + a_lo_bytes + (k0 + kk) * 32);
        }
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        if (!act[mi]) continue;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const uint64_t b = b_desc + s * 512 + (k0 + kk) * 16;
            wgmma_k16(acc[mi][s], a[mi][kk], b);
            if constexpr (HILO) wgmma_k16(acc[mi][s], al[mi][kk], b);
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
  }
  // no read of an accumulator moves above the wait
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[mi][s][nt][e])::"memory");
      }
    }
  }
  // accumulator fragment: lane holds rows g, g + 8 at columns 2*tig, 2*tig + 1
  const int g = lane >> 2, tig = lane & 3;
  float2 b2[NT];  // one slice: the biases in registers; more: read where used
  if constexpr (NS == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b2[nt] = __ldg(reinterpret_cast<const float2*>(bias + nt * 8 + tig * 2));
    }
  }
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    if (!act[mi]) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (group + mi * kGroups) * 64 + w4 * 16 + g + half * 8;
      if (r >= n_rows) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + tig * 2;
        float2 v[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float2 bb =
              NS == 1 ? b2[nt] : __ldg(reinterpret_cast<const float2*>(bias + s * 64 + c));
          v[s] = make_float2(acc[mi][s][nt][2 * half] + bb.x, acc[mi][s][nt][2 * half + 1] + bb.y);
        }
        if constexpr (NS == 1) {
          epi(r, c, v[0].x, v[0].y);
        } else {
          epi(r, c, v);
        }
      }
    }
  }
}

template <int C, int KT, int KR, int AS, bool HILO, typename Step, typename Epi>
__device__ __forceinline__ void gemm_rows(WeightRing& ring, uint32_t a_hi, uint32_t a_lo_bytes,
                                          int a_row0, int n_rows, int n_steps, Step step,
                                          const float* __restrict__ bias, Epi epi) {
  if constexpr (C == kWgmmaC) {
    static_assert(KT == 64 && KR == 64, "wgmma tiles are 64 x 64");
    gemm_rows_wgmma<AS, HILO>(ring, a_hi, a_lo_bytes, a_row0, n_rows, n_steps, step, bias, epi);
  } else {
    gemm_rows_mma<C, KT, KR, AS, HILO>(ring, a_hi, a_lo_bytes, a_row0, n_rows, n_steps, step,
                                       bias, epi);
  }
}

}  // namespace
