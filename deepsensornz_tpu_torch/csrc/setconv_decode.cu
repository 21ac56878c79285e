// Gridded SetConv decode (internal grid -> regular target grid), for sm_90a.
//
// Replaces the TPU kernel deepsensornz_tpu/ops/setconv_pallas.py::decode_grid
// (kernel body _decode_kernel). For each task b and channel c:
//
//   out[b,t,u,c] = sum_h sum_w A[t,h] * f[b,h,w,c] * Bm[w,u]
//
// optionally divided by sA[t] * sB[u] + 1e-8 (sA = sum_h A, sB = sum_w Bm).
// The wrapper builds the RBF weights and their sums in plain torch, as the
// Pallas wrapper builds them in XLA, and hands A over split and Bm in
// fragment order (below); both contractions and the normalisation are this
// kernel's body.
//
// Design (one block per block tile, 64 target rows x one block of up to 11
// target-column tiles of 8, x one (task, channel) plane; 4 consumer warps =
// one warpgroup of 16 target rows each, plus 1 producer warp):
//   - Stage 1, T[t, w] = sum_h A[t, h] f[h, w] for a chunk of 64 source
//     columns, on the tensor cores. A arrives split in three bf16 parts
//     (hi, mid, lo: 24 mantissa bits). For bf16 f (the U-Net's bf16 output,
//     read without widening) every partial product is exact: 3 passes of
//     wgmma m64n64k16 per 16 source rows, A K-major and f N-major
//     (transposed) straight from the TMA tiles. For f32 f each consumer
//     splits the f values it reads from shared memory into bf16
//     hi/mid/lo and runs the 6 passes whose weight is >= 2^-16 (hi.hi,
//     hi.mid, mid.hi, hi.lo, lo.hi, mid.mid) with mma.sync m16n8k16, the
//     A parts read with ldmatrix.
//   - Stage 2, acc[t, u] += T[t, w] Bm[w, u], in 3xTF32 with mma.sync
//     m16n8k8. T's accumulators (the wgmma D layout is the mma.sync C
//     layout, per warp) are the A operand straight from registers, the way
//     FlashAttention feeds P.V: the k order inside each 8-column step is
//     permuted (k = q <-> w = 2q, k = q+4 <-> w = 2q+1) so that the C
//     fragment is the A fragment, and the wrapper lays Bm out in the same
//     permuted fragment order; the producer bulk-copies the tiles of a chunk
//     into shared memory, one 8-byte read per lane and step. mma.sync and
//     not wgmma here: a register A operand must be K-major for TF32, and T's
//     D layout gives it with no shuffle only per 16-row warp. The
//     accumulator, 64 rows x 88 target columns (260 = 3 x 88 - 4), stays in
//     registers; wider grids take more blocks.
//   - The source rows [klo, khi) are walked in windows of 4 blocks of 64: a
//     window of A (3 parts, 96 KB) is loaded once by TMA and stays in shared
//     memory while the source-column chunks stream their f tiles past it
//     through a 6-stage TMA ring (128-byte swizzle, full/empty mbarriers,
//     one producer thread ahead of the warpgroup).
//   - Zero weight blocks are skipped, exactly: the wrapper derives from A
//     and Bm the source-row blocks each target-row tile touches and the
//     source-column chunks each target-column block touches. A weight that
//     is exactly 0 contributes exactly 0 to a finite sum, so no finite
//     result changes; a non-finite f value inside a skipped block no longer
//     turns the output NaN. At the serving length-scale a 64-row tile
//     touches 3-4 of 9.5 source-row blocks.
//   - The block writes its plane channel-first, (b, c, Ht, Wt), with
//     contiguous rows; a second small kernel transposes (B, C, Ht*Wt) to the
//     (B, Ht, Wt, C) the head reads, through 32x32 shared-memory tiles, so
//     neither kernel scatters 4-byte stores at a stride of C.
//   - Live tiles: a caller that needs only a list of target cells (the land
//     cells of a served map) passes them with the block tiles that hold at
//     least one of them (the wrapper derives the list on the host). The grid
//     is then those live tiles x planes, so a tile without a listed cell
//     costs no launch; a live block runs exactly as in the full launch
//     (the same stages, skip ranges and sums), so each listed cell's value
//     is bitwise the full launch's. Each block writes its 64 x (tiles x 8)
//     tile into a compact channel-first slot, (b, c, live tile, 64, 88), and
//     the second kernel, in place of the transpose, gathers the listed cells
//     from the slots into (B, cells, C): a cell's slot is found by binary
//     search of the ascending live list. On the WRF grid with NZ's land
//     (15.8 % of the cells) 112 of 330 tiles are live.
//   - Blocks that share a (task, channel) plane are adjacent in blockIdx.x
//     and run together, so the plane is read from device memory once.
// What bounds it on the H100: a launch's time follows its count of live
// tiles (a live tile costs what it costs in the full launch, PERF.md); per
// tile, measured on the full grid, not the L2-to-SM bytes
// (keeping A resident cut them 2.4x and changed nothing), not stage 1's
// tensor issue (wgmma in place of mma.sync changed nothing), not occupancy
// (two blocks per SM changed nothing). It issues ~900 GFLOP of split
// products for 450 useful at ~200 TFLOP/s, one block of one warpgroup per
// SM doing stage 1, then stage 2, in turn; stage 2 on mma.sync is the part
// that moved the time. (The earlier SIMT design was bound by moving f from L2
// into the SM, one 32-byte sector per pixel per block, not by its FMAs.)
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the C entry point returns the first CUDA error.

#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_split.cuh"

namespace {

using namespace setconv;

constexpr int kRows = 64;           // target rows per block (4 warps x 16)
constexpr int kK = 64;              // source rows per k-block
constexpr int kCols = 64;           // source columns per chunk
constexpr int kWindow = 4;          // k-blocks of A resident in shared memory at once
constexpr int kStages = 6;          // depth of the f ring
constexpr int kConsumers = 4;       // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kMaxTiles = 11;       // target-column tiles of 8 per block (260 = 3 x 11 x 8 - 4)
constexpr int kPartBytes = kRows * kK * 2;   // one bf16 part of an A tile
constexpr int kABytes = 3 * kPartBytes;      // one k-block of A, three parts
constexpr int kTileBBytes = 8 * 32 * 8;      // stage-2 fragments of one 8-column tile
constexpr int kBBytes = kMaxTiles * kTileBBytes;
// wgmma descriptor byte offsets: K-major A tiles step 1024 bytes per 8-row
// atom (the leading offset is unused under the swizzle); the N-major f tile
// steps 1024 bytes per 8 source rows, and its leading offset (the next
// 64-column atom) is unused with one atom per tile
constexpr uint32_t kAtom = 1024;

template <bool kF32>
struct Stage {
  static constexpr int kFBytes = kK * kCols * (kF32 ? 4 : 2);  // one f tile
  // A window, f ring, stage-2 fragments, 2 * (kStages + 2) barriers, align slack
  static constexpr int kSmem =
      kWindow * kABytes + kStages * kFBytes + kBBytes + 2 * (kStages + 2) * 8 + 1024;
};

struct DecodeArgs {
  const float2* bfrag;  // stage-2 Bm fragments: [W/64 chunks][NTg tiles][8 steps][32 lanes]
  const float* sA;      // (Ht) or null: no normalisation
  const float* sB;      // (Wt)
  const int* ranges;    // klo[nTT] khi[nTT] wlo[nUT] whi[nUT]
  const int* live;      // the live block tiles (ut * nTT + tt), ascending; null: every tile
  float* out;           // (B*C, Ht, Wt); with live, (B*C, n_live, kRows, tiles_per_ut * 8)
  int Ht, Wt, nTT, nUT, NTg, tiles_per_ut, n_live;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One warp's part in releasing a buffer: its reads are done.
__device__ __forceinline__ void warp_release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// Byte offset of 16-byte chunk `chunk` of 128-byte row `row` in a tile that
// TMA wrote with CU_TENSOR_MAP_SWIZZLE_128B (tile base 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma descriptor of a tile that TMA wrote with the 128-byte swizzle (rows
// of 128 bytes, 1024-byte aligned atoms of 8 rows): start address, leading
// and stride byte offsets, layout 1 = SWIZZLE_128B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 64 over the warpgroup; per warp the mma.sync C layout of 8 tiles)
// += A (64 x 16, K-major) * B (16 x 64, N-major: transposed), bf16 in.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A ring position: slot and the parity of its current use.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ void next(int n) {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

template <bool kF32>
__global__ void __launch_bounds__(kThreads, 1)
decode_grid_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmF,
                   const DecodeArgs p) {
  using S = Stage<kF32>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* abuf = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* fbuf = abuf + kWindow * kABytes;    // the f ring
  uint8_t* bbuf = fbuf + kStages * S::kFBytes;  // this chunk's stage-2 fragments
  uint64_t* full = reinterpret_cast<uint64_t*>(bbuf + kBBytes);
  uint64_t* empty = full + kStages;
  uint64_t* afull = empty + kStages;
  uint64_t* aempty = afull + 1;
  uint64_t* bfull = afull + 2;
  uint64_t* bempty = afull + 3;

  const int tile = p.live != nullptr ? p.live[blockIdx.x] : blockIdx.x;
  const int tt = tile % p.nTT;
  const int ut = tile / p.nTT;
  const int bc = blockIdx.y;
  const int* R = p.ranges;
  const int klo = R[tt], khi = R[p.nTT + tt];
  const int wlo = R[2 * p.nTT + ut], whi = R[2 * p.nTT + p.nUT + ut];
  const int n0 = ut * p.tiles_per_ut;
  const int n_here = min(p.tiles_per_ut, p.NTg - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(afull, 1);
    mbar_init(aempty, kConsumers);
    mbar_init(bfull, 1);
    mbar_init(bempty, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The source rows [klo, khi) are walked in windows of kWindow k-blocks:
  // a window of A stays in shared memory while every source-column chunk
  // streams its f tiles past it. At the serving length-scale one window
  // holds the whole range; a wider one adds stage-2 passes, one a window.
  if (warp == kConsumers) {  // producer: one thread issues every copy
    if (lane == 0) {
      Ring f, a, b;
      for (int k0 = klo; k0 < khi; k0 += kWindow) {
        const int k1 = min(k0 + kWindow, khi);
        mbar_wait(aempty, a.phase ^ 1);
        mbar_expect_tx(afull, (k1 - k0) * kABytes);
        for (int kb = k0; kb < k1; ++kb)
          tma_load_3d(abuf + (kb - k0) * kABytes, &tmA, kb * kK, tt * kRows, 0, afull);
        a.next(1);
        for (int wc = wlo; wc < whi; ++wc) {
          for (int kb = k0; kb < k1; ++kb) {
            mbar_wait(&empty[f.slot], f.phase ^ 1);
            mbar_expect_tx(&full[f.slot], S::kFBytes);
            uint8_t* dst = fbuf + f.slot * S::kFBytes;
            if constexpr (kF32) {
              tma_load_3d(dst, &tmF, wc * kCols, kb * kK, bc, &full[f.slot]);
              tma_load_3d(dst + S::kFBytes / 2, &tmF, wc * kCols + kCols / 2, kb * kK, bc,
                          &full[f.slot]);
            } else {
              tma_load_3d(dst, &tmF, wc * kCols, kb * kK, bc, &full[f.slot]);
            }
            f.next(kStages);
          }
          // the chunk's stage-2 fragments, once the last chunk's stage 2 is done
          mbar_wait(bempty, b.phase ^ 1);
          mbar_expect_tx(bfull, n_here * kTileBBytes);
          bulk_load(bbuf, p.bfrag + (static_cast<size_t>(wc) * p.NTg + n0) * 8 * 32,
                    n_here * kTileBBytes, bfull);
          b.next(1);
        }
      }
    }
    return;
  }

  const int g = lane >> 2, q = lane & 3;
  const int row0 = warp * 16;
  // ldmatrix roles (f32 path): lane gives row (lane & 7) of matrix (lane >> 3)
  const int a_row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int hi16 = lane >> 4;

  float acc[kMaxTiles][4];
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  Ring f, a, b;
  for (int k0 = klo; k0 < khi; k0 += kWindow) {
    const int k1 = min(k0 + kWindow, khi);
    mbar_wait(afull, a.phase);
    for (int wc = wlo; wc < whi; ++wc) {
      // ---- stage 1: T (16 x 64 per warp) = A (16 x K) f (K x 64) ----
      float t[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
      for (int kb = k0; kb < k1; ++kb) {
        mbar_wait(&full[f.slot], f.phase);
        const uint32_t sa = smem_addr(abuf + (kb - k0) * kABytes);
        const uint32_t sf = smem_addr(fbuf + f.slot * S::kFBytes);
        if constexpr (!kF32) {
          // the warpgroup's 64 x 64 T tile, A's three parts against bf16 f
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kK / 16; ++ks)
#pragma unroll
            for (int part = 2; part >= 0; --part)
              wgmma_64x64x16(t, desc_sw128(sa + part * kPartBytes + ks * 32, 16, kAtom),
                             desc_sw128(sf + ks * 16 * 128, kAtom * 8, kAtom));
          wgmma_commit_and_wait();
        } else {
#pragma unroll
          for (int ks = 0; ks < kK / 16; ++ks) {
            uint32_t ap[3][4];  // hi, mid, lo
#pragma unroll
            for (int part = 0; part < 3; ++part)
              ldsm_x4(ap[part], sa + part * kPartBytes + swz(a_row, 2 * ks + hi16));
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int w = 8 * nt + g;
              const uint32_t fcol = sf + (w >> 5) * (S::kFBytes / 2) + (w & 3) * 4;
              __nv_bfloat16 h[4], m[4], l[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int k = 16 * ks + 2 * q + (i & 1) + (i >> 1) * 8;
                float v;
                asm volatile("ld.shared.f32 %0, [%1];\n"
                             : "=f"(v)
                             : "r"(fcol + swz(k, (w & 31) >> 2)));
                split_bf16x3(v, h[i], m[i], l[i]);
              }
              const uint32_t bh0 = pack_bf16(h[0], h[1]), bh1 = pack_bf16(h[2], h[3]);
              const uint32_t bm0 = pack_bf16(m[0], m[1]), bm1 = pack_bf16(m[2], m[3]);
              const uint32_t bl0 = pack_bf16(l[0], l[1]), bl1 = pack_bf16(l[2], l[3]);
              mma_bf16(t[nt], ap[1], bm0, bm1);  // mid.mid
              mma_bf16(t[nt], ap[2], bh0, bh1);  // lo.hi
              mma_bf16(t[nt], ap[0], bl0, bl1);  // hi.lo
              mma_bf16(t[nt], ap[1], bh0, bh1);  // mid.hi
              mma_bf16(t[nt], ap[0], bm0, bm1);  // hi.mid
              mma_bf16(t[nt], ap[0], bh0, bh1);  // hi.hi
            }
          }
        }
        warp_release(&empty[f.slot], lane);
        f.next(kStages);
      }

      // ---- stage 2: acc (16 x tiles*8) += T (16 x 64) Bm (64 x tiles*8) ----
      mbar_wait(bfull, b.phase);
      const float2* bf = reinterpret_cast<const float2*>(bbuf) + lane;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // C fragment -> A fragment under the permuted k order (see header)
        uint32_t ahi[4], alo[4];
        split_tf32(t[j][0], ahi[0], alo[0]);
        split_tf32(t[j][2], ahi[1], alo[1]);
        split_tf32(t[j][1], ahi[2], alo[2]);
        split_tf32(t[j][3], ahi[3], alo[3]);
        // every tile, unpredicated (tiles past n_here hold stale fragments;
        // their sums are never stored), passes outermost so that kMaxTiles
        // independent products separate dependent ones
        uint32_t bh[kMaxTiles][2], bl[kMaxTiles][2];
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) {
          const float2 bv = bf[(i * 8 + j) * 32];
          split_tf32(bv.x, bh[i][0], bl[i][0]);
          split_tf32(bv.y, bh[i][1], bl[i][1]);
        }
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) mma_tf32(acc[i], alo, bh[i][0], bh[i][1]);
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) mma_tf32(acc[i], ahi, bl[i][0], bl[i][1]);
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) mma_tf32(acc[i], ahi, bh[i][0], bh[i][1]);
      }
      warp_release(bempty, lane);
      b.next(1);
    }
    warp_release(aempty, lane);
    a.next(1);
  }

  // ---- epilogue: normalise, write the plane's rows (channel-first): into
  // the whole plane, or into this live tile's slot ----
  const int wb = p.tiles_per_ut * 8;
  const bool own = p.live != nullptr;  // write this live tile's own slot
  float* out = p.out + (own ? (static_cast<size_t>(bc) * p.n_live + blockIdx.x) * kRows * wb
                            : static_cast<size_t>(bc) * p.Ht * p.Wt);
  const int pitch = own ? wb : p.Wt;
  const int r0 = own ? tt * kRows : 0, c0 = own ? n0 * 8 : 0;
  const int tbase = tt * kRows + row0 + g;
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    if (i < n_here) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tr = tbase + (e >> 1) * 8;
        const int u = (n0 + i) * 8 + 2 * q + (e & 1);
        if (tr < p.Ht && u < p.Wt) {
          float v = acc[i][e];
          if (p.sA != nullptr) v = v / (p.sA[tr] * p.sB[u] + 1e-8f);
          out[static_cast<size_t>(tr - r0) * pitch + (u - c0)] = v;
        }
      }
    }
  }
}

// Without cells: (B, C, P) -> (B, P, C) through 32x32 shared-memory tiles.
// With cells (P of them, flat indices into Ht x Wt): (B, P, C) gathered from
// the live tiles' slots (B, C, n_live, kRows, wb), through the same tiles; a
// cell whose tile is not in the live list comes out NaN.
__global__ void __launch_bounds__(256)
channels_last_kernel(const float* __restrict__ in, float* __restrict__ out, int C, int P,
                     const long long* __restrict__ cells, const int* __restrict__ live,
                     int n_live, int nTT, int Wt, int wb) {
  __shared__ float tile[32][33];
  __shared__ long long src[32];  // with cells: each column's offset in its plane, -1 if none
  const int b = blockIdx.z, p0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  size_t plane = P;
  if (cells != nullptr) {
    plane = static_cast<size_t>(n_live) * kRows * wb;
    if (ty == 0 && p0 + tx < P) {
      const long long cell = cells[p0 + tx];
      const int tr = static_cast<int>(cell / Wt), u = static_cast<int>(cell % Wt);
      const int want = u / wb * nTT + tr / kRows;
      int lo = 0, hi = n_live;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (live[mid] < want) lo = mid + 1; else hi = mid;
      }
      src[tx] = lo < n_live && live[lo] == want
                    ? (static_cast<long long>(lo) * kRows + tr % kRows) * wb + u % wb
                    : -1;
    }
    __syncthreads();
  }
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, pp = p0 + tx;
    if (c < C && pp < P) {
      const long long at = cells == nullptr ? pp : src[tx];
      tile[i][tx] = at < 0 ? __int_as_float(0x7fc00000)
                           : in[(static_cast<size_t>(b) * C + c) * plane + at];
    }
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int pp = p0 + i, c = c0 + tx;
    if (pp < P && c < C) out[(static_cast<size_t>(b) * P + pp) * C + c] = tile[tx][i];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D tiled map, innermost dimension first, 128-byte swizzle, zero fill
// outside the tensor.
bool make_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem, const void* ptr,
              const cuuint64_t (&dims)[3], const cuuint32_t (&box)[3]) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t strides[2] = {dims[0] * elem, dims[0] * dims[1] * elem};
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, dtype, 3, const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kF32>
int launch_decode(const CUtensorMap& tmA, const CUtensorMap& tmF, const DecodeArgs& args, int BC,
                  cudaStream_t stream) {
  const int smem = Stage<kF32>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(decode_grid_kernel<kF32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(args.live != nullptr ? args.n_live : args.nTT * args.nUT, BC);
  decode_grid_kernel<kF32><<<grid, kThreads, smem, stream>>>(tmA, tmF, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a3: (3, Htp, Hp) bf16, A = hi + mid + lo zero-padded to multiples of 64.
// f: (B*C, H, Wq) bf16 (f_is_f32 = 0) or f32, channel-first, Wq % 8 == 0.
// bfrag: stage-2 fragments of Bm, (W/64 chunks, NTg, 8, 32, 2) f32.
// sA (Ht) and sB (Wt) or both null; ranges as in DecodeArgs.
// live: null, every target cell: out_cf (B*C, Ht, Wt) scratch, out (B, Ht, Wt, C).
// Else the n_live live block tiles (ascending ut * nTT + tt) of the n_cells
// cells (flat indices into Ht x Wt): out_cf (B*C, n_live, 64, tiles_per_ut * 8)
// scratch, out (B, n_cells, C). Returns a cudaError_t.
extern "C" int setconv_decode_grid(const void* a3, const void* f, int f_is_f32,
                                   const float* bfrag, const float* sA, const float* sB,
                                   const int* ranges, const int* live, int n_live,
                                   const long long* cells, int n_cells, float* out_cf,
                                   float* out, int B, int C, int H, int Wq, int Htp, int Hp,
                                   int Ht, int Wt, int nTT, int nUT, int NTg, int tiles_per_ut,
                                   void* stream) {
  if (B == 0 || C == 0 || Ht == 0 || Wt == 0) return 0;
  if (live != nullptr && (n_live == 0 || n_cells == 0)) return 0;
  if (tiles_per_ut > kMaxTiles || Htp % kRows != 0 || Hp % kK != 0 || Wq % 8 != 0 ||
      B * C > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tmA, tmF;
  if (!make_map(&tmA, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a3,
                {(cuuint64_t)Hp, (cuuint64_t)Htp, 3}, {kK, kRows, 3}))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = f_is_f32 != 0;
  if (!make_map(&tmF, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                f32 ? 4 : 2, f, {(cuuint64_t)Wq, (cuuint64_t)H, (cuuint64_t)B * C},
                {f32 ? kCols / 2u : (cuuint32_t)kCols, kK, 1}))
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs args{reinterpret_cast<const float2*>(bfrag), sA, sB, ranges, live, out_cf,
                        Ht, Wt, nTT, nUT, NTg, tiles_per_ut, n_live};
  int rc = f32 ? launch_decode<true>(tmA, tmF, args, B * C, s)
               : launch_decode<false>(tmA, tmF, args, B * C, s);
  if (rc != 0) return rc;
  const int P = live == nullptr ? Ht * Wt : n_cells;
  const dim3 grid((P + 31) / 32, (C + 31) / 32, B);
  channels_last_kernel<<<grid, dim3(32, 8), 0, s>>>(out_cf, out, C, P,
                                                    live == nullptr ? nullptr : cells, live,
                                                    n_live, nTT, Wt, tiles_per_ut * 8);
  return static_cast<int>(cudaGetLastError());
}
