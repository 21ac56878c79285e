// Gridded SetConv decode (internal grid -> regular target grid), for sm_90a.
//
// Replaces the TPU kernel deepsensornz_tpu/ops/setconv_pallas.py::decode_grid
// (kernel body _decode_kernel). For each task b and channel c:
//
//   out[b,t,u,c] = sum_h sum_w A[t,h] * f[b,h,w,c] * Bm[w,u]
//
// optionally divided by sA[t] * sB[u] + 1e-8, where sA = sum_h A and
// sB = sum_w Bm (the separable normaliser). The wrapper builds the RBF
// weights A (Ht,H), Bm (W,Wt) and the two sums in plain torch, as the
// Pallas wrapper builds them in XLA; both contractions and the
// normalisation epilogue are this kernel's body. Accumulation is strict
// f32 (CUDA-core FMAs, no TF32).
//
// What bounds it on the H100: f32 FMAs. At the serving shapes (24 tasks,
// 64 channels, 608x608 -> 278x260) the two contractions are ~450 GFLOP,
// and the plain version also writes and re-reads a (B, Ht, W, C)
// intermediate of ~1 GB. The design keeps that intermediate on chip:
//   - one block of 512 threads per (target-row tile of 16, channel block
//     of 8, task, target-column tile of up to 384);
//   - the source columns are walked in chunks of 64. Phase 1 contracts the
//     source rows for the chunk: thread (w, c) streams f[b, :, w, c] and
//     keeps 16 target-row sums in registers, with the A chunk staged in
//     shared memory; the (16, 64, 8) partial product goes to shared memory.
//     Phase 2 contracts the chunk's source columns into the (16*8, Wt)
//     output accumulator, which lives in shared memory for the whole block;
//   - blockIdx.x walks the target-row tiles fastest, so the blocks that
//     read the same (task, channel block) slab of f run together and share
//     it through L2;
//   - ragged source rows/columns, channels and target tiles are masked in
//     the kernel instead of zero-padded in memory.
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;      // target rows per block
constexpr int kChan = 8;       // channels per block
constexpr int kCols = 64;      // source columns per chunk
constexpr int kDepth = 32;     // source rows per staged A chunk
constexpr int kThreads = 512;  // = kCols * kChan = kDepth * kRows
constexpr int kLanes = 16;     // phase-2 threads sharing one row group
constexpr int kMaxTile = 384;  // widest target-column tile

static_assert(kThreads == kCols * kChan, "phase-1 mapping");
static_assert(kThreads == kDepth * kRows, "A staging mapping");
static_assert(kThreads == (kRows * kChan / 4) * kLanes, "phase-2 mapping");

__global__ void __launch_bounds__(kThreads, 1)
decode_grid_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ f, const float* __restrict__ sA,
                   const float* __restrict__ sB, float* __restrict__ out,
                   int H, int W, int C, int Ht, int Wt, int tile) {
  extern __shared__ __align__(16) float smem[];
  float* acc_s = smem;                      // [kRows*kChan][tile], row = t*kChan + c
  float* t_s = smem + kRows * kChan * tile;  // [kCols][kRows][kChan]
  __shared__ __align__(16) float a_s[kDepth][kRows];

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kChan;
  const int n_tiles = (Wt + tile - 1) / tile;
  const int b = blockIdx.z / n_tiles;
  const int u0 = (blockIdx.z % n_tiles) * tile;
  const int ut = min(tile, Wt - u0);

  for (int i = tid; i < kRows * kChan * tile; i += kThreads) acc_s[i] = 0.f;

  // phase-1 role: one (source column, channel) pair
  const int wl = tid / kChan, cl = tid % kChan;
  const int c = c0 + cl;
  // A staging role: one (source row, target row) entry
  const int ak = tid / kRows, at = tid % kRows;
  // phase-2 role: 4 consecutive rows (one target row, 4 channels) x lanes
  const int grp = tid / kLanes, lane = tid % kLanes;
  const int pt = grp / 2, pc = (grp % 2) * 4;

  const float* fb = f + (size_t)b * H * W * C;

  for (int w0 = 0; w0 < W; w0 += kCols) {
    const int w = w0 + wl;
    const bool fvalid = (w < W) && (c < C);
    float acc1[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc1[t] = 0.f;

    for (int h0 = 0; h0 < H; h0 += kDepth) {
      __syncthreads();  // a_s free; on the first pass also orders acc_s init
      {
        const int h = h0 + ak, tg = t0 + at;
        a_s[ak][at] = (h < H && tg < Ht) ? A[(size_t)tg * H + h] : 0.f;
      }
      __syncthreads();
      if (fvalid) {
        const int kmax = min(kDepth, H - h0);
        const float* fp = fb + ((size_t)h0 * W + w) * C + c;
        const size_t stride = (size_t)W * C;
#pragma unroll 8
        for (int k = 0; k < kmax; ++k) {
          const float fv = __ldg(fp + k * stride);
          const float4* ar = reinterpret_cast<const float4*>(a_s[k]);
#pragma unroll
          for (int q = 0; q < kRows / 4; ++q) {
            const float4 a = ar[q];
            acc1[4 * q + 0] = fmaf(a.x, fv, acc1[4 * q + 0]);
            acc1[4 * q + 1] = fmaf(a.y, fv, acc1[4 * q + 1]);
            acc1[4 * q + 2] = fmaf(a.z, fv, acc1[4 * q + 2]);
            acc1[4 * q + 3] = fmaf(a.w, fv, acc1[4 * q + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) t_s[(wl * kRows + t) * kChan + cl] = acc1[t];
    __syncthreads();

    // phase 2: acc[(pt, pc..pc+3)][u] += sum_k t_s[k][pt][pc..] * Bm[w0+k][u0+u]
    const int kw = min(kCols, W - w0);
    const float* bm = Bm + (size_t)w0 * Wt + u0;
    for (int ub = lane; ub < ut; ub += 4 * kLanes) {
      int ui[4];
      bool ok[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ui[i] = ub + kLanes * i;
        ok[i] = ui[i] < ut;
        if (!ok[i]) ui[i] = ub;  // in range; its sums are discarded
      }
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = acc_s[(pt * kChan + pc + j) * tile + ui[i]];
#pragma unroll 4
      for (int k = 0; k < kw; ++k) {
        const float4 tv = *reinterpret_cast<const float4*>(&t_s[(k * kRows + pt) * kChan + pc]);
        const float* bk = bm + (size_t)k * Wt;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bv = __ldg(bk + ui[i]);
          o[i][0] = fmaf(tv.x, bv, o[i][0]);
          o[i][1] = fmaf(tv.y, bv, o[i][1]);
          o[i][2] = fmaf(tv.z, bv, o[i][2]);
          o[i][3] = fmaf(tv.w, bv, o[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ok[i])
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_s[(pt * kChan + pc + j) * tile + ui[i]] = o[i][j];
    }
    // the next chunk's first __syncthreads orders these t_s reads before
    // t_s is rewritten; acc_s entries are owned by one thread throughout
  }
  __syncthreads();

  for (int i = tid; i < kRows * ut * kChan; i += kThreads) {
    const int cc = i % kChan;
    const int u = (i / kChan) % ut;
    const int t = i / (kChan * ut);
    const int tg = t0 + t, ug = u0 + u, cg = c0 + cc;
    if (tg < Ht && cg < C) {
      float v = acc_s[(t * kChan + cc) * tile + u];
      if (sA != nullptr) v = v / (sA[tg] * sB[ug] + 1e-8f);
      out[(((size_t)b * Ht + tg) * Wt + ug) * C + cg] = v;
    }
  }
}

}  // namespace

// A (Ht,H), Bm (W,Wt), f (B,H,W,C), sA (Ht) and sB (Wt) or both null for no
// normalisation: float32, contiguous, on one device. out (B,Ht,Wt,C).
// Returns a cudaError_t code.
extern "C" int setconv_decode_grid(const float* A, const float* Bm, const float* f,
                                   const float* sA, const float* sB, float* out,
                                   int B, int H, int W, int C, int Ht, int Wt,
                                   void* stream) {
  if (B == 0 || C == 0 || Ht == 0 || Wt == 0) return 0;
  const int tile = Wt <= kMaxTile ? ((Wt + 15) / 16) * 16 : kMaxTile;
  const int n_tiles = (Wt + tile - 1) / tile;
  const size_t smem = (size_t)(kRows * kChan * tile + kCols * kRows * kChan) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Ht + kRows - 1) / kRows, (C + kChan - 1) / kChan, B * n_tiles);
  decode_grid_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, Bm, f, sA, sB, out, H, W, C, Ht, Wt, tile);
  return static_cast<int>(cudaGetLastError());
}
