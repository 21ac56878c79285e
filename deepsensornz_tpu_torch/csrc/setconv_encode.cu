// SetConv encode of a ragged point set onto the internal grid, for sm_90a.
//
// Replaces the TPU kernel deepsensornz_tpu/ops/setconv_pallas.py::encode_offgrid
// (kernel body _encode_kernel). For each task b and grid cell (h, w):
//
//   out[b,h,w,c] = sum_n exp(-(x1g[h]-x[b,n,0])^2 / 2l^2)
//                      * exp(-(x2g[w]-x[b,n,1])^2 / 2l^2) * yaug[b,n,c]
//
// with yaug = [mask, y*mask] (density channel first); the epilogue divides
// the value channels by density + 1e-8 and writes NHWC, density first.
//
// Per task and channel this is a GEMM whose operands live only on chip:
// out_c = W1 (64 rows x N) . (W2 * yaug_c) (N x 64 columns). Design:
//   - one block of 4 warps per (task, 64x64 cell tile); warp w owns rows
//     16w..16w+15 and all 64 columns, as 8 mma tiles of 16x8;
//   - the points are walked in chunks of 32; for each chunk the block
//     builds the row weights W1 (64 x 32, split into TF32 hi/lo, K-major)
//     and the column weights W2 (32 x 64) in shared memory, so every exp is
//     computed once per block and chunk;
//   - the contraction runs on the tensor cores in 3xTF32 (mma.sync m16n8k8,
//     helpers in mma_split.cuh): each B element W2[n,w] * yaug[n,c] is
//     formed and split in registers by each warp (forming it once per block
//     in shared memory measured slower: more shared reads, more registers);
//   - any channel count: the channels are walked in groups of kGroup, each
//     group a full pass over the points with its sums in registers; the
//     density (channel 0, first group) stays in registers for the
//     epilogue's division of the later groups;
//   - ragged point chunks, grid tiles and channel groups are masked in the
//     kernel (zero weights, skipped stores) rather than padded in memory.
// What bounds it on the H100 (measured, PERF.md): not the tensor cores
// (dropping every mma left the time unchanged at the serving shapes: 24
// tasks, 512 stations, 608x608, one value channel, ~18 GFLOP useful) and
// only ~10 % the exps (dropping them); the rest is the per-element work
// around the mma (forming and splitting each B element, shared-memory
// reads) and the three block barriers per 32-point chunk.
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "mma_split.cuh"

namespace {

using namespace setconv;

constexpr int kTile = 64;    // grid rows and columns per block
constexpr int kChunk = 32;   // points per staged chunk
constexpr int kGroup = 2;    // channels per pass over the points
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kW1Stride = kChunk + 4;  // conflict-free A-fragment reads
constexpr int kW2Stride = kTile + 8;   // conflict-free B-fragment reads

__global__ void __launch_bounds__(kThreads)
encode_offgrid_kernel(const float* __restrict__ x1g, const float* __restrict__ x2g,
                      const float* __restrict__ px, const float* __restrict__ y,
                      const float* __restrict__ mask, const float* __restrict__ ls,
                      float* __restrict__ out, int N, int H, int W, int C1) {
  __shared__ uint32_t w1[2][kTile][kW1Stride];  // row weights [hi/lo][row][point]
  __shared__ float w2s[kChunk][kW2Stride];      // column weights [point][column]
  __shared__ float ys[kGroup][kChunk];          // mask-folded values of this group
  __shared__ float p1s[kChunk], p2s[kChunk];
  __shared__ float g1s[kTile], g2s[kTile];

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kTile;
  const int w0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = warp * 16;
  const float lsv = ls[0];

  if (tid < kTile) {
    g1s[tid] = (h0 + tid < H) ? x1g[h0 + tid] : 0.f;
    g2s[tid] = (w0 + tid < W) ? x2g[w0 + tid] : 0.f;
  }

  float dens[8][4];  // channel 0 sums, kept for the value channels' epilogue
  for (int c0 = 0; c0 < C1; c0 += kGroup) {
    float acc[kGroup][8][4];
#pragma unroll
    for (int c = 0; c < kGroup; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;

    for (int n0 = 0; n0 < N; n0 += kChunk) {
      __syncthreads();  // previous chunk fully consumed
      if (tid < kChunk) {
        const int n = n0 + tid;
        const bool ok = n < N;
        const size_t pn = static_cast<size_t>(b) * N + n;
        const float m = ok ? mask[pn] : 0.f;
        p1s[tid] = ok ? px[2 * pn] : 0.f;
        p2s[tid] = ok ? px[2 * pn + 1] : 0.f;
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          const int cg = c0 + c;
          float v = 0.f;
          if (ok && cg < C1) v = cg == 0 ? m : y[pn * (C1 - 1) + (cg - 1)] * m;
          ys[c][tid] = v;
        }
      }
      __syncthreads();
      const int nvalid = min(kChunk, N - n0);
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int n = e % kChunk, r = e / kChunk;
        float v1 = 0.f;
        if (n < nvalid && h0 + r < H) {
          const float d = (g1s[r] - p1s[n]) / lsv;
          v1 = expf(-0.5f * d * d);
        }
        split_tf32(v1, w1[0][r][n], w1[1][r][n]);
        const int n2 = e / kTile, col = e % kTile;
        float v2 = 0.f;
        if (n2 < nvalid && w0 + col < W) {
          const float d = (g2s[col] - p2s[n2]) / lsv;
          v2 = expf(-0.5f * d * d);
        }
        w2s[n2][col] = v2;
      }
      __syncthreads();

#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const int k = ks * 8 + q;
        const uint32_t ahi[4] = {w1[0][r0 + g][k], w1[0][r0 + g + 8][k], w1[0][r0 + g][k + 4],
                                 w1[0][r0 + g + 8][k + 4]};
        const uint32_t alo[4] = {w1[1][r0 + g][k], w1[1][r0 + g + 8][k], w1[1][r0 + g][k + 4],
                                 w1[1][r0 + g + 8][k + 4]};
        float yv[kGroup][2];
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          yv[c][0] = ys[c][k];
          yv[c][1] = ys[c][k + 4];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float wa = w2s[k][8 * j + g], wb = w2s[k + 4][8 * j + g];
#pragma unroll
          for (int c = 0; c < kGroup; ++c) {
            // the B element W2[n,w] * yaug[n,c], the same f32 product the
            // plain version forms before its einsum, split in registers
            uint32_t b0h, b0l, b1h, b1l;
            split_tf32(wa * yv[c][0], b0h, b0l);
            split_tf32(wb * yv[c][1], b1h, b1l);
            mma_3xtf32(acc[c][j], ahi, alo, b0h, b1h, b0l, b1l);
          }
        }
      }
    }

    if (c0 == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dens[j][e] = acc[0][j][e];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = h0 + r0 + g + (e >> 1) * 8;
        const int w = w0 + 8 * j + 2 * q + (e & 1);
        if (h < H && w < W) {
          float* o = out + ((static_cast<size_t>(b) * H + h) * W + w) * C1;
#pragma unroll
          for (int c = 0; c < kGroup; ++c) {
            const int cg = c0 + c;
            if (cg < C1) o[cg] = cg == 0 ? acc[c][j][e] : acc[c][j][e] / (dens[j][e] + 1e-8f);
          }
        }
      }
  }
}

}  // namespace

// x1g (H), x2g (W), px (B,N,2), y (B,N,C1-1), mask (B,N), ls (1): float32,
// contiguous, on one device. out (B,H,W,C1), any C1 >= 1. Returns a
// cudaError_t code.
extern "C" int setconv_encode_offgrid(const float* x1g, const float* x2g, const float* px,
                                      const float* y, const float* mask, const float* ls,
                                      float* out, int B, int N, int H, int W, int C1,
                                      void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (C1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  encode_offgrid_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1g, x2g, px, y, mask, ls, out, N, H, W, C1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* setconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
