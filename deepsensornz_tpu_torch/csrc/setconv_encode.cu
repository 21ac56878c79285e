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
// What bounds it on the H100: f32 arithmetic on the CUDA cores. At the
// serving shapes (24 tasks, 512 stations, 608x608 grid, one value channel)
// it is ~24*608*608*512 RBF products plus 2 FMAs each, ~18 GFLOP, against
// ~10 MB of output; the separable plain version instead writes a
// (B, N, W, C+1) temporary to device memory. The design keeps everything
// but the output on chip:
//   - one block per (task, 64-row tile, 64-column tile); 256 threads, each
//     owning a 4x4 micro-tile of cells with all C+1 channel sums in
//     registers;
//   - the point set is walked in chunks of 64 staged in shared memory
//     (coordinates, mask-folded values); for each chunk the block builds
//     the 64x64 row and column RBF weight tables in shared memory, so every
//     exp is computed once per block and reused by 64 cells;
//   - all N points accumulate inside the block: the TPU kernel's
//     accumulation across a sequential grid axis has no GPU counterpart,
//     and nothing here needs atomics;
//   - ragged point chunks and ragged grid tiles are masked in the kernel
//     (zero weights, skipped stores) rather than padded in memory.
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 64;   // grid rows per block
constexpr int kTileW = 64;   // grid columns per block
constexpr int kChunk = 64;   // points per staged chunk
constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kRowsPerThread = kTileH / kThreadsY;  // 4
constexpr int kColsPerThread = kTileW / kThreadsX;  // 4
constexpr int kMaxChannels = 8;                     // density + up to 7 values

template <int C1>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
encode_offgrid_kernel(const float* __restrict__ x1g, const float* __restrict__ x2g,
                      const float* __restrict__ px, const float* __restrict__ y,
                      const float* __restrict__ mask, const float* __restrict__ ls,
                      float* __restrict__ out, int N, int H, int W) {
  __shared__ float w1s[kChunk][kTileH];   // row weights  [point][row]
  __shared__ float w2s[kChunk][kTileW];   // col weights  [point][col]
  __shared__ float ys[C1][kChunk];        // mask-folded values, density first
  __shared__ float p1s[kChunk], p2s[kChunk];
  __shared__ float g1s[kTileH], g2s[kTileW];

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kTileH;
  const int w0 = blockIdx.x * kTileW;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const float lsv = ls[0];

  if (tid < kTileH) g1s[tid] = (h0 + tid < H) ? x1g[h0 + tid] : 0.f;
  if (tid < kTileW) g2s[tid] = (w0 + tid < W) ? x2g[w0 + tid] : 0.f;

  float acc[kRowsPerThread][kColsPerThread][C1];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
#pragma unroll
      for (int c = 0; c < C1; ++c) acc[i][j][c] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kChunk) {
    __syncthreads();  // previous chunk fully consumed
    if (tid < kChunk) {
      const int n = n0 + tid;
      if (n < N) {
        const size_t pn = (size_t)b * N + n;
        const float m = mask[pn];
        p1s[tid] = px[2 * pn];
        p2s[tid] = px[2 * pn + 1];
        ys[0][tid] = m;
#pragma unroll
        for (int c = 1; c < C1; ++c) ys[c][tid] = y[pn * (C1 - 1) + (c - 1)] * m;
      } else {
        p1s[tid] = 0.f;
        p2s[tid] = 0.f;
#pragma unroll
        for (int c = 0; c < C1; ++c) ys[c][tid] = 0.f;
      }
    }
    __syncthreads();
    const int nvalid = min(kChunk, N - n0);
    for (int e = tid; e < kChunk * kTileH; e += kThreadsX * kThreadsY) {
      const int n = e / kTileH, h = e % kTileH;
      float v = 0.f;
      if (n < nvalid && h0 + h < H) {
        const float q = (g1s[h] - p1s[n]) / lsv;
        v = expf(-0.5f * q * q);
      }
      w1s[n][h] = v;
    }
    for (int e = tid; e < kChunk * kTileW; e += kThreadsX * kThreadsY) {
      const int n = e / kTileW, w = e % kTileW;
      float v = 0.f;
      if (n < nvalid && w0 + w < W) {
        const float q = (g2s[w] - p2s[n]) / lsv;
        v = expf(-0.5f * q * q);
      }
      w2s[n][w] = v;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < nvalid; ++n) {
      float a[kRowsPerThread], bw[kColsPerThread], yv[C1];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = w1s[n][ty + kThreadsY * i];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) bw[j] = w2s[n][tx + kThreadsX * j];
#pragma unroll
      for (int c = 0; c < C1; ++c) yv[c] = ys[c][n];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const float t = a[i] * bw[j];
#pragma unroll
          for (int c = 0; c < C1; ++c) acc[i][j][c] = fmaf(t, yv[c], acc[i][j][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int h = h0 + ty + kThreadsY * i;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int w = w0 + tx + kThreadsX * j;
      if (h < H && w < W) {
        float* o = out + (((size_t)b * H + h) * W + w) * C1;
        const float den = acc[i][j][0];
        o[0] = den;
#pragma unroll
        for (int c = 1; c < C1; ++c) o[c] = acc[i][j][c] / (den + 1e-8f);
      }
    }
  }
}

template <int C1>
void launch(const float* x1g, const float* x2g, const float* px, const float* y,
            const float* mask, const float* ls, float* out, int B, int N, int H,
            int W, cudaStream_t stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  const dim3 block(kThreadsX, kThreadsY);
  encode_offgrid_kernel<C1><<<grid, block, 0, stream>>>(x1g, x2g, px, y, mask, ls,
                                                        out, N, H, W);
}

}  // namespace

// x1g (H), x2g (W), px (B,N,2), y (B,N,C1-1), mask (B,N), ls (1): float32,
// contiguous, on one device. out (B,H,W,C1). Returns a cudaError_t code.
extern "C" int setconv_encode_offgrid(const float* x1g, const float* x2g,
                                      const float* px, const float* y,
                                      const float* mask, const float* ls,
                                      float* out, int B, int N, int H, int W,
                                      int C1, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C1) {
    case 1: launch<1>(x1g, x2g, px, y, mask, ls, out, B, N, H, W, s); break;
    case 2: launch<2>(x1g, x2g, px, y, mask, ls, out, B, N, H, W, s); break;
    case 3: launch<3>(x1g, x2g, px, y, mask, ls, out, B, N, H, W, s); break;
    case 4: launch<4>(x1g, x2g, px, y, mask, ls, out, B, N, H, W, s); break;
    case 5: launch<5>(x1g, x2g, px, y, mask, ls, out, B, N, H, W, s); break;
    case 6: launch<6>(x1g, x2g, px, y, mask, ls, out, B, N, H, W, s); break;
    case 7: launch<7>(x1g, x2g, px, y, mask, ls, out, B, N, H, W, s); break;
    case kMaxChannels: launch<kMaxChannels>(x1g, x2g, px, y, mask, ls, out, B, N, H, W, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* setconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
