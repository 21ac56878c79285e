// Length-scale gradient of the SetConv point-set encode, for sm_90a.
//
// The backward of csrc/setconv_encode.cu (the port of the TPU kernel
// deepsensornz_tpu/ops/setconv_pallas.py::encode_offgrid) with respect to the
// RBF length-scale l, the gradient JAX takes through
// deepsensornz_tpu/ops/setconv.py::setconv_encode_offgrid when it trains.
// With u1 = (x1g[h]-x[b,n,0])/l, u2 = (x2g[w]-x[b,n,1])/l,
// w = exp(-(u1^2+u2^2)/2) and yaug = [mask, y*mask]:
//
//   S[b,h,w,c] = sum_n w * yaug[b,n,c]                 (the forward's sums)
//   T[b,h,w,c] = sum_n w * (u1^2 + u2^2) * yaug[b,n,c] (= l * dS/dl)
//
// The forward's output is out_0 = S_0 and out_c = S_c / D with
// D = S_0 + 1e-8, so with g = dL/dout
//
//   dL/dl = (1/l) sum_{b,h,w} [ g_0 T_0 + sum_{c>=1} g_c (T_c - out_c T_0) / D ]
//
// and the kernel reads out (saved by the forward) instead of forming S.
// T is separable like S: T_c = (W1 o U1^2) . (W2 o yaug_c)
//                              + W1 . (W2 o U2^2 o yaug_c),
// two products of the forward's shape. Design (the forward's tiling):
//   - one block of 4 warps per (task, 64x64 cell tile); warp w owns rows
//     16w..16w+15 and all 64 columns, as 8 mma tiles of 16x8;
//   - the points are walked in chunks of 32; for each chunk the block stores
//     W1 and U1^2 (64 x 32) and W2 and U2^2 (32 x 64) in shared memory as
//     f32, so every exp is computed once per block, chunk and pass;
//   - both A operands (W1 and W1 o U1^2) are formed and split into TF32
//     hi/lo in registers per k-step and serve both channels of the pass;
//     the B operands are formed per mma tile; every product runs 3xTF32
//     (mma_split.cuh), as the forward does;
//   - one pass over the points accumulates T_0 and one value channel T_c
//     (the training path has one value channel, so one pass); with more
//     channels each pass forms T_0 again rather than keep every T_c;
//   - the epilogue reads g and out (NHWC) and folds each cell's terms into
//     a per-thread double; the block reduces those in a fixed order
//     (shuffles, then warp order) to one partial per tile. No atomics: the
//     wrapper sums the partials in a fixed order, so the gradient is the
//     same from run to run.
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "mma_split.cuh"

namespace {

using namespace setconv;

constexpr int kTile = 64;    // grid rows and columns per block
constexpr int kChunk = 32;   // points per staged chunk
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kW1Stride = kChunk + 4;  // conflict-free A-fragment reads
constexpr int kW2Stride = kTile + 8;   // conflict-free B-fragment reads

// t += A1 . (W2 o v) + A2 . (W2 o U2^2 o v) for one 16x8 mma tile: the B
// elements at points k and k+4 of column col, formed and split here.
__device__ __forceinline__ void mma_t(float (&t)[4], const uint32_t (&a1h)[4],
                                      const uint32_t (&a1l)[4], const uint32_t (&a2h)[4],
                                      const uint32_t (&a2l)[4], float w0, float w1, float u0,
                                      float u1, float v0, float v1) {
  const float ta = w0 * v0, tb = w1 * v1;
  uint32_t b0h, b0l, b1h, b1l, d0h, d0l, d1h, d1l;
  split_tf32(ta, b0h, b0l);
  split_tf32(tb, b1h, b1l);
  split_tf32(ta * u0, d0h, d0l);
  split_tf32(tb * u1, d1h, d1l);
  mma_3xtf32(t, a2h, a2l, b0h, b1h, b0l, b1l);
  mma_3xtf32(t, a1h, a1l, d0h, d1h, d0l, d1l);
}

__global__ void __launch_bounds__(kThreads)
encode_offgrid_grad_kernel(const float* __restrict__ x1g, const float* __restrict__ x2g,
                           const float* __restrict__ px, const float* __restrict__ y,
                           const float* __restrict__ mask, const float* __restrict__ ls,
                           const float* __restrict__ out, const float* __restrict__ gout,
                           double* __restrict__ partials, int N, int H, int W, int C1) {
  __shared__ float w1s[kTile][kW1Stride];   // row weights [row][point]
  __shared__ float u1s[kTile][kW1Stride];   // (row distance / l)^2
  __shared__ float w2s[kChunk][kW2Stride];  // column weights [point][column]
  __shared__ float u2s[kChunk][kW2Stride];  // (column distance / l)^2
  __shared__ float ms[kChunk], ys[kChunk];  // mask, and mask-folded values of channel c
  __shared__ float p1s[kChunk], p2s[kChunk];
  __shared__ float g1s[kTile], g2s[kTile];
  __shared__ double red[kWarps];

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

  double local = 0.0;
  // pass c: channel 0 and value channel c (none when C1 == 1)
  for (int c = 1; c < max(C1, 2); ++c) {
    const bool value = c < C1;
    float t0[8][4], tc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t0[j][e] = tc[j][e] = 0.f;

    for (int n0 = 0; n0 < N; n0 += kChunk) {
      __syncthreads();  // previous chunk fully consumed
      if (tid < kChunk) {
        const int n = n0 + tid;
        const bool ok = n < N;
        const size_t pn = static_cast<size_t>(b) * N + n;
        const float m = ok ? mask[pn] : 0.f;
        p1s[tid] = ok ? px[2 * pn] : 0.f;
        p2s[tid] = ok ? px[2 * pn + 1] : 0.f;
        ms[tid] = m;
        ys[tid] = (ok && value) ? y[pn * (C1 - 1) + (c - 1)] * m : 0.f;
      }
      __syncthreads();
      const int nvalid = min(kChunk, N - n0);
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int n = e % kChunk, r = e / kChunk;
        float v1 = 0.f, d1 = 0.f;
        if (n < nvalid && h0 + r < H) {
          const float d = (g1s[r] - p1s[n]) / lsv;
          d1 = d * d;
          v1 = expf(-0.5f * d1);
        }
        w1s[r][n] = v1;
        u1s[r][n] = d1;
        const int n2 = e / kTile, col = e % kTile;
        float v2 = 0.f, d2 = 0.f;
        if (n2 < nvalid && w0 + col < W) {
          const float d = (g2s[col] - p2s[n2]) / lsv;
          d2 = d * d;
          v2 = expf(-0.5f * d2);
        }
        w2s[n2][col] = v2;
        u2s[n2][col] = d2;
      }
      __syncthreads();

#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const int k = ks * 8 + q;
        // A fragments: a0 (g, k), a1 (g+8, k), a2 (g, k+4), a3 (g+8, k+4)
        const int ar[4] = {r0 + g, r0 + g + 8, r0 + g, r0 + g + 8};
        const int ac[4] = {k, k, k + 4, k + 4};
        uint32_t a1h[4], a1l[4], a2h[4], a2l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wv = w1s[ar[i]][ac[i]];
          split_tf32(wv, a1h[i], a1l[i]);
          split_tf32(wv * u1s[ar[i]][ac[i]], a2h[i], a2l[i]);
        }
        const float m0 = ms[k], m1 = ms[k + 4], y0 = ys[k], y1 = ys[k + 4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + g;
          const float wa = w2s[k][col], wb = w2s[k + 4][col];
          const float ua = u2s[k][col], ub = u2s[k + 4][col];
          mma_t(t0[j], a1h, a1l, a2h, a2l, wa, wb, ua, ub, m0, m1);
          if (value) mma_t(tc[j], a1h, a1l, a2h, a2l, wa, wb, ua, ub, y0, y1);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = h0 + r0 + g + (e >> 1) * 8;
        const int w = w0 + 8 * j + 2 * q + (e & 1);
        if (h < H && w < W) {
          const size_t cell = ((static_cast<size_t>(b) * H + h) * W + w) * C1;
          if (c == 1) local += static_cast<double>(gout[cell] * t0[j][e]);
          if (value) {
            const float den = out[cell] + 1e-8f;
            local += static_cast<double>(gout[cell + c] *
                                         ((tc[j][e] - out[cell + c] * t0[j][e]) / den));
          }
        }
      }
  }

  // fixed-order block reduction: shuffles inside each warp, then warp order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(0xffffffffu, local, off);
  if (lane == 0) red[warp] = local;
  __syncthreads();
  if (tid == 0) {
    double sum = 0.0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += red[i];
    partials[(static_cast<size_t>(b) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = sum;
  }
}

}  // namespace

// x1g (H), x2g (W), px (B,N,2), y (B,N,C1-1), mask (B,N), ls (1), out (the
// forward's output on these inputs) and gout (B,H,W,C1): float32,
// contiguous, on one device. partials: float64, (B, ceil(H/64), ceil(W/64)),
// one per cell tile; their sum divided by l is dL/dl. Any C1 >= 1, N >= 1.
// Returns a cudaError_t code.
extern "C" int setconv_encode_offgrid_grad(const float* x1g, const float* x2g, const float* px,
                                           const float* y, const float* mask, const float* ls,
                                           const float* out, const float* gout,
                                           double* partials, int B, int N, int H, int W,
                                           int C1, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (C1 < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  encode_offgrid_grad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1g, x2g, px, y, mask, ls, out, gout, partials, N, H, W, C1);
  return static_cast<int>(cudaGetLastError());
}
