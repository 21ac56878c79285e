// Length-scale gradient of the SetConv point-set encode, for sm_90a.
//
// Replaces the gradient JAX takes through
// deepsensornz_tpu/ops/setconv.py:42 (setconv_encode_offgrid, an XLA einsum
// the JAX trainer differentiates) with respect to the RBF length-scale l:
// the backward of csrc/setconv_encode.cu, the port of the TPU kernel
// deepsensornz_tpu/ops/setconv_pallas.py::encode_offgrid.
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
//                              + W1 . (W2 o U2^2 o yaug_c).
//
// What bounds it on an H100: the least time is set by the bytes of g and
// out over the cells some point reaches (4 floats a cell at C1 = 2: 39 MB
// for the 8 x 608^2 training batch, 83 % of its cells, 12 us at 3.35 TB/s),
// since expf is exactly 0 in f32 beyond ~14.4 l and only ~1.4 % of the
// (cell, point) pairs carry a weight. What holds the kernel (measured,
// PERF.md) is the work per kept pair: the exps and the splitting around
// the 3xTF32 products take about half its time, the point scan a quarter;
// the tile's bytes are mostly hidden behind them. Design:
//   - one block of 4 warps per (task, 32x32 cell tile), each warp 16x16
//     cells; the block takes the tile's coordinate ranges (min and max of
//     its x1g rows and x2g columns, so the grid may run either way) and
//     scans the task's points 512 at a time (every load of a group issued
//     before its ballots, the first group's with the grid's), keeping a point only if its mask is nonzero and
//     its distance to both ranges, over l, is at most `reach` in the f32
//     arithmetic the weights use. expf(-reach^2/2) is 0 in f32, so every
//     dropped (point, cell) pair has weight exactly 0 here too: culling is
//     exact up to summation order. The kept points (coordinates, mask,
//     value) are compacted into shared memory in ascending order (warp
//     ballots, prefix counts), so the order, and the result, are the same
//     from run to run. A 32x32 tile keeps ~22 uniform stations of 512 at
//     the flagship's l, one chunk;
//   - a tile with no kept point writes a partial of exactly 0 and reads
//     neither g nor out;
//   - otherwise the epilogue's g and out for the tile's cells go to shared
//     memory as cp.async copies issued before the products, so the tile's
//     bytes move while the tensor cores run (16 KB at C1 = 2; the layout is
//     XOR-swizzled so the epilogue's float2 reads are conflict free); g is
//     read in place through its cell stride, so a channel slice of a wider
//     NHWC gradient needs no copy;
//   - the products run over the kept points only, in chunks of 32: W1 and
//     U1^2 (32 x 32) and W2 and U2^2 (32 x 32) in shared memory, every
//     product 3xTF32 (mma_split.cuh; one TF32 pass misses the tolerance),
//     each chunk's sums started from 0 in the tensor cores and added to the
//     running T in IEEE f32 (the tensor cores' own accumulation does not
//     round to nearest, and over ~500 steps its bias exceeded the
//     tolerance); one pass per value channel, each forming T_0 again;
//   - each block folds its cells' terms into per-thread doubles and reduces
//     them in a fixed order (shuffles, then warp order) to one partial per
//     tile; the last block to finish (a ticket counter the caller zeroes
//     with the partials) sums the partials in tile order and writes
//     (sum / l) as f32. The gradient is the same from run to run.
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma_split.cuh"

namespace {

using namespace setconv;

constexpr int kTile = 32;    // grid rows and columns per block
constexpr int kCells = kTile * kTile;
constexpr int kChunk = 32;   // points per staged chunk
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kScan = 4;                  // points each thread scans per group
constexpr int kGroup = kScan * kThreads;  // points scanned at once: the list's capacity
constexpr int kW1Stride = kChunk + 4;  // conflict-free A-fragment reads
constexpr int kW2Stride = kTile + 8;   // conflict-free B-fragment reads

// Index of cell (r, col) of a staged 32x32 plane: pairs of columns stay
// adjacent (one float2), pair p of row r sits at p ^ 4(r % 4), so the
// epilogue's float2 reads are conflict free.
__device__ __forceinline__ int swz(int r, int col) {
  return r * kTile + ((((col >> 1) ^ ((r & 3) << 2)) << 1) | (col & 1));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

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

// One thread's share of a group of kGroup points: n0 + i * kThreads + tid.
struct Group {
  float m[kScan], p1[kScan], p2[kScan], v[kScan];
};

// Issues the loads of a group: mask, coordinates and value channel c (0
// past N, and for the value when there is no value channel).
__device__ __forceinline__ void load_group(Group& gr, const float* __restrict__ px,
                                           const float* __restrict__ y,
                                           const float* __restrict__ mask, size_t pbase, int N,
                                           int n0, int C1, int c) {
#pragma unroll
  for (int i = 0; i < kScan; ++i) {
    const int n = n0 + i * kThreads + threadIdx.x;
    const size_t pn = pbase + n;
    gr.m[i] = n < N ? mask[pn] : 0.f;
    gr.p1[i] = n < N ? px[2 * pn] : 0.f;
    gr.p2[i] = n < N ? px[2 * pn + 1] : 0.f;
    gr.v[i] = (n < N && c < C1) ? y[pn * (C1 - 1) + (c - 1)] : 0.f;
  }
}

// The group's kept points, compacted in ascending order into the list:
// coordinates, mask and the mask-folded value. Every thread calls it;
// returns the count.
__device__ int compact_group(const Group& gr, const float (&range)[2][2], float lsv,
                             float reach, float (&list)[4][kGroup],
                             int (&wcount)[kScan][kWarps]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  unsigned bal[kScan];
#pragma unroll
  for (int i = 0; i < kScan; ++i) {
    const float p1 = gr.p1[i], p2 = gr.p2[i];
    const float gap1 = fmaxf(fmaxf(range[0][0] - p1, p1 - range[0][1]), 0.f);
    const float gap2 = fmaxf(fmaxf(range[1][0] - p2, p2 - range[1][1]), 0.f);
    const bool kept = gr.m[i] != 0.f && !(gap1 / lsv > reach) && !(gap2 / lsv > reach);
    bal[i] = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) wcount[i][warp] = __popc(bal[i]);
  }
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int i = 0; i < kScan; ++i) {
    int before = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) before = count;
      count += wcount[i][w];
    }
    if (bal[i] >> lane & 1u) {
      const int k = before + __popc(bal[i] & ((1u << lane) - 1u));
      list[0][k] = gr.p1[i];
      list[1][k] = gr.p2[i];
      list[2][k] = gr.m[i];
      list[3][k] = gr.v[i] * gr.m[i];
    }
  }
  __syncthreads();  // the list is complete, wcount free again
  return count;
}

// Fixed-order block sum of one double per thread: shuffles inside each
// warp, then warp order. The total is valid in thread 0.
__device__ double block_sum(double v, double (&red)[kWarps]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double sum = 0.0;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += red[i];
  }
  return sum;
}

__global__ void __launch_bounds__(kThreads)
encode_offgrid_grad_kernel(const float* __restrict__ x1g, const float* __restrict__ x2g,
                           const float* __restrict__ px, const float* __restrict__ y,
                           const float* __restrict__ mask, const float* __restrict__ ls,
                           const float* __restrict__ out, const float* __restrict__ gout,
                           int gs, double* __restrict__ partials, unsigned int* ticket,
                           float* __restrict__ result, int N, int H, int W, int C1,
                           float reach) {
  // the tile's g_0, g_c, out_0 and out_c, swizzled
  __shared__ __align__(16) float ep[4][kCells];
  __shared__ float list[4][kGroup];         // kept points: x1, x2, mask, value
  __shared__ float w1s[kTile][kW1Stride];   // row weights [row][point]
  __shared__ float u1s[kTile][kW1Stride];   // (row distance / l)^2
  __shared__ float w2s[kChunk][kW2Stride];  // column weights [point][column]
  __shared__ float u2s[kChunk][kW2Stride];  // (column distance / l)^2
  __shared__ float g1s[kTile], g2s[kTile];
  __shared__ float range[2][2];  // [x1, x2][min, max] over the tile
  __shared__ int wcount[kScan][kWarps];
  __shared__ double red[kWarps];
  __shared__ bool last;

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kTile;
  const int w0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = (warp >> 1) * 16, c0 = (warp & 1) * 16;  // the warp's 16 x 16 cells
  const float lsv = ls[0];
  const size_t pbase = static_cast<size_t>(b) * N;

  Group first;  // the first group's loads, in flight with the grid's
  load_group(first, px, y, mask, pbase, N, 0, C1, 1);
  if (tid < kTile) {
    g1s[tid] = (h0 + tid < H) ? x1g[h0 + tid] : 0.f;
    g2s[tid] = (w0 + tid < W) ? x2g[w0 + tid] : 0.f;
  }
  __syncthreads();
  if (warp < 2) {  // warp 0: the tile's x1 range, warp 1: its x2 range
    const bool valid = lane < (warp == 0 ? H - h0 : W - w0);
    const float v = (warp == 0 ? g1s : g2s)[lane];
    float lo = valid ? v : CUDART_INF_F, hi = valid ? v : -CUDART_INF_F;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      range[warp][0] = lo;
      range[warp][1] = hi;
    }
  }
  __syncthreads();

  double local = 0.0;
  // pass c: channel 0 and value channel c (none when C1 == 1)
  for (int c = 1; c < max(C1, 2); ++c) {
    const bool value = c < C1;
    // T_0 and T_c, summed chunk by chunk: each chunk's products start from
    // 0 in the tensor cores (whose f32 accumulation does not round to
    // nearest) and are added here in IEEE f32, so no bias grows with N
    float t0[2][4], tc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t0[j][e] = tc[j][e] = 0.f;
    bool staged = false;
    for (int n0 = 0; n0 < N; n0 += kGroup) {
      Group gr;
      if (n0 == 0 && c == 1) {
        gr = first;
      } else {
        load_group(gr, px, y, mask, pbase, N, n0, C1, c);
      }
      const int count = compact_group(gr, range, lsv, reach, list, wcount);
      if (count == 0) continue;
      if (!staged) {  // this pass's epilogue reads, in flight while the products run
        staged = true;
        for (int e = tid; e < kCells; e += kThreads) {
          const int r = e / kTile, col = e % kTile;
          if (h0 + r < H && w0 + col < W) {
            const size_t cell = (static_cast<size_t>(b) * H + h0 + r) * W + w0 + col;
            const int s = swz(r, col);
            if (c == 1) cp_async4(&ep[0][s], gout + cell * gs);
            if (value) {
              cp_async4(&ep[1][s], gout + cell * gs + c);
              cp_async4(&ep[2][s], out + cell * C1);
              cp_async4(&ep[3][s], out + cell * C1 + c);
            }
          }
        }
        asm volatile("cp.async.commit_group;\n" ::);
      }
      for (int k0 = 0; k0 < count; k0 += kChunk) {
        const int nvalid = min(kChunk, count - k0);
        for (int e = tid; e < kChunk * kTile; e += kThreads) {
          const int n = e % kChunk, r = e / kChunk;
          float v1 = 0.f, d1 = 0.f;
          if (n < nvalid && h0 + r < H) {
            const float d = (g1s[r] - list[0][k0 + n]) / lsv;
            d1 = d * d;
            v1 = expf(-0.5f * d1);
          }
          w1s[r][n] = v1;
          u1s[r][n] = d1;
          const int n2 = e / kTile, col = e % kTile;
          float v2 = 0.f, d2 = 0.f;
          if (n2 < nvalid && w0 + col < W) {
            const float d = (g2s[col] - list[1][k0 + n2]) / lsv;
            d2 = d * d;
            v2 = expf(-0.5f * d2);
          }
          w2s[n2][col] = v2;
          u2s[n2][col] = d2;
        }
        __syncthreads();

        float k0s[2][4], kcs[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) k0s[j][e] = kcs[j][e] = 0.f;
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
          // slots past the list's end hold stale values: their weights are 0
          const bool in0 = k < nvalid, in1 = k + 4 < nvalid;
          const float m0 = in0 ? list[2][k0 + k] : 0.f, m1 = in1 ? list[2][k0 + k + 4] : 0.f;
          const float y0 = in0 ? list[3][k0 + k] : 0.f, y1 = in1 ? list[3][k0 + k + 4] : 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = c0 + 8 * j + g;
            const float wa = w2s[k][col], wb = w2s[k + 4][col];
            const float ua = u2s[k][col], ub = u2s[k + 4][col];
            mma_t(k0s[j], a1h, a1l, a2h, a2l, wa, wb, ua, ub, m0, m1);
            if (value) mma_t(kcs[j], a1h, a1l, a2h, a2l, wa, wb, ua, ub, y0, y1);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            t0[j][e] += k0s[j][e];
            tc[j][e] += kcs[j][e];
          }
        __syncthreads();  // the chunk's weights are consumed
      }
    }
    // a tile no kept point reaches has T = 0 in every pass: partial 0,
    // g and out unread
    if (!staged) break;

    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + half * 8, col = c0 + 8 * j + 2 * q;
        const int s = swz(r, col);
        const float2 g0 = *reinterpret_cast<const float2*>(&ep[0][s]);
        const float2 gc = *reinterpret_cast<const float2*>(&ep[1][s]);
        const float2 o0 = *reinterpret_cast<const float2*>(&ep[2][s]);
        const float2 oc = *reinterpret_cast<const float2*>(&ep[3][s]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (h0 + r < H && w0 + col + i < W) {
            const float a0 = t0[j][2 * half + i];
            if (c == 1) local += static_cast<double>((i ? g0.y : g0.x) * a0);
            if (value) {
              const float den = (i ? o0.y : o0.x) + 1e-8f;
              local += static_cast<double>(
                  (i ? gc.y : gc.x) * ((tc[j][2 * half + i] - (i ? oc.y : oc.x) * a0) / den));
            }
          }
        }
      }
    __syncthreads();  // the staged planes are free again
  }

  const double sum = block_sum(local, red);
  const unsigned int blocks = gridDim.x * gridDim.y * gridDim.z;
  if (tid == 0) {
    partials[(static_cast<size_t>(b) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = sum;
    __threadfence();
    last = atomicAdd(ticket, 1u) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written; sum them in tile order
  __threadfence();
  double v = 0.0;
  for (unsigned int i0 = tid; i0 < blocks; i0 += 8 * kThreads) {
    double part[8];  // eight loads in flight, then added in index order
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned int i = i0 + u * kThreads;
      part[u] = i < blocks ? __ldcg(partials + i) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) v += part[u];
  }
  const double total = block_sum(v, red);
  if (tid == 0) {
    // the kernel's terms carry (d/l)^2, so the 1/l^3 of dS/dl leaves 1/l here
    *result = static_cast<float>(total / static_cast<double>(lsv));
  }
}

}  // namespace

// x1g (H), x2g (W), px (B,N,2), y (B,N,C1-1), mask (B,N), ls (1) and out
// (the forward's output on these inputs, (B,H,W,C1)): float32, contiguous,
// on one device. gout (B,H,W,C1), float32, channels adjacent and cells
// gout_stride floats apart (C1 when contiguous). scratch: float64,
// B * ceil(H/32) * ceil(W/32) + 1 of them, zeroed: one partial per cell
// tile, then the last block's ticket counter. result: one float32, dL/dl.
// reach: the culling radius in units of l, with expf(-reach^2/2) == 0 in
// f32. Any C1 >= 1, N >= 1. Returns a cudaError_t code.
extern "C" int setconv_encode_offgrid_grad(const float* x1g, const float* x2g, const float* px,
                                           const float* y, const float* mask, const float* ls,
                                           const float* out, const float* gout,
                                           int gout_stride, double* scratch, float* result,
                                           int B, int N, int H, int W, int C1, float reach,
                                           void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (C1 < 1 || N < 1 || gout_stride < C1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  double* partials = scratch;
  auto* ticket = reinterpret_cast<unsigned int*>(scratch + static_cast<size_t>(grid.x) *
                                                               grid.y * grid.z);
  encode_offgrid_grad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1g, x2g, px, y, mask, ls, out, gout, gout_stride, partials, ticket, result, N, H, W, C1,
      reach);
  return static_cast<int>(cudaGetLastError());
}
