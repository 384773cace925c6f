// Batched squared L2 distance between two sets of vectors, in the expanded
// form |q|^2 - 2 q.x + |x|^2.
//
// Replaces: src/repro/kernels/l2dist.py, l2_distance (the Pallas kernel
// _l2_kernel).
//
// Shapes (row-major, contiguous):
//   q   (Q, d) f32   queries
//   x   (N, d) f32   vectors (the mutable index's delta tier)
//   out (Q, N) f32   out[i, j] = (|q_i|^2 - 2 q_i.x_j) + |x_j|^2
//
// Bound on the H100: operations once Q and N are in the hundreds. The product
// does 2 Q N d flops against 4 (Q d + N d + Q N) bytes; at d = 128 that is
// ~64 flops a byte of output, above the card's float32 balance (67 TFLOP/s
// over 3.35 TB/s = 20). The least time is 2 Q N d over 67 TFLOP/s.
//
// Design: the TPU kernel handed the q.x product of a (128, d) x (d, 128) tile
// to the matrix unit and kept d whole in VMEM. Here the product stays in full
// float32 on the CUDA cores (TF32 tensor cores would keep ~3 decimal digits,
// and the port is held to the reference at 1e-5): a classic tiled SIMT
// product. Each block owns a 64 x 64 output tile and walks d in slabs of 32:
// the slab of its 64 queries and 64 vectors is staged in shared memory
// (transposed, so a thread reads its operands with consecutive addresses),
// and each of the 256 threads keeps a 4 x 4 register tile of FMA
// accumulators, on rows ty + 16 i and columns tx + 16 j so that neither the
// shared-memory reads nor the output stores conflict. While the slab is in
// shared memory, threads 0-63 sum their query's squares and threads 64-127
// their vector's, so the norms cost no extra read of device memory. The
// epilogue evaluates (qq - 2 qx) + xx in the reference's order. Edge tiles
// are masked (zero-filled in shared memory, not stored), so any Q, N and d
// work without host padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // output rows and columns per block
constexpr int kSlab = 32;     // d per shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPer = 4;

__global__ void __launch_bounds__(kThreads) l2_distance_kernel(
    const float* __restrict__ q, const float* __restrict__ x,
    float* __restrict__ out, int nq, int nx, int d) {
  // [k][row], one float of padding so the transposed stores do not conflict
  __shared__ float q_s[kSlab][kTile + 1];
  __shared__ float x_s[kSlab][kTile + 1];
  __shared__ float qn_s[kTile];
  __shared__ float xn_s[kTile];

  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;
  float norm = 0.f;  // threads < 64: |q_row|^2; 64..127: |x_row|^2

  for (int k0 = 0; k0 < d; k0 += kSlab) {
    // consecutive threads read consecutive elements of one row: coalesced
    for (int i = t; i < kTile * kSlab; i += kThreads) {
      const int r = i / kSlab;
      const int c = i % kSlab;
      const int gc = k0 + c;
      const int gq = row0 + r;
      const int gx = col0 + r;
      q_s[c][r] = (gq < nq && gc < d) ? q[static_cast<size_t>(gq) * d + gc] : 0.f;
      x_s[c][r] = (gx < nx && gc < d) ? x[static_cast<size_t>(gx) * d + gc] : 0.f;
    }
    __syncthreads();
    if (t < kTile) {
#pragma unroll 8
      for (int c = 0; c < kSlab; ++c) norm = fmaf(q_s[c][t], q_s[c][t], norm);
    } else if (t < 2 * kTile) {
#pragma unroll 8
      for (int c = 0; c < kSlab; ++c)
        norm = fmaf(x_s[c][t - kTile], x_s[c][t - kTile], norm);
    }
#pragma unroll 8
    for (int c = 0; c < kSlab; ++c) {
      float a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = q_s[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = x_s[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (t < kTile) {
    qn_s[t] = norm;
  } else if (t < 2 * kTile) {
    xn_s[t - kTile] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= nq) continue;
    const float qq = qn_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < nx) {
        // (qq - 2 qx) + xx, the reference's order; 2 qx is exact
        const float v = qq - 2.f * acc[i][j];
        out[static_cast<size_t>(r) * nx + c] = v + xn_s[tx + 16 * j];
      }
    }
  }
}

}  // namespace

extern "C" int pageann_l2_distance(const float* q, const float* x, float* out,
                                   int nq, int nx, int d, void* stream) {
  if (nq == 0 || nx == 0) return 0;
  const dim3 grid((nx + kTile - 1) / kTile, (nq + kTile - 1) / kTile);
  l2_distance_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, x, out, nq, nx, d);
  return static_cast<int>(cudaGetLastError());
}
