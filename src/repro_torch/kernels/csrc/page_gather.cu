// Page-aligned gather + member scoring: squared L2 of every vector of the
// requested pages to its query, for a batch of queries.
//
// Replaces: src/repro/kernels/page_gather.py, page_gather_l2 (the Pallas
// kernel _page_l2_kernel).
//
// Shapes (row-major, contiguous):
//   pages    (P, cap, d) f32  page vectors, unpacked (no record layout)
//   page_ids (Q, b) i32       the pages to score for each query
//   q        (Q, d) f32       the queries
//   out      (Q, b, cap) f32  out[i, j, m] = sum_c (pages[ids[i, j], m, c] - q[i, c])^2
//
// Bound on the H100: bytes. Three flops per loaded float; the least time is
// each distinct page's cap x d floats, the queries, the ids and the output
// over 3.35 TB/s.
//
// Design: the TPU kernel scalar-prefetched the (b,) page ids so that each
// grid step's BlockSpec DMAs exactly one page into VMEM. A GPU block loads
// its own page id instead: one block per (query, page), the query staged in
// shared memory, one warp per member reading the member's d floats with
// consecutive lanes on consecutive addresses and reducing with shuffles. The
// per-member sum runs in the same order as page_scan.cu's member scores
// (lane-strided FMAs, then an xor-shuffle tree), so on the same vectors the
// two kernels agree. Page ids outside [0, P) are clamped, as an XLA gather
// clamps them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) page_gather_l2_kernel(
    const float* __restrict__ pages, const int32_t* __restrict__ page_ids,
    const float* __restrict__ q, float* __restrict__ out, int b,
    int num_pages, int cap, int dim) {
  extern __shared__ float q_s[];
  const int item = blockIdx.x;  // query * b + slot
  const int qi = item / b;
  const int page = min(max(page_ids[item], 0), num_pages - 1);
  const float* qv = q + static_cast<size_t>(qi) * dim;
  for (int c = threadIdx.x; c < dim; c += blockDim.x) q_s[c] = qv[c];
  __syncthreads();

  const float* pg = pages + static_cast<size_t>(page) * cap * dim;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int m = warp; m < cap; m += nwarps) {
    const float* v = pg + static_cast<size_t>(m) * dim;
    float acc = 0.f;
    for (int c = lane; c < dim; c += 32) {
      const float t = v[c] - q_s[c];
      acc = fmaf(t, t, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[static_cast<size_t>(item) * cap + m] = acc;
  }
}

}  // namespace

extern "C" int pageann_page_gather_l2(const float* pages,
                                      const int32_t* page_ids, const float* q,
                                      float* out, int nq, int b,
                                      int num_pages, int cap, int dim,
                                      void* stream) {
  if (nq == 0 || b == 0 || cap == 0) return 0;
  const size_t smem = static_cast<size_t>(dim) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        page_gather_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  page_gather_l2_kernel<<<nq * b, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      pages, page_ids, q, out, b, num_pages, cap, dim);
  return static_cast<int>(cudaGetLastError());
}
