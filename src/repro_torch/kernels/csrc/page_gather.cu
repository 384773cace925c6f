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
// grid step's BlockSpec DMAs exactly one page into VMEM. Here one warp
// scores one (query, slot) item and loads its own page id, as page_scan.cu's
// members-only kernel does: a block holds a few consecutive items (mostly
// of one query, so the query's loads hit L1), with no shared memory and no
// barrier. The warp issues every member load of its page (cap x ceil(d/32)
// coalesced warp loads through the read-only path, in groups of at most 32
// a lane) and the query's columns before the first FMA, then runs the xor
// tree of a group on all its members at once (member_l2.cuh). A page is
// that kernel's case of one member a row, d floats apart, so the sum is the
// same code and page_scan's member scores come out bit for bit. Page ids
// outside [0, P) are clamped, as an XLA gather clamps them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "member_l2.cuh"

namespace {

// As page_scan.cu's members-only kernel: at most 256 threads a block and 4
// such blocks an SM, so 64 registers a thread for up to 32 member floats a
// lane in flight. At Q = 1,000, b = 5 the 5,000 warps take 1.18 waves; one
// wave needs <= 48 registers, which spilled (and ran 1-21% longer), or
// groups of 4 members at 40 registers (2% faster at d = 128 and Q = 1,000,
// 3% slower at Q = 64 and at d = 200, spilling at d <= 64).
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;

// kJ: the columns a lane takes in one slab, ceil(d / 32) when d <= 128;
// kSpan: d > 128 (kJ is then 4 and the slabs step by 128 columns). Members
// go in groups of kG; member i of a group is summed into lanes i * 32 / kG
// on, and the first of them stores it.
template <int kJ, bool kSpan>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    page_gather_l2_kernel(const float* __restrict__ pages,
                          const int32_t* __restrict__ page_ids,
                          const float* __restrict__ q, float* __restrict__ out,
                          int b, int items, int num_pages, int cap, int dim) {
  constexpr int kG = kJ == 1 ? 32 : kJ == 2 ? 16 : 8;  // divides 32
  constexpr int kLanesPer = 32 / kG;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= items) return;
  const int page = min(max(__ldg(page_ids + item), 0), num_pages - 1);
  const float* pg = pages + static_cast<size_t>(page) * cap * dim;
  const float* qv = q + static_cast<size_t>(item / b) * dim;
  float* o = out + static_cast<size_t>(item) * cap;
  for (int g0 = 0; g0 < cap; g0 += kG) {
    const int mi = g0 + lane / kLanesPer;  // the member this lane sums
    float acc[kG];
    member_slab<kJ, kG, true>(acc, pg, g0 * dim, 0, dim, 1, cap - g0, qv,
                              lane, dim);
    if constexpr (kSpan) {
      for (int c = lane + 32 * kJ; c < dim; c += 32 * kJ)
        member_slab<kJ, kG, false>(acc, pg, g0 * dim, 0, dim, 1, cap - g0,
                                   qv, c, dim);
    }
    const float sum = warp_sums<kG>(acc, lane);
    if (lane % kLanesPer == 0 && mi < cap) o[mi] = sum;
  }
}

template <int kJ, bool kSpan>
cudaError_t launch(const float* pages, const int32_t* page_ids,
                   const float* q, float* out, int b, int items,
                   int num_pages, int cap, int dim, int threads,
                   cudaStream_t stream) {
  const int warps = threads / 32;
  page_gather_l2_kernel<kJ, kSpan>
      <<<(items + warps - 1) / warps, threads, 0, stream>>>(
          pages, page_ids, q, out, b, items, num_pages, cap, dim);
  return cudaGetLastError();
}

}  // namespace

// threads: the block's threads, a multiple of 32 up to 256, one (query,
// slot) item a warp (the members-only plan of kernels/page_scan.py).
extern "C" int pageann_page_gather_l2(const float* pages,
                                      const int32_t* page_ids, const float* q,
                                      float* out, int nq, int b,
                                      int num_pages, int cap, int dim,
                                      int threads, void* stream) {
  if (nq == 0 || b == 0 || cap == 0) return 0;
  const long long items = static_cast<long long>(nq) * b;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      items > INT32_MAX || num_pages < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((dim + 31) / 32) {
    case 1: err = launch<1, false>(pages, page_ids, q, out, b, n, num_pages, cap, dim, threads, s); break;
    case 2: err = launch<2, false>(pages, page_ids, q, out, b, n, num_pages, cap, dim, threads, s); break;
    case 3: err = launch<3, false>(pages, page_ids, q, out, b, n, num_pages, cap, dim, threads, s); break;
    case 4: err = launch<4, false>(pages, page_ids, q, out, b, n, num_pages, cap, dim, threads, s); break;
    default: err = launch<4, true>(pages, page_ids, q, out, b, n, num_pages, cap, dim, threads, s); break;
  }
  return static_cast<int>(err);
}
