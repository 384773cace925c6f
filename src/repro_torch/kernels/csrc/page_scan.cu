// Fused page scan for one search hop: member L2 and neighbour ADC from one
// read of each packed page record.
//
// Replaces: src/repro/kernels/page_scan.py, page_scan (the Pallas kernels
// _page_scan_kernel, _page_scan_members_kernel, _page_scan_masked_kernel and
// _page_scan_members_masked_kernel) and page_scan_recs (the four
// _page_scan_recs_* kernels).
//
// Shapes (all row-major, contiguous):
//   recs     (P, rows, 128) f32  packed page records (core/layout.py), or,
//                                staged, (Q * b, rows, 128): record item of
//                                the hop's already-gathered batch
//   page_ids (Q, b) i32          the hop's pages for each query (not staged)
//   q        (Q, d) f32          the hop's queries
//   lut      (Q, M, K) f32       the query's ADC table (ADC only)
//   mask     (Q, b, cap) f32     filter mask: members <= 0 score +inf (masked)
//   md       (Q, b, cap) f32     squared L2 of each member to its query
//   nd       (Q, b, rp) f32      ADC estimate of each neighbour (ADC only)
//
// Bound on the H100: bytes. Each (query, page) reads its record's member rows
// (and M code rows with ADC) once and does ~3 flops per loaded float, far
// below the card's flop/byte balance; the least time is the bytes read over
// 3.35 TB/s.
//
// Design: one block per (query, page); the block loads its own page id (no
// scalar prefetch on a GPU). It copies the member rows into shared memory
// with coalesced 16-byte loads, then one warp per member sums the squared
// differences and reduces with shuffles. The TPU kernel scored neighbours as
// a one-hot contraction on the matrix unit (page_scan.py:78-91), which only
// exists because the TPU gathers badly; here the query's (M, K) table is
// staged in shared memory and one thread per neighbour column gathers and
// sums M entries. The members-only variants never touch the code rows:
// MEM_ALL records have none.
//
// All eight variants (ADC or members only, masked or not, page ids or a
// staged batch) run one device function, score_record, on the record they
// were handed: a staged record and a resident one go through the same
// instructions in the same order, so the streamed search scores bit for bit
// like the resident one. The mask is applied after the warp sum; the ADC
// half is never masked (traversal has to cross filtered-out regions).
//
// Page ids outside [0, P) are clamped, as an XLA gather clamps them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Scores one record for one query. rec: the record in device memory; smem:
// mrows * 128 + dim (+ m * k with ADC) floats; mask_row: cap floats or null.
template <bool kAdc>
__device__ __forceinline__ void score_record(
    const float* __restrict__ rec, const float* __restrict__ qv,
    const float* __restrict__ lut, const float* __restrict__ mask_row,
    float* __restrict__ md_out, float* __restrict__ nd_out, float* smem,
    int mrows, int m, int k, int cap, int dim, int rp) {
  float* rec_s = smem;                  // mrows * 128
  float* q_s = rec_s + mrows * kLanes;  // dim
  float* lut_s = q_s + dim;             // m * k (ADC only)

  const float4* rec4 = reinterpret_cast<const float4*>(rec);
  float4* rec_s4 = reinterpret_cast<float4*>(rec_s);
  for (int i = threadIdx.x; i < mrows * (kLanes / 4); i += blockDim.x)
    rec_s4[i] = rec4[i];
  for (int i = threadIdx.x; i < dim; i += blockDim.x) q_s[i] = qv[i];
  if (kAdc) {
    for (int i = threadIdx.x; i < m * k; i += blockDim.x) lut_s[i] = lut[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  // d <= 128: 128/d members share a row; d > 128: a member spans
  // ceil(d/128) rows
  const int vpr = dim <= kLanes ? kLanes / dim : 1;
  const int rpv = dim <= kLanes ? 1 : (dim + kLanes - 1) / kLanes;
  for (int i = warp; i < cap; i += nwarps) {
    const float* v = rec_s + (i / vpr) * rpv * kLanes + (i % vpr) * dim;
    float acc = 0.f;
    for (int c = lane; c < dim; c += 32) {
      const float t = v[c] - q_s[c];
      acc = fmaf(t, t, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      // NaN masks fail the test, as jnp.where(mask > 0, ...) does
      if (mask_row != nullptr && !(mask_row[i] > 0.f)) acc = INFINITY;
      md_out[i] = acc;
    }
  }

  if (kAdc) {
    // code row s of the record holds subspace s of every neighbour; thread
    // j walks column j, so each row is read by consecutive threads
    const float* codes = rec + static_cast<size_t>(mrows) * kLanes;
    for (int j = threadIdx.x; j < rp; j += blockDim.x) {
      float acc = 0.f;
      for (int s = 0; s < m; ++s) {
        int code = static_cast<int>(codes[s * kLanes + j]);
        code = min(max(code, 0), k - 1);
        acc += lut_s[s * k + code];
      }
      nd_out[j] = acc;
    }
  }
}

template <bool kAdc, bool kMask, bool kStaged>
__global__ void __launch_bounds__(kThreads) page_scan_kernel(
    const float* __restrict__ recs, const int32_t* __restrict__ page_ids,
    const float* __restrict__ q, const float* __restrict__ lut,
    const float* __restrict__ mask, float* __restrict__ md,
    float* __restrict__ nd, int b, int num_pages, int rows, int mrows, int m,
    int k, int cap, int dim, int rp) {
  extern __shared__ float4 smem4[];
  const int item = blockIdx.x;  // query * b + slot
  const int qi = item / b;
  int rec_idx = item;
  if (!kStaged) rec_idx = min(max(page_ids[item], 0), num_pages - 1);
  score_record<kAdc>(
      recs + static_cast<size_t>(rec_idx) * rows * kLanes,
      q + static_cast<size_t>(qi) * dim,
      kAdc ? lut + static_cast<size_t>(qi) * m * k : nullptr,
      kMask ? mask + static_cast<size_t>(item) * cap : nullptr,
      md + static_cast<size_t>(item) * cap,
      kAdc ? nd + static_cast<size_t>(item) * rp : nullptr,
      reinterpret_cast<float*>(smem4), mrows, m, k, cap, dim, rp);
}

template <bool kAdc, bool kMask, bool kStaged>
cudaError_t launch(const float* recs, const int32_t* page_ids, const float* q,
                   const float* lut, const float* mask, float* md, float* nd,
                   int nq, int b, int num_pages, int rows, int mrows, int m,
                   int k, int cap, int dim, int rp, size_t smem,
                   cudaStream_t stream) {
  auto kernel = page_scan_kernel<kAdc, kMask, kStaged>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<nq * b, kThreads, smem, stream>>>(recs, page_ids, q, lut, mask, md,
                                             nd, b, num_pages, rows, mrows, m,
                                             k, cap, dim, rp);
  return cudaGetLastError();
}

template <bool kAdc, bool kMask>
cudaError_t launch_by_source(int staged, const float* recs,
                             const int32_t* page_ids, const float* q,
                             const float* lut, const float* mask, float* md,
                             float* nd, int nq, int b, int num_pages, int rows,
                             int mrows, int m, int k, int cap, int dim, int rp,
                             size_t smem, cudaStream_t s) {
  return staged ? launch<kAdc, kMask, true>(recs, page_ids, q, lut, mask, md,
                                            nd, nq, b, num_pages, rows, mrows,
                                            m, k, cap, dim, rp, smem, s)
                : launch<kAdc, kMask, false>(recs, page_ids, q, lut, mask, md,
                                             nd, nq, b, num_pages, rows, mrows,
                                             m, k, cap, dim, rp, smem, s);
}

}  // namespace

// mask == null: unmasked; staged != 0: recs is the (nq * b, rows, 128) staged
// batch and page_ids is ignored (num_pages then counts its records).
extern "C" int pageann_page_scan(const float* recs, const int32_t* page_ids,
                                 const float* q, const float* lut,
                                 const float* mask, float* md, float* nd,
                                 int nq, int b, int num_pages, int rows,
                                 int mrows, int m, int k, int cap, int dim,
                                 int rp, int compute_adc, int staged,
                                 void* stream) {
  if (nq == 0 || b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t floats = static_cast<size_t>(mrows) * kLanes + dim +
                        (compute_adc ? static_cast<size_t>(m) * k : 0);
  const size_t smem = floats * sizeof(float);
  cudaError_t err;
  if (compute_adc) {
    err = mask ? launch_by_source<true, true>(staged, recs, page_ids, q, lut,
                                              mask, md, nd, nq, b, num_pages,
                                              rows, mrows, m, k, cap, dim, rp,
                                              smem, s)
               : launch_by_source<true, false>(staged, recs, page_ids, q, lut,
                                               mask, md, nd, nq, b, num_pages,
                                               rows, mrows, m, k, cap, dim, rp,
                                               smem, s);
  } else {
    err = mask ? launch_by_source<false, true>(staged, recs, page_ids, q, lut,
                                               mask, md, nd, nq, b, num_pages,
                                               rows, mrows, m, k, cap, dim, rp,
                                               smem, s)
               : launch_by_source<false, false>(staged, recs, page_ids, q, lut,
                                                mask, md, nd, nq, b, num_pages,
                                                rows, mrows, m, k, cap, dim,
                                                rp, smem, s);
  }
  return static_cast<int>(err);
}
