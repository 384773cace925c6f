// Fused page scan for one search hop: member L2 and neighbour ADC from one
// read of each packed page record.
//
// Replaces: src/repro/kernels/page_scan.py, page_scan (the Pallas kernels
// _page_scan_kernel and _page_scan_members_kernel).
//
// Shapes (all row-major, contiguous):
//   recs     (P, rows, 128) f32  packed page records (core/layout.py)
//   page_ids (Q, b) i32          the hop's pages for each query
//   q        (Q, d) f32          the hop's queries
//   lut      (Q, M, K) f32       the query's ADC table (ADC only)
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
// sums M entries. The members-only variant never touches the code rows:
// MEM_ALL records have none.
//
// Page ids outside [0, P) are clamped, as an XLA gather clamps them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kAdc>
__global__ void __launch_bounds__(kThreads) page_scan_kernel(
    const float* __restrict__ recs, const int32_t* __restrict__ page_ids,
    const float* __restrict__ q, const float* __restrict__ lut,
    float* __restrict__ md, float* __restrict__ nd, int b, int num_pages,
    int rows, int mrows, int m, int k, int cap, int dim, int rp) {
  extern __shared__ float4 smem4[];
  float* rec_s = reinterpret_cast<float*>(smem4);  // mrows * 128
  float* q_s = rec_s + mrows * kLanes;              // dim
  float* lut_s = q_s + dim;                         // m * k (ADC only)

  const int item = blockIdx.x;  // query * b + slot
  const int qi = item / b;
  int pid = page_ids[item];
  pid = min(max(pid, 0), num_pages - 1);

  const float* rec = recs + static_cast<size_t>(pid) * rows * kLanes;
  const float4* rec4 = reinterpret_cast<const float4*>(rec);
  for (int i = threadIdx.x; i < mrows * (kLanes / 4); i += blockDim.x)
    smem4[i] = rec4[i];
  const float* qv = q + static_cast<size_t>(qi) * dim;
  for (int i = threadIdx.x; i < dim; i += blockDim.x) q_s[i] = qv[i];
  if (kAdc) {
    const float* l = lut + static_cast<size_t>(qi) * m * k;
    for (int i = threadIdx.x; i < m * k; i += blockDim.x) lut_s[i] = l[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  // d <= 128: 128/d members share a row; d > 128: a member spans
  // ceil(d/128) rows
  const int vpr = dim <= kLanes ? kLanes / dim : 1;
  const int rpv = dim <= kLanes ? 1 : (dim + kLanes - 1) / kLanes;
  float* md_out = md + static_cast<size_t>(item) * cap;
  for (int i = warp; i < cap; i += nwarps) {
    const float* v = rec_s + (i / vpr) * rpv * kLanes + (i % vpr) * dim;
    float acc = 0.f;
    for (int c = lane; c < dim; c += 32) {
      const float t = v[c] - q_s[c];
      acc = fmaf(t, t, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) md_out[i] = acc;
  }

  if (kAdc) {
    // code row s of the record holds subspace s of every neighbour; thread
    // j walks column j, so each row is read by consecutive threads
    const float* codes = rec + static_cast<size_t>(mrows) * kLanes;
    float* nd_out = nd + static_cast<size_t>(item) * rp;
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

template <bool kAdc>
cudaError_t launch(const float* recs, const int32_t* page_ids, const float* q,
                   const float* lut, float* md, float* nd, int nq, int b,
                   int num_pages, int rows, int mrows, int m, int k, int cap,
                   int dim, int rp, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        page_scan_kernel<kAdc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  page_scan_kernel<kAdc><<<nq * b, kThreads, smem, stream>>>(
      recs, page_ids, q, lut, md, nd, b, num_pages, rows, mrows, m, k, cap,
      dim, rp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pageann_page_scan(const float* recs, const int32_t* page_ids,
                                 const float* q, const float* lut, float* md,
                                 float* nd, int nq, int b, int num_pages,
                                 int rows, int mrows, int m, int k, int cap,
                                 int dim, int rp, int compute_adc,
                                 void* stream) {
  if (nq == 0 || b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t floats = static_cast<size_t>(mrows) * kLanes + dim +
                        (compute_adc ? static_cast<size_t>(m) * k : 0);
  const size_t smem = floats * sizeof(float);
  cudaError_t err =
      compute_adc
          ? launch<true>(recs, page_ids, q, lut, md, nd, nq, b, num_pages, rows,
                         mrows, m, k, cap, dim, rp, smem, s)
          : launch<false>(recs, page_ids, q, lut, md, nd, nq, b, num_pages,
                          rows, mrows, m, k, cap, dim, rp, smem, s);
  return static_cast<int>(err);
}
