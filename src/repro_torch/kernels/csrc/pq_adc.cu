// PQ asymmetric distance (ADC) for a batch of queries, the code rows
// gathered by id inside the kernel.
//
// Replaces: src/repro/kernels/pq_adc.py, pq_adc (the Pallas kernel
// _adc_kernel).
//
// Shapes (row-major; lut and out contiguous, ids rows of stride ids_stride):
//   table (R, M) u8      PQ code rows (the in-memory tier or the LSH sample)
//   ids   (Q, N) i64     row of the table each output scores, in [0, R);
//                        null: row q * N + n, i.e. the codes come gathered,
//                        a (Q, N, M) tensor seen as a (Q * N, M) table
//   lut   (Q, M, K) f32  query q's table of squared sub-distances
//   out   (Q, N) f32     out[q, n] = sum over j of lut[q, j, table[ids[q, n], j]]
//
// Bound on the H100: bytes. One add per code byte; the least time is the
// tables, the ids, the distinct code rows and the output over 3.35 TB/s, and
// the (M, K) tables are most of it (32 KB a query at M = 32, K = 256).
//
// Design: the TPU kernel built a one-hot (N, M*K) mask and contracted it on
// the matrix unit, because the TPU gathers badly. A GPU gathers from shared
// memory at full speed. One block serves one query (a query with more rows
// than the plan gives a block is split over blocks, each with its own copy
// of the table).
// Thread 0 starts one bulk asynchronous copy of the query's table into
// shared memory (cp.async.bulk, completion on an mbarrier); while it is in
// flight every thread loads its row id and that row's first 64 code bytes
// (16-byte vectors where the rows are 16-byte aligned, single bytes
// otherwise). Then the block waits on the barrier and each thread does its
// row's M lookups from shared memory, one f32 accumulator in the order
// j = 0 .. M-1 with codes clamped to K-1: the sums of every earlier version
// of this kernel, bit for bit. The launch plan (kernels/pq_adc.py) sizes
// the block to the rows: 32 threads for 16 rows, 256 for 240.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPre = 4;  // 16-byte code pieces a thread loads before the wait

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one bulk copy global -> shared that completes on ``bar`` (TMA's 1-D form);
// dst, src and bytes are multiples of 16
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 code bytes from p (the row's bytes j0 .. j0+15); kVec: one 16-byte load
// (aligned, all 16 in the row), else the ``left`` bytes still in the row
template <bool kVec>
__device__ __forceinline__ uint4 load_piece(const uint8_t* __restrict__ p,
                                            int left) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < left) w[b >> 2] |= static_cast<uint32_t>(__ldg(p + b)) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// acc += lut_s[(j0 + b) * k + min(code_b, k - 1)] for b = 0 .. cnt-1, in order
__device__ __forceinline__ float lookups(float acc, uint4 c,
                                         const float* __restrict__ t, int cnt,
                                         int k) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (b < cnt) {
      const int code = static_cast<int>((w[b >> 2] >> (8 * (b & 3))) & 0xFFu);
      acc += t[b * k + min(code, k - 1)];
    }
  }
  return acc;
}

template <bool kIds>
__device__ __forceinline__ int64_t row_id(const long long* __restrict__ ids,
                                          int qi, int i, int n, int ids_stride) {
  if (kIds) return __ldg(ids + static_cast<int64_t>(qi) * ids_stride + i);
  return static_cast<int64_t>(qi) * n + i;
}

// kIds: rows by id (else the codes come gathered);
// kVec: code rows are 16-byte aligned and M % 16 == 0;
// kBulk: the table goes by one bulk copy (query tables 16-byte aligned),
// else by a plain loop of loads and stores before a barrier
template <bool kIds, bool kVec, bool kBulk>
__global__ void __launch_bounds__(kMaxThreads) pq_adc_kernel(
    const uint8_t* __restrict__ table, const long long* __restrict__ ids,
    const float* __restrict__ lut, float* __restrict__ out, int n, int m, int k,
    int ids_stride, int chunks, int rows_per_block) {
  extern __shared__ __align__(128) float lut_s[];
  __shared__ __align__(8) uint64_t bar;
  const int qi = blockIdx.x / chunks;
  const int first = (blockIdx.x % chunks) * rows_per_block;
  const int last = min(n, first + rows_per_block);
  const int mk = m * k;
  const float* l = lut + static_cast<size_t>(qi) * mk;
  const uint32_t bar_a = smem_u32(&bar);
  if (kBulk) {
    if (threadIdx.x == 0) {
      mbar_init(bar_a, 1);
      bulk_load(smem_u32(lut_s), l, static_cast<uint32_t>(mk) * 4u, bar_a);
    }
  } else {
    for (int t = threadIdx.x; t < mk; t += blockDim.x) lut_s[t] = l[t];
  }

  // the first row's id and code bytes, in flight while the table lands
  int i = first + threadIdx.x;
  const uint8_t* row = nullptr;
  uint4 pre[kPre] = {};
  if (i < last) {
    row = table + row_id<kIds>(ids, qi, i, n, ids_stride) * m;
#pragma unroll
    for (int p = 0; p < kPre; ++p)
      if (16 * p < m) pre[p] = load_piece<kVec>(row + 16 * p, m - 16 * p);
  }
  __syncthreads();  // the barrier's init (bulk) or the table (plain loop)
  if (kBulk) mbar_wait(bar_a, 0);

  while (i < last) {
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < kPre; ++p)
      if (16 * p < m)
        acc = lookups(acc, pre[p], lut_s + 16 * p * k,
                      kVec ? 16 : min(16, m - 16 * p), k);
    for (int j0 = 16 * kPre; j0 < m; j0 += 16)
      acc = lookups(acc, load_piece<kVec>(row + j0, m - j0), lut_s + j0 * k,
                    kVec ? 16 : min(16, m - j0), k);
    out[static_cast<size_t>(qi) * n + i] = acc;
    i += blockDim.x;
    if (i < last) {
      row = table + row_id<kIds>(ids, qi, i, n, ids_stride) * m;
#pragma unroll
      for (int p = 0; p < kPre; ++p)
        if (16 * p < m) pre[p] = load_piece<kVec>(row + 16 * p, m - 16 * p);
    }
  }
}

template <bool kIds, bool kVec, bool kBulk>
int launch(const uint8_t* table, const long long* ids, const float* lut,
           float* out, int ids_stride, int nq, int n, int m, int k, int chunks,
           int rows_per_block, int threads, cudaStream_t stream) {
  auto kernel = pq_adc_kernel<kIds, kVec, kBulk>;
  const size_t smem = static_cast<size_t>(m) * k * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nq * chunks, threads, smem, stream>>>(
      table, ids, lut, out, n, m, k, ids_stride, chunks, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <bool kIds>
int launch_ids(const uint8_t* table, const long long* ids, const float* lut,
               float* out, int ids_stride, int nq, int n, int m, int k,
               int chunks, int rows_per_block, int threads, cudaStream_t stream) {
  const bool vec = m % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const bool bulk = (m * k) % 4 == 0 && reinterpret_cast<uintptr_t>(lut) % 16 == 0;
#define PQ_ADC_LAUNCH(V, B)                                                   \
  return launch<kIds, V, B>(table, ids, lut, out, ids_stride, nq, n, m, k, \
                                chunks, rows_per_block, threads, stream)
  if (vec) {
    if (bulk) PQ_ADC_LAUNCH(true, true);
    PQ_ADC_LAUNCH(true, false);
  }
  if (bulk) PQ_ADC_LAUNCH(false, true);
  PQ_ADC_LAUNCH(false, false);
#undef PQ_ADC_LAUNCH
}

}  // namespace

// ids null: the codes come gathered as (Q, N, M); chunks, rows_per_block
// and threads from the launch plan (grid nq * chunks)
extern "C" int pageann_pq_adc(const uint8_t* table, const long long* ids,
                              const float* lut, float* out, int ids_stride,
                              int nq, int n, int m, int k, int chunks,
                              int rows_per_block, int threads, void* stream) {
  if (nq == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids != nullptr)
    return launch_ids<true>(table, ids, lut, out, ids_stride, nq, n, m, k,
                            chunks, rows_per_block, threads, s);
  return launch_ids<false>(table, nullptr, lut, out, 0, nq, n, m, k, chunks,
                           rows_per_block, threads, s);
}

// blocks of the main path's instantiation (rows by id, 16-byte code rows,
// bulk table copy) that one SM holds at once, for ``threads`` threads and
// ``smem_bytes`` of table
extern "C" int pageann_pq_adc_blocks_per_sm(int threads, int smem_bytes,
                                            int* blocks) {
  auto kernel = pq_adc_kernel<true, true, true>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, static_cast<size_t>(smem_bytes)));
}
