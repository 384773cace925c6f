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
// 3.35 TB/s, and with ADC the query's (M, K) table (16 KB at M = 16,
// K = 256) is the largest single input.
//
// What bounds a scan with one block per (query, page): every block stages
// its query's whole table, so a hop moves b times the table bytes the bound
// counts (82 MB at Q = 1,000, b = 5, against 16 MB); the table, copied with
// scalar loads, fills most of the block's shared memory; and each neighbour
// column walks M dependent global loads, one after the other.
//
// Design. The TPU kernel scored neighbours as a one-hot contraction on the
// matrix unit (page_scan.py:78-91), which only exists because the TPU gathers
// badly; here the table sits in shared memory and one thread per neighbour
// column gathers and sums M entries.
//   - ADC variants: one block per query owns its b pages (the launch plan
//     splits them over a few blocks when there are too few queries to fill
//     the SMs). The block stages the query vector and the table once, and in
//     the same step the member rows of a chunk of its pages, all with 16-byte
//     cp.async, so the query's pages are in flight together. Pages beyond
//     one chunk's shared memory are scored chunk after chunk. Tasks are
//     stepped to, never divided out: these blocks are short, and integer
//     division in the copy and task loops cost a members-only scan a third
//     of its time on the H100.
//   - Member L2: one warp per (page, member) of the chunk: lane-strided FMAs,
//     then an xor-shuffle tree (member_l2.cuh, which page_gather.cu also
//     sums with). The mask is applied after the warp sum.
//   - Neighbour ADC: one thread per (page, column). The M code floats of the
//     column are loaded together (when M is 4, 8 or 16 the first column's
//     loads are issued before the block waits for its staging copies, so the
//     two overlap; any other M loads in groups of 4), then the table entries
//     are summed in the order s = 0 .. M-1. The ADC is never masked
//     (traversal has to cross filtered-out regions).
//   - Members-only variants (page_scan_members_kernel) have no table to share.
//     With a block per (query, page) they are latency-bound: at Q = 1,000 each
//     of ~2.4 waves of blocks waits on the page id, then on its staged record,
//     then on a barrier. So one warp scores one (query, slot) item, a block
//     holds a few consecutive items (mostly of one query, so the query's loads
//     hit L1), and there is no shared memory and no barrier: at Q = 1,000,
//     b = 5 the 5,000 warps take 1.2 waves. The warp loads its page id, then
//     issues every member load of the record (capacity x ceil(d/32) coalesced
//     warp loads through the read-only path, in groups of at most 32 a lane),
//     the query's columns and the mask words, and only then sums. The
//     xor-shuffle tree of a group runs on all its members at once: each step a
//     lane keeps half of its values and adds the partner lane's copy of that
//     half, so 8 members of d = 128 take 9 shuffles instead of 40, and each
//     member ends in 32 / 8 lanes. MEM_ALL records have no code rows.
// Every variant sums a member with member_l2.cuh, as page_gather.cu does:
// lane l takes columns l, l + 32, ... in order with fmaf, then the
// xor-shuffle tree (offsets 16 down to 1, own value first), then the mask.
// So the members-only and ADC variants give the same member scores, and a
// staged record scores bit for bit like the same record read by page id (the
// streamed search equals the resident one); the chunking and the plan do not
// change any sum.
//
// The launch plan (grid, threads, shared bytes, pages per block and per
// chunk) is computed by the wrapper (kernels/page_scan.py, launch_plan) and
// checked here. Page ids outside [0, P) are clamped, as an XLA gather clamps
// them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "member_l2.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kMaxThreads = 256;
// Blocks of kMaxThreads that must fit on an SM (launch bounds, so a register
// cap). An ADC block keeps M codes a thread in flight: 4 caps it at 64
// registers; a cap of 40 (6 blocks) spilled them and ran 8-13% slower on
// the H100. A members-only warp keeps up to 32 member floats a lane in
// flight: 4 caps it at 64 registers (32 warps an SM, 4,224 on the card);
// 5 (48 registers, one wave of 5,000 warps) spilled and ran 11-31% slower.
constexpr int kAdcMinBlocks = 4;
constexpr int kMembersMinBlocks = 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n floats from device to shared memory by the whole block: 16-byte
// cp.async when both ends are aligned and n is a multiple of 4, else plain
// loads. Visible to the block after cp_async_wait_all and __syncthreads.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  const bool vec = (((reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst)) & 15) == 0) &&
                   (n & 3) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// The record of (query, slot) item: from the page store by clamped page id,
// or item itself in a staged batch.
template <bool kStaged>
__device__ __forceinline__ const float* record(
    const float* __restrict__ recs, const int32_t* __restrict__ page_ids,
    size_t item, int num_pages, int rows) {
  size_t r = item;
  if (!kStaged) r = min(max(__ldg(page_ids + item), 0), num_pages - 1);
  return recs + r * rows * kLanes;
}

// One member's squared L2 to the query, summed by the whole warp.
__device__ __forceinline__ float member_l2(const float* v, const float* q_s,
                                           int dim, int lane) {
  float acc = 0.f;
  for (int c = lane; c < dim; c += 32) {
    const float t = v[c] - q_s[c];
    acc = fmaf(t, t, acc);
  }
  return warp_sum(acc);
}

// Adds the table entry of one code (a float, cast and clamped to [0, K)).
__device__ __forceinline__ float lookup(float acc, float code_f,
                                        const float* lut_row, int k) {
  const int code = min(max(static_cast<int>(code_f), 0), k - 1);
  return acc + lut_row[code];
}

// Code row s of a record holds subspace s of every neighbour, so the kM
// codes of column col are kLanes floats apart; consecutive threads read
// consecutive columns.
template <int kM>
__device__ __forceinline__ void load_codes(float (&c)[kM], const float* col) {
#pragma unroll
  for (int s = 0; s < kM; ++s) c[s] = __ldg(col + s * kLanes);
}

template <int kM>
__device__ __forceinline__ float adc_sum(const float (&c)[kM],
                                         const float* lut_s, int k) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < kM; ++s) acc = lookup(acc, c[s], lut_s + s * k, k);
  return acc;
}

// Any M: loads in groups of 4, sums in the same order s = 0 .. M-1.
__device__ __forceinline__ float adc_sum_any(const float* col,
                                             const float* lut_s, int m,
                                             int k) {
  float acc = 0.f;
  for (int s0 = 0; s0 < m; s0 += 4) {
    float c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      c[u] = s0 + u < m ? __ldg(col + (s0 + u) * kLanes) : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (s0 + u < m) acc = lookup(acc, c[u], lut_s + (s0 + u) * k, k);
  }
  return acc;
}

// kM: the number of code rows when it is 4, 8 or 16 (unrolled), else 0.
template <bool kMask, bool kStaged, int kM>
__global__ void __launch_bounds__(kMaxThreads, kAdcMinBlocks)
    page_scan_adc_kernel(
    const float* __restrict__ recs, const int32_t* __restrict__ page_ids,
    const float* __restrict__ q, const float* __restrict__ lut,
    const float* __restrict__ mask, float* __restrict__ md,
    float* __restrict__ nd, int b, int groups, int ppb, int ppc,
    int num_pages, int rows, int mrows, int m, int k, int cap, int dim,
    int rp) {
  extern __shared__ float4 smem4[];
  const int rec_floats = mrows * kLanes;
  float* rec_s = reinterpret_cast<float*>(smem4);     // ppc * rec_floats
  float* lut_s = rec_s + ppc * rec_floats;            // m * k (ADC only)
  float* q_s = lut_s + m * k;                          // dim
  const int qi = blockIdx.x / groups;  // groups: blocks per query
  const int first = (blockIdx.x - qi * groups) * ppb;
  const int last = min(b, first + ppb);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  // d <= 128: 128/d members share a row; d > 128: a member spans
  // ceil(d/128) rows
  const int vpr = dim <= kLanes ? kLanes / dim : 1;
  const int rpv = dim <= kLanes ? 1 : (dim + kLanes - 1) / kLanes;

  stage(q_s, q + static_cast<size_t>(qi) * dim, dim);
  stage(lut_s, lut + static_cast<size_t>(qi) * m * k, m * k);
  // the first (page, member) of this warp and (page, column) of this thread
  // in a chunk; later ones are stepped to, not divided out
  int mem_p0 = 0, mem_i0 = warp;
  for (; mem_i0 >= cap; mem_i0 -= cap) ++mem_p0;
  const int col_p0 = threadIdx.x / rp;
  const int col_j0 = threadIdx.x - col_p0 * rp;
  for (int c0 = first; c0 < last; c0 += ppc) {
    const int n = min(ppc, last - c0);
    const size_t item0 = static_cast<size_t>(qi) * b + c0;
    if (c0 > first) __syncthreads();  // the last chunk's rows are consumed
    for (int p = 0; p < n; ++p) {
      const float* rec = record<kStaged>(recs, page_ids, item0 + p,
                                         num_pages, rows);
      float* dst = rec_s + p * rec_floats;
      for (int i = 4 * threadIdx.x; i < rec_floats; i += 4 * blockDim.x)
        cp_async16(dst + i, rec + i);
    }
    float codes[kM > 0 ? kM : 1];
    if constexpr (kM > 0) {
      if (col_p0 < n)
        load_codes<kM>(codes, record<kStaged>(recs, page_ids, item0 + col_p0,
                                              num_pages, rows) +
                                  rec_floats + col_j0);
    }
    cp_async_wait_all();
    __syncthreads();

    for (int p = mem_p0, i = mem_i0; p < n;) {
      const float* v = rec_s + p * rec_floats + (i / vpr) * rpv * kLanes +
                       (i % vpr) * dim;
      float acc = member_l2(v, q_s, dim, lane);
      if (lane == 0) {
        const size_t out = (item0 + p) * cap + i;
        // NaN masks fail the test, as jnp.where(mask > 0, ...) does
        if (kMask && !(mask[out] > 0.f)) acc = INFINITY;
        md[out] = acc;
      }
      for (i += nwarps; i >= cap; i -= cap) ++p;
    }

    bool prefetched = kM > 0;
    for (int p = col_p0, j = col_j0; p < n;) {
      const float* col = record<kStaged>(recs, page_ids, item0 + p,
                                         num_pages, rows) +
                         rec_floats + j;
      float acc;
      if constexpr (kM > 0) {
        if (!prefetched) load_codes<kM>(codes, col);
        acc = adc_sum<kM>(codes, lut_s, k);
      } else {
        acc = adc_sum_any(col, lut_s, m, k);
      }
      nd[(item0 + p) * rp + j] = acc;
      prefetched = false;
      for (j += blockDim.x; j >= rp; j -= rp) ++p;
    }
  }
}

// Members only: one warp per (query, slot) item, blockDim.x / 32
// consecutive items a block, no shared memory. kJ: the columns a lane takes
// from one 128-float row, ceil(d / 32) when d <= 128; kSpan: d > 128 (kJ is
// then 4 and a member spans ceil(d / 128) rows, summed row after row).
// Members go in groups of kG, at most 32 loads a lane in flight; member i
// of a group is summed into lanes i * 32 / kG on, and the first of them
// stores it.
template <bool kMask, bool kStaged, int kJ, bool kSpan>
__global__ void __launch_bounds__(kMaxThreads, kMembersMinBlocks)
    page_scan_members_kernel(
    const float* __restrict__ recs, const int32_t* __restrict__ page_ids,
    const float* __restrict__ q, const float* __restrict__ mask,
    float* __restrict__ md, int b, int items, int num_pages, int rows,
    int cap, int dim) {
  constexpr int kG = kJ == 1 ? 32 : kJ == 2 ? 16 : 8;  // divides 32
  constexpr int kLanesPer = 32 / kG;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= items) return;
  const float* rec = record<kStaged>(recs, page_ids, item, num_pages, rows);
  const float* qv = q + static_cast<size_t>(item / b) * dim;
  // d <= 128: 128/d members share a row; d > 128: a member spans
  // ceil(d/128) rows. From d = 65 on a row holds one member, known here,
  // so the member loads take fixed offsets from one address.
  const int vpr = kJ >= 3 ? 1 : kLanes / dim;
  const int row_floats =
      kSpan ? (dim + kLanes - 1) / kLanes * kLanes : kLanes;
  const size_t out = static_cast<size_t>(item) * cap;
  for (int g0 = 0; g0 < cap; g0 += kG) {
    const int mi = g0 + lane / kLanesPer;  // the member this lane sums
    // NaN masks fail the test, as jnp.where(mask > 0, ...) does
    const bool pass = !kMask || (mi < cap && __ldg(mask + out + mi) > 0.f);
    const int r = g0 / vpr;
    float acc[kG];
    member_slab<kJ, kG, true>(acc, rec, r * row_floats, g0 - r * vpr,
                              row_floats, vpr, cap - g0, qv, lane, dim);
    if constexpr (kSpan) {
      for (int c = lane + 32 * kJ; c < dim; c += 32 * kJ)
        member_slab<kJ, kG, false>(acc, rec, r * row_floats, g0 - r * vpr,
                                   row_floats, vpr, cap - g0, qv, c, dim);
    }
    const float sum = warp_sums<kG>(acc, lane);
    if (lane % kLanesPer == 0 && mi < cap)
      md[out + mi] = pass ? sum : INFINITY;
  }
}

struct Args {
  const float* recs;
  const int32_t* page_ids;
  const float* q;
  const float* lut;
  const float* mask;
  float* md;
  float* nd;
  int b, groups, ppb, ppc, num_pages, rows, mrows, m, k, cap, dim, rp;
  int grid, threads, smem;
};

template <bool kMask, bool kStaged, int kM>
cudaError_t launch_adc(const Args& a, cudaStream_t stream) {
  auto kernel = page_scan_adc_kernel<kMask, kStaged, kM>;
  if (a.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.grid, a.threads, a.smem, stream>>>(
      a.recs, a.page_ids, a.q, a.lut, a.mask, a.md, a.nd, a.b, a.groups,
      a.ppb, a.ppc, a.num_pages, a.rows, a.mrows, a.m, a.k, a.cap, a.dim,
      a.rp);
  return cudaGetLastError();
}

template <bool kMask, bool kStaged, int kJ, bool kSpan>
cudaError_t launch_members(const Args& a, int items, cudaStream_t stream) {
  page_scan_members_kernel<kMask, kStaged, kJ, kSpan>
      <<<a.grid, a.threads, 0, stream>>>(a.recs, a.page_ids, a.q, a.mask,
                                         a.md, a.b, items, a.num_pages,
                                         a.rows, a.cap, a.dim);
  return cudaGetLastError();
}

template <bool kMask, bool kStaged>
cudaError_t launch_src(bool adc, int items, const Args& a, cudaStream_t s) {
  if (adc) {
    switch (a.m) {
      case 4: return launch_adc<kMask, kStaged, 4>(a, s);
      case 8: return launch_adc<kMask, kStaged, 8>(a, s);
      case 16: return launch_adc<kMask, kStaged, 16>(a, s);
      default: return launch_adc<kMask, kStaged, 0>(a, s);
    }
  }
  switch ((a.dim + 31) / 32) {
    case 1: return launch_members<kMask, kStaged, 1, false>(a, items, s);
    case 2: return launch_members<kMask, kStaged, 2, false>(a, items, s);
    case 3: return launch_members<kMask, kStaged, 3, false>(a, items, s);
    case 4: return launch_members<kMask, kStaged, 4, false>(a, items, s);
    default: return launch_members<kMask, kStaged, 4, true>(a, items, s);
  }
}

}  // namespace

// mask == null: unmasked; staged != 0: recs is the (nq * b, rows, 128) staged
// batch and page_ids is ignored (num_pages then counts its records). grid,
// threads, smem, pages_per_block and pages_per_chunk are the launch plan
// (members only: pages_per_block is the block's warps, one page each, and
// pages_per_chunk 1); a plan the kernel cannot run returns
// cudaErrorInvalidValue.
extern "C" int pageann_page_scan(const float* recs, const int32_t* page_ids,
                                 const float* q, const float* lut,
                                 const float* mask, float* md, float* nd,
                                 int nq, int b, int num_pages, int rows,
                                 int mrows, int m, int k, int cap, int dim,
                                 int rp, int compute_adc, int staged,
                                 int grid, int threads, int smem,
                                 int pages_per_block, int pages_per_chunk,
                                 void* stream) {
  if (nq == 0 || b == 0) return 0;
  const int ppb = pages_per_block, ppc = pages_per_chunk;
  const long long items = static_cast<long long>(nq) * b;
  bool ok = threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
            ppb >= 1 && ppc >= 1 && ppc <= ppb && smem >= 0;
  int groups = 0;
  if (compute_adc) {
    groups = ok ? (b + ppb - 1) / ppb : 0;
    const long long floats = static_cast<long long>(ppc) * mrows * kLanes +
                             static_cast<long long>(m) * k + dim;
    ok = ok && grid == nq * groups &&
         static_cast<long long>(smem) >= floats * 4;
  } else {
    ok = ok && ppb == threads / 32 && ppc == 1 &&
         grid == (items + ppb - 1) / ppb && items <= INT32_MAX;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{recs, page_ids, q, lut, mask, md, nd, b, groups, ppb, ppc,
               num_pages, rows, mrows, m, k, cap, dim, rp, grid, threads,
               smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool adc = compute_adc != 0;
  const int n = static_cast<int>(items);
  cudaError_t err;
  if (mask) {
    err = staged ? launch_src<true, true>(adc, n, a, s)
                 : launch_src<true, false>(adc, n, a, s);
  } else {
    err = staged ? launch_src<false, true>(adc, n, a, s)
                 : launch_src<false, false>(adc, n, a, s);
  }
  return static_cast<int>(err);
}
