// XOR + popcount Hamming sweep for the LSH router, for a batch of queries:
// the distances alone, and fused with the routing's stable top-T.
//
// Replaces: src/repro/kernels/hamming.py, hamming (the Pallas kernel
// _hamming_kernel); the fused kernel also replaces the lax.top_k that
// src/repro/core/search.py (_top_k_merge, init_state) runs on its output.
//
// Shapes (row-major, contiguous):
//   codes  (S, W) u32   sampled vectors' packed sign bits (int32 in torch)
//   qcodes (Q, W) u32   the queries' packed sign bits
//   out    (Q, S) i32   out[q, s] = popcount(codes[s] ^ qcodes[q])
//   vals   (Q, T) i32   the first T of a stable ascending sort of out[q]
//   idx    (Q, T) i32   their samples: the lower sample first on ties
//
// Bound on the H100: bytes. A few integer operations per 4-byte word. The
// distances' least time is the codes and the output over 3.35 TB/s (the
// output dominates once Q is large); the fused kernel writes only the
// (Q, T) result, so one launch is far above its bound.
//
// Design. The TPU kernel counted bits with a SWAR bit-twiddle on the vector
// unit; the GPU has a popcount instruction (__popc).
//   - Distances: one block of 256 threads covers 1,024 samples of one query
//     (blockIdx.x the query, blockIdx.y the chunk: no division). Each thread
//     scores 4 consecutive samples: their 4 W code words are W 16-byte
//     loads, the query's W words sit in registers, and the 4 results go out
//     in one 16-byte store, so a warp stores 512 contiguous bytes. This
//     holds for W = 2, the 64 bits every configuration routes with; other
//     W, codes not 16-byte aligned, an output row not 16-byte aligned
//     (S % 4 != 0) and the last group of a row take scalar loads or stores.
//   - Stable top-T: one block of 256 threads per query, a counting sort on
//     the 32 W + 1 possible values. Warp w owns samples [w R, (w + 1) R)
//     (R a multiple of 32) and scores them 32 at a time in index order,
//     the first 4 chunks (all of them at S = 1,024) once, their loads in
//     flight together, kept in registers for both passes. Pass 1 counts
//     each value per warp with shared-memory atomic adds (counts commute,
//     so their order does not change the result). The counts become, per
//     value, the entries in earlier warps and, by one warp's scan, the
//     entries of smaller values; the scan also finds v*, the T-th smallest
//     value. Pass 2 places each entry of value v <= v* at (entries of
//     smaller value) + (same value in earlier warps) + (same value earlier
//     in its own warp: a running count plus its rank among the equal lanes
//     of __match_any_sync); only places below T are written, and a chunk
//     with no entry <= v* is skipped. Every place is that of a stable sort,
//     whatever order the warps run in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // both kernels
constexpr int kPerThread = 4;             // distances: samples a thread
constexpr int kChunk = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;     // top-T: warps a block
constexpr int kTopMinBlocks = 8;          // top-T: blocks an SM (32 registers)
constexpr int kCached = 4;                // top-T: chunks a warp keeps (S <= 1,024)

// kW: 2, the words of the LSH's 64-bit codes (query words in registers,
// 16-byte code loads), or 0 (any W, scalar loads).
template <int kW>
__global__ void __launch_bounds__(kThreads) hamming_kernel(
    const uint32_t* __restrict__ codes, const uint32_t* __restrict__ qcodes,
    int32_t* __restrict__ out, int s, int w, bool vec_codes, bool vec_out) {
  const int s0 = (blockIdx.y * kThreads + threadIdx.x) * kPerThread;
  if (s0 >= s) return;
  const int n = min(kPerThread, s - s0);
  const uint32_t* qc = qcodes + static_cast<size_t>(blockIdx.x) * (kW ? kW : w);
  int acc[kPerThread] = {0, 0, 0, 0};
  if constexpr (kW > 0) {
    uint32_t qw[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) qw[k] = __ldg(qc + k);
    const uint32_t* c = codes + static_cast<size_t>(s0) * kW;
    if (n == kPerThread && vec_codes) {
      // 4 samples x kW words = kW 16-byte vectors, word e of vector v is
      // word (4 v + e) % kW of sample (4 v + e) / kW
#pragma unroll
      for (int v = 0; v < kW; ++v) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(c) + v);
        const uint32_t word[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[(4 * v + e) / kW] += __popc(word[e] ^ qw[(4 * v + e) % kW]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        if (i < n) {
#pragma unroll
          for (int k = 0; k < kW; ++k)
            acc[i] += __popc(__ldg(c + i * kW + k) ^ qw[k]);
        }
    }
  } else {
    const uint32_t* c = codes + static_cast<size_t>(s0) * w;
    for (int i = 0; i < n; ++i)
      for (int k = 0; k < w; ++k)
        acc[i] += __popc(__ldg(c + i * w + k) ^ __ldg(qc + k));
  }
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * s + s0;
  if (n == kPerThread && vec_out) {
    *reinterpret_cast<int4*>(o) = make_int4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      if (i < n) o[i] = acc[i];
  }
}

// Hamming distance of sample i to the query words qw (kW > 0) or qc.
template <int kW>
__device__ __forceinline__ int distance(const uint32_t* __restrict__ codes,
                                        const uint32_t (&qw)[kW > 0 ? kW : 1],
                                        const uint32_t* __restrict__ qc,
                                        int i, int w) {
  int acc = 0;
  if constexpr (kW > 0) {
    const uint32_t* c = codes + static_cast<size_t>(i) * kW;
#pragma unroll
    for (int k = 0; k < kW; ++k) acc += __popc(__ldg(c + k) ^ qw[k]);
  } else {
    const uint32_t* c = codes + static_cast<size_t>(i) * w;
    for (int k = 0; k < w; ++k) acc += __popc(__ldg(c + k) ^ __ldg(qc + k));
  }
  return acc;
}

// Shared memory: cnt[kWarps][bins] then base[bins], bins = 32 W + 1. At
// most 32 registers a thread (8 blocks an SM), so Q = 1,000 blocks run in one
// wave on the H100: uncapped (48-56 registers) the kernel ran 8-10% longer
// there; counting pass 1 with __match_any_sync instead of atomic adds, 48%
// longer; placing every chunk in pass 2 instead of skipping, 17% longer.
template <int kW>
__global__ void __launch_bounds__(kThreads, kTopMinBlocks) hamming_topk_kernel(
    const uint32_t* __restrict__ codes, const uint32_t* __restrict__ qcodes,
    int32_t* __restrict__ vals, int32_t* __restrict__ idx, int s, int w,
    int t, int run) {
  extern __shared__ int smem[];
  __shared__ int vstar;
  const int ww = kW > 0 ? kW : w;
  const int bins = 32 * ww + 1;
  int* cnt = smem;
  int* base = smem + kWarps * bins;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const int qi = blockIdx.x;
  const uint32_t* qc = qcodes + static_cast<size_t>(qi) * ww;
  uint32_t qw[kW > 0 ? kW : 1];
  if constexpr (kW > 0) {
#pragma unroll
    for (int k = 0; k < kW; ++k) qw[k] = __ldg(qc + k);
  }
  for (int i = threadIdx.x; i < kWarps * bins; i += kThreads) cnt[i] = 0;
  // the warp's samples, 32 at a time; out-of-range lanes take the value
  // bins, which no count holds. The first kCached chunks are scored once,
  // all their loads in flight together, and kept for pass 2.
  const int first = warp * run;
  const int last = min(s, first + run);
  auto score = [&](int i0) {
    const int i = i0 + lane;
    return i < last ? distance<kW>(codes, qw, qc, i, w) : bins;
  };
  int cached[kCached];
#pragma unroll
  for (int c = 0; c < kCached; ++c) cached[c] = score(first + 32 * c);
  __syncthreads();

  // pass 1: per-warp counts of each value
  int* mine = cnt + warp * bins;
  auto count = [&](int v) {
    if (v < bins) atomicAdd(mine + v, 1);
  };
#pragma unroll
  for (int c = 0; c < kCached; ++c)
    if (first + 32 * c < last) count(cached[c]);
  for (int i0 = first + 32 * kCached; i0 < last; i0 += 32) count(score(i0));
  __syncthreads();

  // per value: the entries of earlier warps (exclusive, in place) and the
  // total (into base)
  for (int v = threadIdx.x; v < bins; v += kThreads) {
    int c[kWarps];
#pragma unroll
    for (int k = 0; k < kWarps; ++k) c[k] = cnt[k * bins + v];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      cnt[k * bins + v] = sum;
      sum += c[k];
    }
    base[v] = sum;
  }
  __syncthreads();

  // one warp: base[v] becomes the entries of smaller value, up to v*, the
  // smallest value whose entries and the smaller ones' reach t
  if (warp == 0) {
    int carry = 0;
    for (int v0 = 0; v0 < bins; v0 += 32) {
      const int v = v0 + lane;
      const int total = v < bins ? base[v] : 0;
      int incl = total;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      if (v < bins) base[v] = carry + incl - total;
      const unsigned hit = __ballot_sync(0xffffffffu, v < bins && carry + incl >= t);
      if (hit) {
        if (lane == 0) vstar = v0 + __ffs(hit) - 1;
        break;
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();

  // pass 2: place every entry of value <= v*, in index order within the
  // warp; a chunk without one is skipped
  const int vmax = vstar;
  int32_t* vq = vals + static_cast<size_t>(qi) * t;
  int32_t* iq = idx + static_cast<size_t>(qi) * t;
  auto place = [&](int v, int i) {
    if (__ballot_sync(0xffffffffu, v <= vmax) == 0) return;
    const unsigned peers = __match_any_sync(0xffffffffu, v);
    bool leader = false;
    if (v <= vmax) {
      const int pos = base[v] + mine[v] + __popc(peers & below);
      if (pos < t) {
        vq[pos] = v;
        iq[pos] = i;
      }
      leader = (peers & below) == 0;
    }
    __syncwarp();
    if (leader) mine[v] += __popc(peers);
    __syncwarp();
  };
#pragma unroll
  for (int c = 0; c < kCached; ++c)
    if (first + 32 * c < last) place(cached[c], first + 32 * c + lane);
  for (int i0 = first + 32 * kCached; i0 < last; i0 += 32)
    place(score(i0), i0 + lane);
}

template <int kW>
cudaError_t launch_distances(const uint32_t* codes, const uint32_t* qcodes,
                             int32_t* out, int nq, int s, int w, bool vec_codes,
                             bool vec_out, cudaStream_t stream) {
  const dim3 grid(nq, (s + kChunk - 1) / kChunk);
  hamming_kernel<kW><<<grid, kThreads, 0, stream>>>(codes, qcodes, out, s, w,
                                                   vec_codes, vec_out);
  return cudaGetLastError();
}

template <int kW>
cudaError_t launch_topk(const uint32_t* codes, const uint32_t* qcodes,
                        int32_t* vals, int32_t* idx, int nq, int s, int w,
                        int t, cudaStream_t stream) {
  auto kernel = hamming_topk_kernel<kW>;
  const int smem = (kWarps + 1) * (32 * w + 1) * static_cast<int>(sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int run = ((s + 32 * kWarps - 1) / (32 * kWarps)) * 32;
  kernel<<<nq, kThreads, smem, stream>>>(codes, qcodes, vals, idx, s, w, t,
                                         run);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pageann_hamming(const uint32_t* codes, const uint32_t* qcodes,
                               int32_t* out, int nq, int s, int w, void* stream) {
  if (nq == 0 || s == 0) return 0;
  if (w < 1 || (s + kChunk - 1) / kChunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_codes = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0 && s % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      w == 2 ? launch_distances<2>(codes, qcodes, out, nq, s, w, vec_codes, vec_out, st)
             : launch_distances<0>(codes, qcodes, out, nq, s, w, vec_codes, vec_out, st);
  return static_cast<int>(err);
}

// vals, idx: (nq, t) with 1 <= t <= s; shared memory (8 + 1) (32 w + 1)
// ints a block (a W whose counts do not fit gets cudaFuncSetAttribute's
// error).
extern "C" int pageann_hamming_topk(const uint32_t* codes,
                                    const uint32_t* qcodes, int32_t* vals,
                                    int32_t* idx, int nq, int s, int w, int t,
                                    void* stream) {
  if (nq == 0) return 0;
  if (w < 1 || t < 1 || t > s) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      w == 2 ? launch_topk<2>(codes, qcodes, vals, idx, nq, s, w, t, st)
             : launch_topk<0>(codes, qcodes, vals, idx, nq, s, w, t, st);
  return static_cast<int>(err);
}
