// Batched squared L2 distance between two sets of vectors, in the expanded
// form |q|^2 - 2 q.x + |x|^2, with an optional keep mask over the vectors.
//
// Replaces: src/repro/kernels/l2dist.py, l2_distance (the Pallas kernel
// _l2_kernel).
//
// Shapes (row-major, contiguous):
//   q    (Q, d) f32   queries
//   x    (N, d) f32   vectors (the mutable index's delta tier)
//   keep (N,) bool    or null; out is +inf in the columns where it is false
//                     (the delta scan's live & filter mask)
//   out  (Q, N) f32   out[i, j] = (|q_i|^2 - 2 q_i.x_j) + |x_j|^2
//
// Bound on the H100: operations once Q and N are in the hundreds. The product
// does 2 Q N d flops against 4 (Q d + N d + Q N) bytes; at d = 128 that is
// ~64 flops a byte of output, above the card's float32 balance (67 TFLOP/s
// over 3.35 TB/s = 20). The least time is 2 Q N d over 67 TFLOP/s.
//
// Design: the TPU kernel handed the q.x product of a (128, d) x (d, 128) tile
// to the matrix unit and kept d whole in VMEM. Here the product stays in full
// float32 on the CUDA cores (TF32 tensor cores keep ~3 decimal digits, and the
// port is held to the reference at 1e-5): a register-blocked SIMT product.
// A block of 256 threads owns a 128 x 64 output tile and walks d in slabs
// of kBK = 16. Each slab of its 128 query rows and 64 vector rows is copied
// into shared memory by 16-byte cp.async (4-byte where d % 4 != 0), three
// slabs in flight: the copy of slab s + 2 overlaps the FMAs on slab s,
// behind one barrier a slab. The rows keep their k order in shared memory,
// padded to 20 floats so that the float4 reads below hit 8 distinct 16-byte
// bank groups. Thread (ty, tx) holds 8 x 4 accumulators, rows ty + 16 i and
// columns tx + 16 j; per 4 k and each half of its 8 query rows it reads
// those 4 rows and its vector rows as float4 (a warp spans 4 query rows and
// 8 vector rows, so no two lanes' reads share a bank unless they share the
// address) and does 16 FMAs per vector row; reading all 8 query rows at once
// kept 16 more registers live and ran about 10% slower on the H100. Thread
// t < 192 also sums the squares of staged row t (one of the 128 + 64 rows)
// from the same slabs, so the norms cost no read of device memory.
//
// The sum. Every output and norm is a sum of chunks of kChunk = 128 k: one
// fmaf chain from 0 over the chunk's k in order (zero padding past d adds
// exact zeros), each chunk then added to the running total in chunk order,
// and the epilogue is (qq - 2 qx) + xx. So the bits do not depend on the
// tile shape, a self-match scores exactly 0, and up to d = 128 the result
// is the single chain's. One chain over all of d = 2048 (the LM's width)
// put the expanded form 0.0178 off the plain version's on 1,000 x 1,024
// vectors on the H100, past its 1e-6 (max|q|^2 + max|x|^2) = 0.0048; the
// chunked sum stays inside it (tests/test_torch_cuda.py, d = 2048). The
// totals cost 32 more registers a thread, which a 128 x 128 tile (8 x 8
// accumulators) has no room for. Edge tiles are zero-filled on the copy
// and not stored, so any Q, N and d work without host padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // query rows per block
constexpr int kBN = 64;       // vector rows (output columns) per block
constexpr int kBK = 16;       // d per slab
constexpr int kLd = kBK + 4;  // floats per staged row: 80 bytes
constexpr int kStages = 3;    // slabs in shared memory at once
constexpr int kThreads = 256; // 16 x 16 threads
constexpr int kTM = 8;        // query rows per thread
constexpr int kTN = kBN / 16; // vector rows per thread
constexpr int kRows = kBM + kBN;  // staged rows a slab: queries, vectors
constexpr int kChunkSlabs = 8;    // slabs a chunk of the sum: kChunk = 128 k
constexpr size_t kSmemBytes = size_t{kStages} * kRows * kLd * sizeof(float);
static_assert(kRows <= kThreads, "thread t sums the squares of staged row t");
static_assert(kRows * kBK % (4 * kThreads) == 0, "whole rounds of copies");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies of ``src_bytes`` (0 or the full size) bytes; the rest of the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// kVec: rows are 16-byte aligned (d % 4 == 0, aligned bases), so the slabs
// go by 16-byte copies
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) l2_distance_kernel(
    const float* __restrict__ q, const float* __restrict__ x,
    const uint8_t* __restrict__ keep, float* __restrict__ out, int nq, int nx,
    int d) {
  extern __shared__ __align__(16) float slab_s[];  // [kStages][kRows][kLd]
  __shared__ float norm_s[kRows];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // warps 4 (query rows) x 2 (vector rows); a warp's lanes 4 x 8
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  auto load_slab = [&](int buf, int k0) {
    float* st = slab_s + buf * kRows * kLd;
    if (kVec) {
#pragma unroll
      for (int u = 0; u < kRows * (kBK / 4) / kThreads; ++u) {
        const int c = t + u * kThreads;
        const int r = c / (kBK / 4);
        const int kc = (c % (kBK / 4)) * 4;
        const int gk = k0 + kc;
        const float* src = q;
        bool ok;
        if (r < kBM) {
          ok = row0 + r < nq && gk < d;
          if (ok) src = q + static_cast<size_t>(row0 + r) * d + gk;
        } else {
          ok = col0 + r - kBM < nx && gk < d;
          if (ok) src = x + static_cast<size_t>(col0 + r - kBM) * d + gk;
        }
        cp_async16(smem_u32(st + r * kLd + kc), src, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < kRows * kBK / kThreads; ++u) {
        const int e = t + u * kThreads;
        const int r = e / kBK;
        const int kc = e % kBK;
        const int gk = k0 + kc;
        const float* src = q;
        bool ok;
        if (r < kBM) {
          ok = row0 + r < nq && gk < d;
          if (ok) src = q + static_cast<size_t>(row0 + r) * d + gk;
        } else {
          ok = col0 + r - kBM < nx && gk < d;
          if (ok) src = x + static_cast<size_t>(col0 + r - kBM) * d + gk;
        }
        cp_async4(smem_u32(st + r * kLd + kc), src, ok ? 4 : 0);
      }
    }
  };

  // acc: the current chunk's chains; tot: the finished chunks' sum
  float acc[kTM][kTN], tot[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = tot[i][j] = 0.f;
  float norm = 0.f, norm_tot = 0.f;  // the squared norm of staged row t
  // adds the chunk to the totals, in chunk order, and starts the next one
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        tot[i][j] += acc[i][j];
        acc[i][j] = 0.f;
      }
    norm_tot += norm;
    norm = 0.f;
  };

  const int slabs = (d + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) load_slab(s, s * kBK);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slab s landed
    __syncthreads();  // everyone's landed; slab s - 1 is no longer read
    const int next = s + kStages - 1;
    if (next < slabs) load_slab(next % kStages, next * kBK);
    cp_async_commit();

    const float* st = slab_s + (s % kStages) * kRows * kLd;
    // every thread passes (kRows == kThreads), but the branch keeps these
    // loads out of the product's schedule: without it ptxas spilled 76
    // bytes and the kernel ran ~12% slower on the H100
    if (t < kRows) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 4) {
        const float4 v = lds4(st + t * kLd + kk);
        norm = fmaf(v.x, v.x, norm);
        norm = fmaf(v.y, v.y, norm);
        norm = fmaf(v.z, v.z, norm);
        norm = fmaf(v.w, v.w, norm);
      }
    }
    const float* qs = st + ty * kLd;
    const float* xs = st + (kBM + tx) * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      // the thread's query rows in two halves of 4: 16 registers of
      // operands live instead of 32
#pragma unroll
      for (int h = 0; h < kTM; h += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = lds4(qs + 16 * (h + i) * kLd + kk);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const float4 b = lds4(xs + 16 * j * kLd + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& c = acc[h + i][j];
            c = fmaf(a[i].x, b.x, c);
            c = fmaf(a[i].y, b.y, c);
            c = fmaf(a[i].z, b.z, c);
            c = fmaf(a[i].w, b.w, c);
          }
        }
      }
    }
    if ((s + 1) % kChunkSlabs == 0 || s + 1 == slabs) fold();
  }
  cp_async_wait<0>();
  if (t < kRows) norm_s[t] = norm_tot;
  __syncthreads();

  const float kInf = __int_as_float(0x7f800000);  // +inf
  float xn[kTN];
  bool kept[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int c = col0 + tx + 16 * j;
    xn[j] = norm_s[kBM + tx + 16 * j];
    kept[j] = keep == nullptr || (c < nx && keep[c] != 0);
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= nq) continue;
    const float qq = norm_s[ty + 16 * i];
    float* o = out + static_cast<size_t>(r) * nx;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + 16 * j;
      // (qq - 2 qx) + xx, the reference's order; 2 qx is exact
      if (c < nx) o[c] = kept[j] ? (qq - 2.f * tot[i][j]) + xn[j] : kInf;
    }
  }
}

template <bool kVec>
int launch(const float* q, const float* x, const uint8_t* keep, float* out,
           int nq, int nx, int d, cudaStream_t stream) {
  auto kernel = l2_distance_kernel<kVec>;
  // the slabs take more than the 48 KB a block gets without opting in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nx + kBN - 1) / kBN, (nq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(q, x, keep, out, nq, nx, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pageann_l2_distance(const float* q, const float* x,
                                   const uint8_t* keep, float* out, int nq,
                                   int nx, int d, void* stream) {
  if (nq == 0 || nx == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? launch<true>(q, x, keep, out, nq, nx, d, s)
             : launch<false>(q, x, keep, out, nq, nx, d, s);
}

// blocks of the 16-byte-copy kernel one SM holds at once
extern "C" int pageann_l2_distance_blocks_per_sm(int* blocks) {
  auto kernel = l2_distance_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, kSmemBytes));
}
