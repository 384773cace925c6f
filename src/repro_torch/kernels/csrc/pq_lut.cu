// ADC lookup tables for a batch of queries: each query's squared distance
// to every centroid of every PQ subspace.
//
// Replaces no Pallas kernel: the reference builds the tables in plain jnp
// (src/repro/core/pq.py, pq_lut), which XLA fuses into one pass. Added
// because the same formula in PyTorch, ((q - c) ** 2).sum(-1), writes the
// (Q, M, K, dsub) difference and its square to device memory (1.3 GB each
// at Q = 10,000, d = 128) and reads the square back: three passes of 55-70x
// the tables' own bytes, and the search's device-memory peak.
//
// Shapes (row-major, contiguous):
//   q      (Q, d) f32        queries, d = M * dsub
//   books  (M, K, dsub) f32  codebooks
//   out    (Q, M, K) f32     out[q, m, k] = the sum over j = 0 .. dsub-1, in
//                            that order, of (q[q, m * dsub + j] - books[m, k, j])^2
//
// Arithmetic: the difference, its square and the running sum each rounded
// to float32 (__fsub_rn, __fmul_rn, __fadd_rn: no fused multiply-add, no
// |q|^2 - 2 q.c + |c|^2 expansion, no TF32): a serial float32 evaluation of
// the plain formula's terms, bit for bit.
//
// Bound on the H100: bytes. Q M K x 4 bytes are written against 3 Q K d
// operations: at Q = 10,000 the benchmark's two tables a batch are 0.49 GB
// (0.147 ms at 3.35 TB/s) and 2.0-2.9 GFLOP (0.03-0.04 ms at 67 TFLOP/s).
//
// Design: full-width coalesced stores, and nothing written but the tables.
// A block takes one subspace m and a tile of queries. Each thread owns four
// consecutive k, the same four for every query of the tile, and stores them
// as one float4 a query where K % 4 == 0: a row's ceil(K / 4) threads lie
// side by side, so a warp writes 512 contiguous bytes of one (query, m) row.
// The block covers `rows` queries at once and loops `passes` times, so a
// thread keeps passes x 4 sums in registers. The subspace's codebook is
// staged in shared memory transposed to (dsub, K), so a thread reads its
// four centroids' coordinate j as one 16-byte load; the tile's query slices
// lie beside it and are read as broadcasts. dsub is walked in chunks that
// fit the plan's shared memory (one chunk at the cells' dsub of 4-12, two
// or four at d = 2048), the sums carried in registers from chunk to chunk,
// so the order stays j = 0 .. dsub-1. What a block pays once, its staging
// and barrier, costs about as much as its passes: on the H100, 2 or 4
// passes a block ran 1.3-2x slower than 8 at 10,000 queries. So a block
// takes 8 passes (32 queries) wherever that leaves two blocks an SM. The
// launch plan (kernels/pq_lut.py) picks rows, passes and the chunk from
// (Q, M, K, dsub).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxPasses = 8;  // queries a thread sums (8 x 4 floats)

__device__ __forceinline__ float add_sq(float acc, float x, float c) {
  const float t = __fsub_rn(x, c);
  return __fadd_rn(acc, __fmul_rn(t, t));
}

__global__ void __launch_bounds__(kMaxThreads) pq_lut_kernel(
    const float* __restrict__ q, const float* __restrict__ books,
    float* __restrict__ out, int nq, int m, int k, int dsub, int rows,
    int passes, int chunk, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int k4n = (k + 3) / 4;
  const int kp = 4 * k4n;          // a staged coordinate: K padded to float4s
  const int tile = rows * passes;  // queries a block
  float* c_s = smem;               // (chunk, kp) centroids, transposed
  float* q_s = smem + chunk * kp;  // (tile, chunk) the queries' coordinates
  const int sub = blockIdx.x % m;
  const int q0 = (blockIdx.x / m) * tile;
  const int d = m * dsub;
  const int row = threadIdx.x / k4n;  // the thread's query in each pass
  const int k0 = 4 * (threadIdx.x % k4n);
  const float* book = books + static_cast<size_t>(sub) * k * dsub;

  float acc[kMaxPasses][4];
#pragma unroll
  for (int i = 0; i < kMaxPasses; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j0 = 0; j0 < dsub; j0 += chunk) {
    const int dc = min(chunk, dsub - j0);
    if (j0 > 0) __syncthreads();  // every read of the last chunk is done
    // a thread stages centroid kk's dc coordinates, four loads in flight
    for (int kk = threadIdx.x; kk < kp; kk += blockDim.x) {
      const float* src = book + static_cast<size_t>(kk) * dsub + j0;
#pragma unroll 4
      for (int j = 0; j < dc; ++j)
        c_s[j * kp + kk] = kk < k ? __ldg(src + j) : 0.f;
    }
    for (int t = threadIdx.x; t < tile * dc; t += blockDim.x) {
      const int r = t / dc, j = t - r * dc;
      const int qi = q0 + r;
      q_s[t] = qi < nq
                   ? __ldg(q + static_cast<size_t>(qi) * d + sub * dsub + j0 + j)
                   : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < dc; ++j) {
      const float4 c = *reinterpret_cast<const float4*>(c_s + j * kp + k0);
#pragma unroll
      for (int i = 0; i < kMaxPasses; ++i) {
        if (i < passes) {
          const float x = q_s[(i * rows + row) * dc + j];
          acc[i][0] = add_sq(acc[i][0], x, c.x);
          acc[i][1] = add_sq(acc[i][1], x, c.y);
          acc[i][2] = add_sq(acc[i][2], x, c.z);
          acc[i][3] = add_sq(acc[i][3], x, c.w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxPasses; ++i) {
    const int qi = q0 + i * rows + row;
    if (i >= passes || qi >= nq) continue;
    float* o = out + (static_cast<size_t>(qi) * m + sub) * k + k0;
    if (vec) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (k0 + x < k) o[x] = acc[i][x];
    }
  }
}

}  // namespace

// rows, passes, chunk and threads from the launch plan (threads = rows x
// ceil(K / 4)); the grid is M x ceil(Q / (rows x passes)) blocks
extern "C" int pageann_pq_lut(const float* q, const float* books, float* out,
                              int nq, int m, int k, int dsub, int rows,
                              int passes, int chunk, int threads,
                              void* stream) {
  if (nq == 0 || m == 0 || k == 0) return 0;
  const int k4n = (k + 3) / 4;
  if (dsub < 1 || rows < 1 || passes < 1 || passes > kMaxPasses ||
      chunk < 1 || threads != rows * k4n || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = rows * passes;
  const long long grid = static_cast<long long>(m) * ((nq + tile - 1) / tile);
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(chunk) * (4 * k4n + tile);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  pq_lut_kernel<<<static_cast<unsigned>(grid), threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      q, books, out, nq, m, k, dsub, rows, passes, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}
