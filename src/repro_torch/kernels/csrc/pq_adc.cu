// PQ asymmetric distance (ADC) for a batch of queries.
//
// Replaces: src/repro/kernels/pq_adc.py, pq_adc (the Pallas kernel
// _adc_kernel).
//
// Shapes (row-major, contiguous):
//   codes (Q, N, M) u8   PQ codes to score against query q
//   lut   (Q, M, K) f32  query q's table of squared sub-distances
//   out   (Q, N) f32     out[q, n] = sum over j of lut[q, j, codes[q, n, j]]
//
// Bound on the H100: bytes. One add per code byte; the least time is the
// codes, the tables and the output over 3.35 TB/s.
//
// Design: the TPU kernel built a one-hot (N, M*K) mask and contracted it on
// the matrix unit, because the TPU gathers badly. A GPU gathers from shared
// memory at full speed, so each block stages its query's (M, K) table in
// shared memory and one thread per code row sums its M lookups. Blocks walk
// the (query, chunk of rows) pairs in one flat grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) pq_adc_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ lut,
    float* __restrict__ out, int n, int m, int k, int chunks) {
  extern __shared__ float lut_s[];
  const int qi = blockIdx.x / chunks;
  const int i = (blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  const float* l = lut + static_cast<size_t>(qi) * m * k;
  for (int t = threadIdx.x; t < m * k; t += blockDim.x) lut_s[t] = l[t];
  __syncthreads();
  if (i >= n) return;
  const uint8_t* c = codes + (static_cast<size_t>(qi) * n + i) * m;
  float acc = 0.f;
  for (int j = 0; j < m; ++j) acc += lut_s[j * k + min(static_cast<int>(c[j]), k - 1)];
  out[static_cast<size_t>(qi) * n + i] = acc;
}

}  // namespace

extern "C" int pageann_pq_adc(const uint8_t* codes, const float* lut, float* out,
                              int nq, int n, int m, int k, void* stream) {
  if (nq == 0 || n == 0) return 0;
  const size_t smem = static_cast<size_t>(m) * k * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = (n + kThreads - 1) / kThreads;
  pq_adc_kernel<<<nq * chunks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      codes, lut, out, n, m, k, chunks);
  return static_cast<int>(cudaGetLastError());
}
