// XOR + popcount Hamming sweep for the LSH router, for a batch of queries.
//
// Replaces: src/repro/kernels/hamming.py, hamming (the Pallas kernel
// _hamming_kernel).
//
// Shapes (row-major, contiguous):
//   codes  (S, W) u32   sampled vectors' packed sign bits (int32 in torch)
//   qcodes (Q, W) u32   the queries' packed sign bits
//   out    (Q, S) i32   out[q, s] = popcount(codes[s] ^ qcodes[q])
//
// Bound on the H100: bytes. A few integer operations per 4-byte word; the
// least time is the codes and the output over 3.35 TB/s (the output
// dominates once Q is large).
//
// Design: the TPU kernel counted bits with a SWAR bit-twiddle on the vector
// unit; the GPU has a popcount instruction (__popc). One thread per (query,
// sample), adjacent threads on adjacent samples, so the output stores are
// coalesced and the query's W words stay in cache for the whole block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) hamming_kernel(
    const uint32_t* __restrict__ codes, const uint32_t* __restrict__ qcodes,
    int32_t* __restrict__ out, int s, int w, int chunks) {
  const int qi = blockIdx.x / chunks;
  const int i = (blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  if (i >= s) return;
  const uint32_t* c = codes + static_cast<size_t>(i) * w;
  const uint32_t* qc = qcodes + static_cast<size_t>(qi) * w;
  int acc = 0;
  for (int t = 0; t < w; ++t) acc += __popc(c[t] ^ qc[t]);
  out[static_cast<size_t>(qi) * s + i] = acc;
}

}  // namespace

extern "C" int pageann_hamming(const uint32_t* codes, const uint32_t* qcodes,
                               int32_t* out, int nq, int s, int w, void* stream) {
  if (nq == 0 || s == 0) return 0;
  const int chunks = (s + kThreads - 1) / kThreads;
  hamming_kernel<<<nq * chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, qcodes, out, s, w, chunks);
  return static_cast<int>(cudaGetLastError());
}
