// The per-member squared L2 that every member score of the port's kernels
// is summed with: page_scan.cu (all eight variants) and page_gather.cu
// include it, so one piece of code fixes the order of the sum and the
// kernels agree bit for bit on the same vectors.
//
// The order: lane l of a warp takes the member's columns l, l + 32, l + 64,
// ... in ascending order with fmaf from 0, then the warp adds its 32
// partial sums by an xor-shuffle tree, offsets 16 down to 1, own value
// first (warp_sum). warp_sums runs that tree on several members at once and
// gives each the same bits.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Adds the squared differences of kG members in kJ of their columns
// (c + 32 j; c starts at the lane) to acc; every load, the query's
// included, is issued before the first FMA. Only the first n members of
// the group exist. The first one starts at float row + col * dim of the
// record (row: a member row's first float, col: the slot within it), and a
// member row holds vpr members, row_floats floats apart. The unpacked
// (P, cap, d) pages of page_gather.cu are the case vpr = 1, row_floats = d.
template <int kJ, int kG, bool kFirst>
__device__ __forceinline__ void member_slab(float (&acc)[kG],
                                            const float* rec, int row,
                                            int col, int row_floats, int vpr,
                                            int n, const float* qv, int c,
                                            int dim) {
  float qr[kJ], x[kG][kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    qr[j] = c + 32 * j < dim ? __ldg(qv + c + 32 * j) : 0.f;
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    const float* v = rec + row + col * dim + c;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      x[i][j] = i < n && c + 32 * j < dim ? __ldg(v + 32 * j) : 0.f;
    if (++col == vpr) {
      col = 0;
      row += row_floats;
    }
  }
  // past the member's last column both terms are 0, and fmaf(0, 0, acc)
  // is acc: the same sum as a loop that stops at dim
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    float a = kFirst ? 0.f : acc[i];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float t = x[i][j] - qr[j];
      a = fmaf(t, t, a);
    }
    acc[i] = a;
  }
}

// Halves the kG values of every lane in one step of warp_sum's xor tree
// (offset 32 kN / kG): a lane keeps the half whose index bit is its own
// lane bit and adds the partner lane's copy of it, own value first, as
// warp_sum does.
template <int kN, int kG>
__device__ __forceinline__ void halve(float (&a)[kG], int lane) {
  constexpr int kOff = 32 * kN / kG;
  const bool hi = lane & kOff;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float keep = hi ? a[i + kN] : a[i];
    const float send = hi ? a[i] : a[i + kN];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
  if constexpr (kN > 1) halve<kN / 2, kG>(a, lane);
}

// warp_sum of each of kG values, the same tree and the same bits: the
// first log2(kG) steps halve the values, the rest add one. Value i ends in
// lanes i * 32 / kG .. (i + 1) * 32 / kG - 1.
template <int kG>
__device__ __forceinline__ float warp_sums(float (&a)[kG], int lane) {
  if constexpr (kG > 1) halve<kG / 2, kG>(a, lane);
  float v = a[0];
#pragma unroll
  for (int off = 16 / kG; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
