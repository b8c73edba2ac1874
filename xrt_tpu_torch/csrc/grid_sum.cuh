// A fixed-order sum over a whole grid in one launch, with no host read:
// every thread brings K doubles, a block adds its threads' in a fixed tree
// in shared memory, and the last block to finish (a ticket counter, reset
// by that block) adds the blocks' partials in block order.  The grid
// depends on the sizes only, so the same inputs give the same bits.  Used
// by the preparation kernel's centre (kirchhoff_prep.cu) and the toroid
// crystals' incidence sum (crystal_interact.cu).
#pragma once

#include <cuda_runtime.h>

namespace xgs {

// Adds acc (K doubles of this thread) over the grid.  sh: K rows of BLOCK
// doubles of shared memory; part: K x gridDim.x doubles of scratch; ticket:
// zero before the launch, and left zero.  Returns true in the last block
// alone, whose sh[q][0] then hold the K sums (every thread of it returns
// after a barrier); the other blocks return false and must not touch sh.
template <int K, int BLOCK>
__device__ bool grid_sums(double (&sh)[K][BLOCK], const double (&acc)[K],
                          double* part, unsigned* ticket) {
  static_assert(K <= BLOCK, "one thread a sum");
  __shared__ bool last;
  const int t = threadIdx.x;
  for (int q = 0; q < K; ++q) sh[q][t] = acc[q];
  __syncthreads();
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int q = 0; q < K; ++q) sh[q][t] += sh[q][t + s];
    __syncthreads();
  }
  if (t < K) {
    part[blockIdx.x * K + t] = sh[t][0];
    __threadfence();
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return false;
  if (t < K) {
    double sum = 0.0;
    for (unsigned b = 0; b < gridDim.x; ++b) sum += __ldcg(&part[b * K + t]);
    sh[t][0] = sum;
  }
  if (t == 0) *ticket = 0u;
  __syncthreads();
  return true;
}

}  // namespace xgs
