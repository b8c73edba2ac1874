// The per-point preparation of a float32 Kirchhoff call, in two launches:
// the recentring centre, then every destination's and source's keys
// written where B1 (csrc/kirchhoff_recentred.cu) or B2
// (csrc/kirchhoff_ddphase.cu) reads them.  Dispatched by ops/kirchhoff.py
// kirchhoff_integral_kernel when nothing is to be differentiated; the
// plain version beside it is ops/kirchhoff.py _kernel_inputs with
// forward_sources, which a call with gradients still takes.
//
// It replaces no TPU kernel: the reference package's preparation
// (xrt_tpu/ops/kirchhoff.py recentre_kirchhoff_inputs) is plain array code
// that its compiler fuses.  In PyTorch the same preparation is ~900
// element-wise launches a call, each one double-float step over all the
// points: a SoftiMAX chain run makes 108 such calls.
//
// Bound: launch latency.  A 4e4 x 2e4 tile pair reads ~1.3 MB (positions,
// fields, k, normals, weights) and writes ~3.6 MB (D and the source rows):
// ~1.5 us at 3.35 TB/s, and ~300 float operations a point, ~1 us.  So the
// design is two launches and nothing else:
//  * prep_centre (recentred variants only): every thread sums its strided
//    share of the six coordinate columns in double, a block adds its
//    threads' sums in a fixed tree, and the last block to finish (a ticket
//    counter, reset by that block) adds the blocks' partials in block order
//    and computes the call's scalars (kirchhoff_prep.cuh centre) into a
//    small device buffer whose first ten floats are B1's P.  The grid
//    depends on the sizes only, so the same inputs give the same bits, and
//    no value travels to the host.
//  * prep_points: one thread a point (destinations, then the sources padded
//    to ns_pad), the keys in registers, a destination's column of D and a
//    source's whole row stored as 16-byte vectors, zeros past the last
//    source and key.
// The kernels' names hold neither forward_kernel nor reduce_kernel and sit
// outside the namespace xfwd: the benchmark's readers of B1 and B2 match
// those.
//
// FMA policy: --fmad=false (see dd.cuh); nothing here is fused but
// two_prod's error term.
#include <cuda_runtime.h>

#include "kirchhoff_prep.cuh"

namespace xkp {

__global__ void __launch_bounds__(BLOCK)
    prep_centre(Inputs in, long long nd, long long ns, int variant,
                double* part, unsigned* ticket, float* cen) {
  __shared__ double sh[6][BLOCK];
  __shared__ bool last;
  const int t = threadIdx.x;
  double acc[6];
  centre_sums(in, nd, ns, static_cast<long long>(blockIdx.x) * BLOCK + t,
              static_cast<long long>(gridDim.x) * BLOCK, acc);
  for (int q = 0; q < 6; ++q) sh[q][t] = acc[q];
  __syncthreads();
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int q = 0; q < 6; ++q) sh[q][t] += sh[q][t + s];
    __syncthreads();
  }
  if (t < 6) {
    part[blockIdx.x * 6 + t] = sh[t][0];
    __threadfence();
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  if (t < 6) {
    double sum = 0.0;
    for (unsigned b = 0; b < gridDim.x; ++b) sum += __ldcg(&part[b * 6 + t]);
    sh[t][0] = sum;
  }
  __syncthreads();
  if (t == 0) {
    float mean[6];
    for (int q = 0; q < 6; ++q) mean[q] = mean_of(sh[q][0], q < 3 ? nd : ns);
    centre(mean, at(in, KH, 0), at(in, KL, 0), variant, cen);
    *ticket = 0u;
  }
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
    prep_points(Inputs in, long long nd, long long ns, long long ns_pad,
                const float* cen, float* D, float* rows) {
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK +
                      threadIdx.x;
  if (i < nd) {
    float d[ndk(V)];
    dst_keys<V>(in, cen, i, d);
    for (int q = 0; q < ndk(V); ++q) D[q * nd + i] = d[q];
    return;
  }
  const long long j = i - nd;
  if (j >= ns_pad) return;
  float s[width(V)];
  if (j < ns) {
    src_keys<V>(in, cen, j, s);
  } else {
    for (int q = 0; q < width(V); ++q) s[q] = 0.0f;
  }
  float4* row = reinterpret_cast<float4*>(rows + j * width(V));
  for (int q = 0; q < width(V) / 4; ++q)
    row[q] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
}

template <int V>
int launch_points(const Inputs& in, long long nd, long long ns,
                  long long ns_pad, const float* cen, float* D, float* rows,
                  cudaStream_t s) {
  const long long blocks = (nd + ns_pad + BLOCK - 1) / BLOCK;
  prep_points<V><<<static_cast<unsigned>(blocks), BLOCK, 0, s>>>(
      in, nd, ns, ns_pad, cen, D, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xkp

using namespace xkp;

// The preparation of one call.  variant: 0 mono, 1 narrowband, 2 poly
// (recentred), 3 'fast', 4 'exact' (per-pair double-float).  ptrs and
// strides: the NIN inputs of kirchhoff_prep.cuh (In order; a null pointer
// reads as zero, a stride in floats).  D: (ndk, nd) f32; rows: (ns_pad,
// width) f32, ns_pad >= ns a multiple of 4; for the recentred variants cen:
// NCEN f32 (its first ten are P), part: 6 x MAX_BLOCKS f64 of scratch and
// ticket: one unsigned, zero before the call and left zero after it (one
// call at a time on it); all null for the per-pair variants.  Returns the
// first launch error.
extern "C" int kirchhoff_prep_launch(int variant, const void* const* ptrs,
                                     const long long* strides, long long nd,
                                     long long ns, long long ns_pad, void* D,
                                     void* rows, void* cen, void* part,
                                     void* ticket, void* stream) {
  if (nd <= 0 || ns <= 0 || ns_pad < ns || ns_pad % 4 || variant < MONO ||
      variant > EXACT || (nd + ns_pad) / BLOCK >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Inputs in;
  for (int k = 0; k < NIN; ++k) {
    in.p[k] = static_cast<const float*>(ptrs[k]);
    in.s[k] = strides[k];
  }
  float* c = static_cast<float*>(cen);
  if (variant <= POLY) {
    const long long blocks = centre_blocks(nd, ns);
    prep_centre<<<static_cast<unsigned>(blocks), BLOCK, 0, s>>>(
        in, nd, ns, variant, static_cast<double*>(part),
        static_cast<unsigned*>(ticket), c);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  float* d = static_cast<float*>(D);
  float* r = static_cast<float*>(rows);
  switch (variant) {
    case MONO: return launch_points<MONO>(in, nd, ns, ns_pad, c, d, r, s);
    case NARROWBAND:
      return launch_points<NARROWBAND>(in, nd, ns, ns_pad, c, d, r, s);
    case POLY: return launch_points<POLY>(in, nd, ns, ns_pad, c, d, r, s);
    case FAST: return launch_points<FAST>(in, nd, ns, ns_pad, c, d, r, s);
    default: return launch_points<EXACT>(in, nd, ns, ns_pad, c, d, r, s);
  }
}
