// The undulator's radiation integral in one launch a build_I_map call:
// Undulator._integrate (sources/undulator.py) for every ray of a ray block,
// far field, tapered or near field (sources/undulator_integral.py decides
// which calls come here; undulator_integral.cuh has the arithmetic).  It
// replaces no TPU kernel: the reference package's integral is plain array
// code that its compiler fuses; in PyTorch the same loop is ~80 element-wise
// launches a step of 64 nodes, each writing and reading a (rays, 64)
// temporary: ~1150 launches and ~100 GB of traffic a shine of 4e5 rays at
// 804 nodes.
//
// Bound: instructions.  A ray reads 24 B (ww1, w, wu, gamma and two angles
// in float32) and writes 16 (Is, Ip): 16 MB at 4e5 rays, 5 us at 3.35
// TB/s.  The far-field formula needs 40 operations a (ray, node) (the
// count of beambench/metrics/und.integral_roofline.py), 0.19 ms at 3.2e8
// node evaluations and 67 TFLOP/s; without FMA contraction (--fmad=false),
// with the IEEE sincos, the division and the double sums, a node is ~150
// float32 instructions, ~1.5 ms at the card's issue rate.  So:
//  * one thread a ray, its terms in registers, no temporaries;
//  * the node table (8 rows of the nodes of nonzero weight) read by each
//    block in tiles of TILE nodes into shared memory, where a warp reads a
//    node as a broadcast; the Np copies of a tapered or near field are the
//    inner loop over a tile, adding the period's offset to tg;
//  * Bs and Bp in double registers: four double adds a node.
// The kernels' names hold neither forward_kernel, reduce_kernel nor
// kirchhoff_: the benchmark's readers of B1 and B2 match those.
#include "undulator_integral.cuh"

namespace xund {

constexpr int BLOCK = 128;
constexpr int TILE = BLOCK;

template <typename T, int MODE>
__global__ void __launch_bounds__(BLOCK)
    undulator_rays(Params<T> p, Rays<T> r) {
  __shared__ T sh[NROW][TILE];
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK +
                      threadIdx.x;
  const bool live = i < r.n;
  // a thread past the end computes the last ray and stores nothing
  const Ray<T> ray = ray_at<T, MODE>(p, r, live ? i : r.n - 1);
  Acc a{0.0, 0.0, 0.0, 0.0};
  for (int t0 = 0; t0 < p.nnodes; t0 += TILE) {
    const int m = p.nnodes - t0 < TILE ? p.nnodes - t0 : TILE;
    __syncthreads();
    if (threadIdx.x < m) {
#pragma unroll
      for (int k = 0; k < NROW; ++k)
        sh[k][threadIdx.x] = p.table[k * p.nnodes + t0 + threadIdx.x];
    }
    __syncthreads();
    tile_sum<T, MODE>(p, ray, &sh[0][0], TILE, m, a);
  }
  if (live) store(r, i, ray, a);
}

template <typename T>
int launch(const double* num, const int* ints, long long n,
           const void* const* in, const void* table, void* const* out,
           cudaStream_t s) {
  const Params<T> p = make_params<T>(num, ints, table);
  const Rays<T> r = make_rays<T>(in, out, n);
  const unsigned blocks = static_cast<unsigned>((n + BLOCK - 1) / BLOCK);
  if (p.mode == TAPER)
    undulator_rays<T, TAPER><<<blocks, BLOCK, 0, s>>>(p, r);
  else if (p.mode == NEAR)
    undulator_rays<T, NEAR><<<blocks, BLOCK, 0, s>>>(p, r);
  else
    undulator_rays<T, FAR><<<blocks, BLOCK, 0, s>>>(p, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xund

using namespace xund;

// Undulator._integrate of n rays.  num: NNUM doubles and ints: NINT ints
// (undulator_integral.cuh Num, Int), both host arrays; in: ww1, w, wu,
// gamma, ddphi, ddpsi, (n,) of float (is_double 0) or double (1) on the
// card; table: NROW x ints[NNODES] of the same dtype on the card; out: Is,
// Ip, (n,) interleaved complex of the same dtype.  Returns the launch
// error.
extern "C" int undulator_integral_launch(int is_double, const double* num,
                                         const int* ints, long long n,
                                         const void* const* in,
                                         const void* table, void* const* out,
                                         void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL * BLOCK || ints[NNODES] < 1 || ints[NCOPIES] < 1 ||
      ints[MODE] < FAR || ints[MODE] > NEAR)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) return launch<double>(num, ints, n, in, table, out, s);
  return launch<float>(num, ints, n, in, table, out, s);
}
