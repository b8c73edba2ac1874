// The physics at the surface of the toroid crystals in two launches:
// OE._interact for a thick Bragg-reflecting CrystalFcc / CrystalDiamond on a
// JohannToroid, JohanssonToroid, GeneralBraggToroid, DicedJohannToroid or
// DicedJohanssonToroid (oes/crystal_interact.py decides which calls come
// here; crystal_interact.cuh has the per-ray arithmetic).  It replaces no
// TPU kernel: the reference package's _interact is plain array code that
// its compiler fuses; in PyTorch the same step is ~385 element-wise
// launches a reflect over all rays, each reading and writing 40-240 MB at
// 1e7 rays, and the caching allocator's new segments between them.
//
// Bound: FP64 issue.  A ray reads x, y, a, b, c, E, Jss, Jpp, Jsp, theta
// and its state (45 B in float32) and writes a, b, c, theta, Jss, Jpp, Jsp
// and rollAngle (36 B); launch A reads x, y, a, b, c once more (20 B):
// ~1.0 GB at 1e7 float32 rays, 0.30 ms at 3.35 TB/s.  The arithmetic of a
// good ray is ~1,300 double operations (~35 divisions and ~20 square roots
// and hypotenuses, each a short FMA sequence of the math library; acos,
// atan2, asin, cos, sin; the normals, the grating vector, the complex
// square root and two complex divisions a polarization), ~0.7 ms at 1e7
// rays on 132 SMs x 64 FP64 lanes (an estimate: 1.65 ms measured for
// launch B on an H100).  So every intermediate stays in registers (no
// temporaries, no host read), and the launches are
//  * incidence_sum: the sum over all rays, dead ones too, of
//    clamp(dot(k, n_bragg), -1, 1) in double, in a fixed order (strided per
//    thread, then grid_sum.cuh: a tree per block, the blocks' partials in
//    block order by the last block through a ticket that it resets), into
//    a device scalar:
//    the sign of torch.mean(beamInDotNormal) < 0, the grating vector's, with
//    a NaN sum taking the else branch as torch.where does;
//  * interact_rays: one thread a ray, every step of the PyTorch path in
//    double, the outputs selected by the ray's state and rounded to the
//    rays' dtype once.  A ray that is not good computes its normals and
//    rollAngle only.
// No value travels to the host.  The kernels' names hold neither
// forward_kernel nor reduce_kernel and sit outside the namespace xfwd: the
// benchmark's readers of B1 and B2 match those.
#include "crystal_interact.cuh"
#include "grid_sum.cuh"

namespace xci {

constexpr int BLOCK = 256;
// the most blocks of incidence_sum (its partials buffer holds this many
// doubles; oes/crystal_interact.py SUM_BLOCKS)
constexpr int SUM_BLOCKS = 1024;

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    incidence_sum(Params<T> p, Rays<T> r, double* part, unsigned* ticket,
                  double* sum) {
  __shared__ double sh[1][BLOCK];
  double acc[1] = {0.0};
  const long long stride = static_cast<long long>(gridDim.x) * BLOCK;
  for (long long i = static_cast<long long>(blockIdx.x) * BLOCK +
                     threadIdx.x;
       i < r.n; i += stride)
    acc[0] += incidence_at(p, r, i);
  if (xgs::grid_sums<1, BLOCK>(sh, acc, part, ticket) && threadIdx.x == 0)
    *sum = sh[0][0];
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    interact_rays(Params<T> p, Rays<T> r, const double* sum) {
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK +
                      threadIdx.x;
  if (i < r.n) interact_at(p, r, i, *sum);
}

template <typename T>
int launch(const double* num, const int* ints, const void* const* tab,
           long long n, const void* const* in, const void* good,
           void* const* out, double* scratch, cudaStream_t s) {
  const Params<T> p = make_params<T>(num, ints, tab);
  const Rays<T> r = make_rays<T>(in, good, out, n);
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  const unsigned sblocks = static_cast<unsigned>(
      blocks < SUM_BLOCKS ? blocks : SUM_BLOCKS);
  double* sum = scratch + SUM_BLOCKS;
  incidence_sum<T><<<sblocks, BLOCK, 0, s>>>(
      p, r, scratch, reinterpret_cast<unsigned*>(scratch + SUM_BLOCKS + 1),
      sum);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  interact_rays<T><<<static_cast<unsigned>(blocks), BLOCK, 0, s>>>(p, r,
                                                                    sum);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xci

using namespace xci;

// OE._interact of n rays.  num: NNUM doubles and ints: NINT ints
// (crystal_interact.cuh Num, Int), both host arrays; tab: the element's E,
// f1 and f2 tables, ints[NTAB] doubles each on the card.  in: x, y, a, b,
// c, E, Jss, Jpp, Jsp (interleaved complex), theta (null: zeros), (n,) of
// float (is_double 0) or double (1); good: (n,) bool, state == 1.  out: a,
// b, c, theta, Jss, Jpp, Jsp (interleaved), rollAngle, of the same dtype.
// scratch: SUM_BLOCKS + 2 doubles on the card, the last one's first four
// bytes a ticket that is zero before the call and left zero after it (one
// call at a time on it); the incidences' sum is written to
// scratch[SUM_BLOCKS].  Returns the first launch error.
extern "C" int crystal_interact_launch(int is_double, const double* num,
                                       const int* ints,
                                       const void* const* tab, long long n,
                                       const void* const* in,
                                       const void* good, void* const* out,
                                       void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL * BLOCK || ints[NTAB] < 1 || ints[CENTER] < JOHANN ||
      ints[CENTER] > GENERAL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* sc = static_cast<double*>(scratch);
  if (is_double)
    return launch<double>(num, ints, tab, n, in, good, out, sc, s);
  return launch<float>(num, ints, tab, n, in, good, out, sc, s);
}
