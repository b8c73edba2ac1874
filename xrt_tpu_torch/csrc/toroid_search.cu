// The intersection search on the toroid crystals, one ray a thread, in one
// launch: oes/base.find_intersection_dz as OE._reflect_local runs it on a
// JohannToroid, JohanssonToroid, GeneralBraggToroid, DicedJohannToroid or
// DicedJohanssonToroid (oes/toroid_search.py decides which calls come
// here).  It replaces no TPU kernel: the reference package's search is
// plain array code that its compiler fuses; in PyTorch the same search is
// ~120 element-wise launches a surface evaluation over all rays, ~17
// evaluations a call, and a host read of the active count an iteration.
//
// Bound: instructions.  A ray reads 33 bytes (x, y, z, a, b, c, tMin, tMax
// and its active flag) and writes 17 (t, the point, lost), 0.5 GB at 1e7
// float32 rays, 0.15 ms at 3.35 TB/s; ~17 surface evaluations of ~7
// square roots, ~12 divisions and ~40 other operations are ~7e10
// instructions, ~2 ms at the card's FP32 issue rate.  So the whole solve
// stays in registers (toroid_search.cuh: both bracket ends, the Illinois
// loop, the Newton steps), and a diced surface keeps the current facet's
// centre height and normal and recomputes them only when the facet
// changes.  There is no host read and no scratch memory.  While the
// program traces, each block adds its rays' iteration counts to three
// int64 counters (the largest, the sum, and 32 x each warp's largest, the
// lanes a warp runs): one atomic each a block.
#include "toroid_search.cuh"

namespace {

using namespace xts;

constexpr int BLOCK = 256;

template <typename T>
struct Args {
  Params<T> p;
  const T *x, *y, *z, *a, *b, *c, *tMin, *tMax;
  const bool* active;
  long long n;
  int newton;
  T *t, *xx, *yy, *zz;             // xx, yy, zz null: not written
  bool *lost, *good;               // good null: not written
  unsigned long long* counts;      // null: not counted
};

template <typename T>
__global__ void __launch_bounds__(BLOCK) search_kernel(Args<T> g) {
  const long long i = static_cast<long long>(blockIdx.x) * BLOCK +
                      threadIdx.x;
  unsigned it = 0;
  if (i < g.n) {
    const Ray<T> r{g.x[i], g.y[i], g.z[i], g.a[i], g.b[i], g.c[i]};
    const Result<T> res = search_ray(g.p, r, g.tMin[i], g.tMax[i],
                                     g.active[i], g.newton != 0);
    g.t[i] = res.t;
    if (g.xx != nullptr) {
      g.xx[i] = r.x + r.a * res.t;
      g.yy[i] = r.y + r.b * res.t;
      g.zz[i] = r.z + r.c * res.t;
    }
    g.lost[i] = res.flag == LOST;
    if (g.good != nullptr) g.good[i] = res.flag == GOOD;
    it = static_cast<unsigned>(res.iters);
  }
  if (g.counts == nullptr) return;  // uniform over the launch
  __shared__ unsigned sums[3];
  if (threadIdx.x < 3) sums[threadIdx.x] = 0;
  __syncthreads();
  const unsigned wmax = __reduce_max_sync(0xffffffffu, it);
  const unsigned wsum = __reduce_add_sync(0xffffffffu, it);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&sums[0], wmax);
    atomicAdd(&sums[1], wsum);
    atomicAdd(&sums[2], 32u * wmax);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicMax(&g.counts[0], static_cast<unsigned long long>(sums[0]));
    atomicAdd(&g.counts[1], static_cast<unsigned long long>(sums[1]));
    atomicAdd(&g.counts[2], static_cast<unsigned long long>(sums[2]));
  }
}

template <typename T>
int launch(const Params<T>& p, const void* const* in, const void* active,
           long long n, int newton, void* const* out, void* lost, void* good,
           void* counts, cudaStream_t s) {
  const T* const* r = reinterpret_cast<const T* const*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
  Args<T> g{p, r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7],
            static_cast<const bool*>(active), n, newton, o[0], o[1], o[2],
            o[3], static_cast<bool*>(lost), static_cast<bool*>(good),
            static_cast<unsigned long long*>(counts)};
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  search_kernel<T><<<static_cast<unsigned>(blocks), BLOCK, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The search of n rays.  in: x, y, z, a, b, c, tMin, tMax, (n,) of float
// (is_double 0) or double (1); active: (n,) bool.  out: t, and the point
// x + a t, y + b t, z + c t (the last three may be null); lost: (n,) bool;
// good: (n,) bool or null.  newton 0 writes the bracket's result t0 as t
// (the caller takes the Newton steps).  counts: three int64 zeros or null.
// The surface: kind (xts::Kind), recip (1: divide by Rm as PyTorch does
// on a card), Rm, Rs, Rm2 = Rm ** 2 and RmRs = Rm - Rs as Python forms
// them, the facets' sizes and gaps, the search function's sign inv, the
// tolerances eps and rel and the iteration cap.  Returns the launch's
// cudaError_t.
extern "C" int toroid_search_launch(
    int is_double, int kind, int recip, int max_iter, double Rm, double Rs,
    double Rm2, double RmRs, double dx, double dxGap, double dy, double dyGap,
    double inv, double eps, double rel, const void* const* in,
    const void* active, long long n, int newton, void* const* out,
    void* lost, void* good, void* counts, void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL * BLOCK || kind < TOROID || kind > DICED_JOHANSSON)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch(make_params<double>(kind, recip, max_iter, Rm, Rs, Rm2,
                                      RmRs, dx, dxGap, dy, dyGap, inv, eps,
                                      rel),
                  in, active, n, newton, out, lost, good, counts, s);
  return launch(make_params<float>(kind, recip, max_iter, Rm, Rs, Rm2, RmRs,
                                   dx, dxGap, dy, dyGap, inv, eps, rel),
                in, active, n, newton, out, lost, good, counts, s);
}
