// Weighted histogram of N rays into (ybins, xbins, k) bins by scatter-add.
//
// Replaces the TPU kernel xrt_tpu/histogram.py:89 hist2d_mxu (a row one-hot
// contracted with a weighted column one-hot on the matrix unit, carried
// across sequential grid steps).  That form exists because scatter is slow
// on the TPU; on this card the same function is a scatter-add with atomics.
//
// Bound: bytes.  Each ray is 4 * (2 + k) bytes read once (x, y and k
// weights; 4 * (1 + k) for a 1D histogram, which passes y = nullptr) and
// does a handful of operations; the output is written once.  What can cost
// more than the stream is contention: a focused beam puts most rays into a
// few bins.  So each block keeps a private copy of the histogram in shared
// memory when it fits (128 x 128 x 3 floats = 192 KB fits the 227 KB a
// block may use), adds with shared-memory atomics, and merges its non-zero
// bins into the global result at the end.  The per-block partial sums also
// keep a bin that receives millions of rays from being one long running
// f32 sum.  Histograms too large for shared memory add straight into global
// memory.
//
// Bin index, the same expression as the plain PyTorch version
// (histogram._bin_index): floor((v - lo) / span * bins) with separate
// subtract, divide and multiply (the build has --fmad=false), inside when
// 0 <= index < bins and v is finite; v == hi is outside.
//
// The backward (hist2d_bwd_kernel) is the adjoint with respect to the
// weights: a gather, wbar[i, :] = g[iy(i), ix(i), :] for a ray inside the
// limits and 0 otherwise.  It recomputes both bin indices with the
// forward's expression, operation for operation (ray_bin), so a ray reads
// the bin it was added to.  The coordinates and the limits get no gradient
// (floor).  Bound: bytes, (2 + k) * sizeof(T) per ray (x and y read once,
// k cotangents written once) plus the table.  So at k = 1 it moves the
// ray streams at full width: each thread takes 4 consecutive rays, with
// 16-byte loads of x and y and a 16-byte store of their cotangents.  The
// one-touch ray streams are evict-first (__ldcs, __stcs: 1e7 rays are 80 MB
// of x and y, more than the 50 MB L2), so the cotangent table (64-192 KB,
// read through __ldg) stays cached.  At k = 3 the table's scattered reads
// weigh more than the stream width: one ray a thread (measured faster
// there than four), and a colour bin read with two loads, not three
// (bin_row).  One thread per group of rays: a grid-stride loop over two
// blocks per SM (the earlier design) keeps too few loads in flight.  Rays
// past the last group of 4 take one thread each, and x, y or wbar that are
// not 16-byte aligned (a view at an odd offset is legal input) take the
// path of one ray per thread.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
// the most dynamic shared memory a block may use on sm_90
constexpr int MAX_SHARED_BYTES = 232448;

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
hist2d_kernel(const T* __restrict__ x, const T* __restrict__ y,
              const T* __restrict__ w, long long n, T xlo, T xspan,
              int xbins, T ylo, T yspan, int ybins, T* __restrict__ out,
              int use_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* priv = reinterpret_cast<T*>(smem);
  const int nb = ybins * xbins * K;
  if (use_shared) {
    for (int i = threadIdx.x; i < nb; i += blockDim.x) priv[i] = T(0);
    __syncthreads();
  }
  T* h = use_shared ? priv : out;
  const T xb = static_cast<T>(xbins), yb = static_cast<T>(ybins);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const T xv = x[i];
    const T fx = floor((xv - xlo) / xspan * xb);
    // comparisons with NaN are false, so a NaN index is outside
    bool inside = fx >= T(0) && fx < xb && isfinite(xv);
    int bin = 0;
    if (y != nullptr) {
      const T yv = y[i];
      const T fy = floor((yv - ylo) / yspan * yb);
      inside = inside && fy >= T(0) && fy < yb && isfinite(yv);
      if (inside) bin = static_cast<int>(fy) * xbins;
    }
    if (!inside) continue;
    bin = (bin + static_cast<int>(fx)) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const T wv = w[i * K + j];
      if (wv != T(0)) atomicAdd(&h[bin + j], wv);
    }
  }
  if (use_shared) {
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      const T v = priv[i];
      if (v != T(0)) atomicAdd(&out[i], v);
    }
  }
}

// the bin of a ray, as in hist2d_kernel, operation for operation; -1 when
// the ray is outside
template <typename T>
__device__ __forceinline__ int ray_bin(T xv, T yv, bool has_y, T xlo,
                                       T xspan, T xb, int xbins, T ylo,
                                       T yspan, T yb) {
  const T fx = floor((xv - xlo) / xspan * xb);
  bool inside = fx >= T(0) && fx < xb && isfinite(xv);
  int bin = 0;
  if (has_y) {
    const T fy = floor((yv - ylo) / yspan * yb);
    inside = inside && fy >= T(0) && fy < yb && isfinite(yv);
    if (inside) bin = static_cast<int>(fy) * xbins;
  }
  return inside ? bin + static_cast<int>(fx) : -1;
}

// 16 bytes of a one-touch stream, evict-first
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 t = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// the K cotangents of bin (zeros for -1).  The loads do not depend on
// whether the ray is inside (an outside ray reads bin 0), so a thread's
// loads for all its rays can be in flight together.  The three values of a
// colour bin are read as an aligned pair and a single value (which is
// first depends on the bin's parity): gathers scattered over the table are
// what limits the kernel at k = 3, and two loads are fewer than three.
template <typename T, int K>
__device__ __forceinline__ void bin_row(const T* g, int bin, T* o) {
  const int b = bin < 0 ? 0 : bin;
  T v[K];
  if constexpr (K == 3) {
    using P2 = typename Pair<T>::type;
    const bool odd = b & 1;
    const P2 p = __ldg(reinterpret_cast<const P2*>(g + 3 * b + odd));
    const T q = __ldg(g + 3 * b + (odd ? 0 : 2));
    v[0] = odd ? q : p.x;
    v[1] = odd ? p.x : p.y;
    v[2] = odd ? p.y : q;
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = __ldg(g + b * K + j);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) o[j] = bin < 0 ? T(0) : v[j];
}

constexpr int BWD_THREADS = 256;
constexpr int RAYS = 4;  // consecutive rays per thread on the vector path

// VEC: each thread takes RAYS consecutive rays (the rays past the last
// group one each; x, y and wbar 16-byte aligned, k = 1), else one ray.
// HAS_Y: a 2D histogram.
template <typename T, int K, bool HAS_Y, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS)
hist2d_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const T* __restrict__ g, long long n, T xlo, T xspan,
                  int xbins, T ylo, T yspan, int ybins,
                  T* __restrict__ wbar) {
  constexpr int E = 16 / sizeof(T);  // values per 16 bytes
  const T xb = static_cast<T>(xbins), yb = static_cast<T>(ybins);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  long long done = 0;
  if constexpr (VEC) {
    const long long q = tid;
    done = n / RAYS * RAYS;
    if (q * RAYS < done) {
      T xv[RAYS], yv[RAYS] = {}, out[RAYS * K];
#pragma unroll
      for (int e = 0; e < RAYS; e += E) load16(x + q * RAYS + e, xv + e);
      if constexpr (HAS_Y) {
#pragma unroll
        for (int e = 0; e < RAYS; e += E) load16(y + q * RAYS + e, yv + e);
      }
      int bins[RAYS];
#pragma unroll
      for (int r = 0; r < RAYS; ++r)
        bins[r] = ray_bin(xv[r], yv[r], HAS_Y, xlo, xspan, xb, xbins, ylo,
                          yspan, yb);
#pragma unroll
      for (int r = 0; r < RAYS; ++r) bin_row<T, K>(g, bins[r], out + r * K);
#pragma unroll
      for (int e = 0; e < RAYS * K; e += E)
        store16(wbar + q * RAYS * K + e, out + e);
    }
  }
  const long long i = done + tid;
  if (i < n) {
    T o[K];
    bin_row<T, K>(g, ray_bin(__ldcs(x + i), HAS_Y ? __ldcs(y + i) : T(0),
                             HAS_Y, xlo, xspan, xb, xbins, ylo, yspan, yb),
                  o);
#pragma unroll
    for (int j = 0; j < K; ++j) __stcs(wbar + i * K + j, o[j]);
  }
}

template <typename T, int K, bool HAS_Y, bool VEC>
void launch_bwd_kernel(long long threads, const void* x, const void* y,
                       const void* g, long long n, double xlo, double xspan,
                       int xbins, double ylo, double yspan, int ybins,
                       void* wbar, cudaStream_t s) {
  const long long blocks = (threads + BWD_THREADS - 1) / BWD_THREADS;
  hist2d_bwd_kernel<T, K, HAS_Y, VEC>
      <<<static_cast<unsigned>(blocks), BWD_THREADS, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<const T*>(g), n, static_cast<T>(xlo),
          static_cast<T>(xspan), xbins, static_cast<T>(ylo),
          static_cast<T>(yspan), ybins, static_cast<T*>(wbar));
}

template <typename T, int K>
int launch_bwd(const void* x, const void* y, const void* g, long long n,
               double xlo, double xspan, int xbins, double ylo, double yspan,
               int ybins, void* wbar, cudaStream_t s) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  // at k = 3 the scattered reads of the table, not the streams, limit the
  // kernel, and one ray a thread measured faster than four
  const bool vec = K == 1 && aligned(x) && (y == nullptr || aligned(y)) &&
                   aligned(wbar);
  // one thread per group of rays (a grid-stride loop over fewer blocks
  // keeps fewer loads in flight: measured slower), enough for the tail
  const long long groups = n / RAYS, tail = n - groups * RAYS;
  const long long threads = vec ? (groups > tail ? groups : tail) : n;
#define XRT_BWD(HY, V)                                                     \
  launch_bwd_kernel<T, K, HY, V>(threads, x, y, g, n, xlo, xspan, xbins,   \
                                 ylo, yspan, ybins, wbar, s)
  if (y != nullptr && vec) XRT_BWD(true, K == 1);
  else if (y != nullptr) XRT_BWD(true, false);
  else if (vec) XRT_BWD(false, K == 1);
  else XRT_BWD(false, false);
#undef XRT_BWD
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch(const void* x, const void* y, const void* w, long long n,
           double xlo, double xspan, int xbins, double ylo, double yspan,
           int ybins, void* out, int use_shared, cudaStream_t s) {
  const long long bytes =
      static_cast<long long>(ybins) * xbins * K * sizeof(T);
  if (use_shared && bytes > MAX_SHARED_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = use_shared ? static_cast<int>(bytes) : 0;
  // as many blocks as the card holds at once, each looping over the rays:
  // two blocks of 1024 threads fill an SM, unless the private copy of the
  // shared-memory variant leaves room for one only
  int per_sm = 2;
  if (use_shared && 2 * bytes > MAX_SHARED_BYTES) per_sm = 1;
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > static_cast<long long>(sms) * per_sm)
    blocks = static_cast<long long>(sms) * per_sm;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(hist2d_kernel<T, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hist2d_kernel<T, K><<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(w), n, static_cast<T>(xlo),
      static_cast<T>(xspan), xbins, static_cast<T>(ylo),
      static_cast<T>(yspan), ybins, static_cast<T*>(out), use_shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (n,) of float (is_double 0) or double (1), y may be null for a 1D
// histogram (ybins must then be 1); w: (n, k) row-major, k 1 or 3; out:
// (ybins, xbins, k), zeroed by the caller.  xspan = xhi - xlo.  use_shared
// picks the block-private variant (refused when the histogram does not fit
// into shared memory), else atomics go straight to global memory.  Returns
// cudaGetLastError() after the launch.
extern "C" int hist2d_launch(int is_double, int k, const void* x,
                             const void* y, const void* w, long long n,
                             double xlo, double xspan, int xbins, double ylo,
                             double yspan, int ybins, void* out,
                             int use_shared, void* stream) {
  if (n <= 0) return 0;
  if (xbins <= 0 || ybins <= 0 || (y == nullptr && ybins != 1) ||
      static_cast<long long>(xbins) * ybins * k > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XRT_HIST_CASE(T, K)                                               \
  return launch<T, K>(x, y, w, n, xlo, xspan, xbins, ylo, yspan, ybins,   \
                      out, use_shared, s)
  if (!is_double && k == 1) XRT_HIST_CASE(float, 1);
  if (!is_double && k == 3) XRT_HIST_CASE(float, 3);
  if (is_double && k == 1) XRT_HIST_CASE(double, 1);
  if (is_double && k == 3) XRT_HIST_CASE(double, 3);
#undef XRT_HIST_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The adjoint with respect to the weights.  x, y, the limits and the bin
// counts as in hist2d_launch; g: (ybins, xbins, k), the cotangent of the
// histogram; wbar: (n, k), written in full.  Returns cudaGetLastError()
// after the launch.
extern "C" int hist2d_bwd_launch(int is_double, int k, const void* x,
                                 const void* y, const void* g, long long n,
                                 double xlo, double xspan, int xbins,
                                 double ylo, double yspan, int ybins,
                                 void* wbar, void* stream) {
  if (n <= 0) return 0;
  if (xbins <= 0 || ybins <= 0 || (y == nullptr && ybins != 1) ||
      static_cast<long long>(xbins) * ybins * k > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XRT_HIST_BWD_CASE(T, K)                                            \
  return launch_bwd<T, K>(x, y, g, n, xlo, xspan, xbins, ylo, yspan, ybins, \
                          wbar, s)
  if (!is_double && k == 1) XRT_HIST_BWD_CASE(float, 1);
  if (!is_double && k == 3) XRT_HIST_BWD_CASE(float, 3);
  if (is_double && k == 1) XRT_HIST_BWD_CASE(double, 1);
  if (is_double && k == 3) XRT_HIST_BWD_CASE(double, 3);
#undef XRT_HIST_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
