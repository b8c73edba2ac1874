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
// limits and 0 otherwise, one thread per ray.  It recomputes both bin
// indices with the forward's expression, operation for operation, so a ray
// reads the bin it was added to.  The coordinates and the limits get no
// gradient (floor).  Bound: bytes, 4 * (2 + k) per ray (x, y read, k
// cotangents written) plus the gathered bins.
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

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
hist2d_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  const T* __restrict__ g, long long n, T xlo, T xspan,
                  int xbins, T ylo, T yspan, int ybins,
                  T* __restrict__ wbar) {
  const T xb = static_cast<T>(xbins), yb = static_cast<T>(ybins);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const T xv = x[i];
    const T fx = floor((xv - xlo) / xspan * xb);
    bool inside = fx >= T(0) && fx < xb && isfinite(xv);
    int bin = 0;
    if (y != nullptr) {
      const T yv = y[i];
      const T fy = floor((yv - ylo) / yspan * yb);
      inside = inside && fy >= T(0) && fy < yb && isfinite(yv);
      if (inside) bin = static_cast<int>(fy) * xbins;
    }
    if (inside) bin = (bin + static_cast<int>(fx)) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) wbar[i * K + j] = inside ? g[bin + j] : T(0);
  }
}

template <typename T, int K>
int launch_bwd(const void* x, const void* y, const void* g, long long n,
               double xlo, double xspan, int xbins, double ylo, double yspan,
               int ybins, void* wbar, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > static_cast<long long>(sms) * 2)
    blocks = static_cast<long long>(sms) * 2;
  hist2d_bwd_kernel<T, K><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(g), n, static_cast<T>(xlo),
      static_cast<T>(xspan), xbins, static_cast<T>(ylo),
      static_cast<T>(yspan), ybins, static_cast<T*>(wbar));
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
