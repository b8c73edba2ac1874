// Weighted histogram of N rays into (ybins, xbins, k) bins, k = 1 or 3, and
// its adjoint with respect to the weights.
//
// The forward (hist2d_kernel) replaces the TPU kernel
// xrt_tpu/histogram.py:89 hist2d_mxu (a row one-hot contracted with a
// weighted column one-hot on the matrix unit, carried across sequential
// grid steps).  That form exists because scatter is slow on the TPU; on
// this card the same function is a scatter-add.  Bound: bytes, sizeof(T) *
// (2 + k) a ray (x, y and k weights; 1 + k for a 1D histogram, which passes
// y = nullptr) read once, the output written once.  What can cost more is
// the adds, and a focused beam that puts most rays into a few bins.  The
// adds are fixed-point integers (csrc/hist_accum.cuh), so two launches, and
// both routes, give the same bits.  The table lives where its size lets it
// (route): a private copy of its low words in every CTA's shared memory
// (128 x 128 x 3: 192 KB), else device memory (1024 x 1024 x 3), where the
// rays of a warp that share a bin are summed by shuffles first.  A scale
// pass before it finds the largest finite |w| on the device, a conversion
// pass after it writes the sums in the weights' dtype.  Float32 weights
// far below the largest (with a rounding residual) also add a fine word
// at their sum's own scale (hist_ray.cuh) to a second table in device
// memory, summed over a warp's lanes first, in the warps that hold one; a
// pass between the scale pass and the sums finds each sum's largest such
// weight.
//
// Bin index (hist_ray.cuh: axis_bin), the same expression as the plain
// PyTorch version (histogram._bin_index): floor((v - lo) / span * bins)
// with separate subtract, divide and multiply (the build has
// --fmad=false), inside when 0 <= index < bins and v is finite; v == hi is
// outside.
//
// The backward (hist2d_bwd_kernel) is the adjoint with respect to the
// weights: a gather, wbar[i, :] = g[iy(i), ix(i), :] for a ray inside the
// limits and 0 otherwise.  It recomputes both bin indices with the
// forward's expression (ray_bin), so a ray reads the bin it was added to.
// The coordinates and the limits get no gradient (floor).  Bound: bytes,
// (2 + k) * sizeof(T) per ray (x and y read once, k cotangents written
// once) plus the table.  So at k = 1 it moves the ray streams at full
// width: each thread takes 4 consecutive rays, with 16-byte loads of x and
// y and a 16-byte store of their cotangents.  The one-touch ray streams are
// evict-first (__ldcs, __stcs: 1e7 rays are 80 MB of x and y, more than the
// 50 MB L2), so the cotangent table (64-192 KB, read through __ldg) stays
// cached.  At k = 3 the table's scattered reads weigh more than the stream
// width: one ray a thread (measured faster there than four), and a colour
// bin read with two loads, not three (bin_row).  One thread per group of
// rays: a grid-stride loop over two blocks per SM (the earlier design)
// keeps too few loads in flight.  Rays past the last group of 4 take one
// thread each, and x, y or wbar that are not 16-byte aligned (a view at an
// odd offset is legal input) take the path of one ray per thread.
#include "hist_accum.cuh"

namespace {

using namespace xhist;

template <typename T>
struct HistArgs {
  const T *x, *y, *w;  // y null: a 1D histogram (ybins 1)
  long long n;
  T xlo, xspan, xb, ylo, yspan, yb;
  int xbins, ybins;
  u64* mbits;        // the largest finite |w|, a double's bits
  long long* acc;    // [bins][1] (k = 1) or [bins][4] (k = 3, padded)
  long long* fine;   // float32: the fine words, laid out as acc
  unsigned* flags;   // [bins]: bits 3 col + (NaN, +inf, -inf)
  unsigned* fmax;    // float32: the largest faint |w| of each sum
                     // (faint_max), laid out as acc
};

// columns a bin of the device-memory sums (a sector for k = 3)
template <int K>
constexpr int kPadded = K == 1 ? 1 : 4;

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
hist2d_scale_kernel(HistArgs<T> a) {
  const long long groups = (a.n + RAYS - 1) / RAYS;
  const bool vec = aligned16(a.w);
  double m = 0.0;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    T w[RAYS * K];
    load_run<T, RAYS * K>(a.w, g * RAYS * K, a.n * K, vec, w);
#pragma unroll
    for (int j = 0; j < RAYS * K; ++j)
      m = fmax(m, static_cast<double>(finite_abs(w[j])));
  }
  block_max_into(m, a.mbits);
}

// float32: each sum's largest faint |w| (hist_accum.cuh: faint_max)
template <int K>
__global__ void __launch_bounds__(THREADS)
hist2d_faint_kernel(HistArgs<float> a) {
  const double scale =
      ldexp(1.0, fixed_exp(max_of(a.mbits), scale_count<float>(a.n)));
  const bool has_y = a.y != nullptr;
  const bool vec = aligned16(a.x) && (!has_y || aligned16(a.y)) &&
                   aligned16(a.w);
  const long long groups = (a.n + RAYS - 1) / RAYS;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = g * RAYS;
    float xv[RAYS], yv[RAYS] = {}, wv[RAYS * K];
    load_run<float, RAYS>(a.x, i, a.n, vec, xv);
    if (has_y) load_run<float, RAYS>(a.y, i, a.n, vec, yv);
    load_run<float, RAYS * K>(a.w, i * K, a.n * K, vec, wv);
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      float m[K];
      bool any = false;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        m[c] = faint_of(wv[r * K + c], scale);
        any |= m[c] > 0.0f;
      }
      if (any && i + r < a.n) {
        const int ix = axis_bin(xv[r], a.xlo, a.xspan, a.xb);
        const int iy = has_y ? axis_bin(yv[r], a.ylo, a.yspan, a.yb) : 0;
        if (ix >= 0 && iy >= 0) {
          unsigned* slot = a.fmax + kPadded<K> * (iy * a.xbins + ix);
#pragma unroll
          for (int c = 0; c < K; ++c) faint_max(slot + c, m[c]);
        }
      }
    }
  }
}

template <typename T, int K, int ROUTE>
__global__ void __launch_bounds__(THREADS)
hist2d_kernel(HistArgs<T> a) {
  extern __shared__ __align__(16) unsigned smem[];
  const int bins = a.xbins * a.ybins;
  if constexpr (ROUTE == kShared) {
    for (int j = threadIdx.x; j < K * bins; j += blockDim.x) smem[j] = 0u;
    __syncthreads();
  }
  const int e = fixed_exp(max_of(a.mbits), scale_count<T>(a.n));
  const double scale = ldexp(1.0, e);
  const bool has_y = a.y != nullptr;
  const bool vec = aligned16(a.x) && (!has_y || aligned16(a.y)) &&
                   aligned16(a.w);
  const int lane = threadIdx.x & 31;
  const long long groups = (a.n + RAYS - 1) / RAYS;
  // every lane of a warp takes the same number of steps (warp_sum)
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g - lane < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = g * RAYS;
    T xv[RAYS], yv[RAYS] = {}, wv[RAYS * K];
    load_run<T, RAYS>(a.x, i, a.n, vec, xv);
    if (has_y) load_run<T, RAYS>(a.y, i, a.n, vec, yv);
    load_run<T, RAYS * K>(a.w, i * K, a.n * K, vec, wv);
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      int key = -1;
      if (i + r < a.n) {
        const int ix = axis_bin(xv[r], a.xlo, a.xspan, a.xb);
        const int iy = has_y ? axis_bin(yv[r], a.ylo, a.yspan, a.yb) : 0;
        key = ix >= 0 && iy >= 0 ? iy * a.xbins + ix : -1;
      }
      long long q[K];
      double res[K];
      unsigned bad = 0u;
      bool faint = false;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const unsigned f = nonfinite(wv[r * K + c]);
        bad |= f << (3 * c);
        q[c] = key < 0 || f ? 0 : to_fixed(wv[r * K + c], scale);
        res[c] = 0.0;
        if constexpr (sizeof(T) == 4)
          if (key >= 0 && !f) res[c] = residual(wv[r * K + c], q[c], scale);
        faint |= res[c] != 0.0;
      }
      if (key >= 0 && bad) atomicOr(a.flags + key, bad);  // rare
      const unsigned lanes =
          sizeof(T) == 4 ? __ballot_sync(0xffffffffu, faint) : 0u;
      if (lanes != 0u) {
        const bool many = __popc(lanes) > FINE_WARP_LANES;
        long long qf[K];
#pragma unroll
        for (int c = 0; c < K; ++c)
          qf[c] = faint ? fine_at(res[c], a.fmax + kPadded<K> * key + c, e,
                                  a.n)
                        : 0;
        if (many || faint) fine_add<K>(a.fine, faint ? key : -1, qf, many);
      }
      if constexpr (ROUTE == kGlobal) {
        const bool lead = warp_sum<K>(key, q);
        global_add<K>(a.acc, lead ? key : -1, q);
      } else if (key >= 0) {
        smem_add<K>(smem, bins, key, q, a.acc + kPadded<K> * key);
      }
    }
  }
  if constexpr (ROUTE == kShared) {
    __syncthreads();
    merge_table<K, kPadded<K>>(smem, bins, a.acc);
  }
}

// the sums and flags into out (bins, K) of the weights' dtype
template <typename T, int K>
__global__ void hist2d_out_kernel(HistArgs<T> a, T* out) {
  const int e = fixed_exp(max_of(a.mbits), scale_count<T>(a.n));
  const long long count = static_cast<long long>(a.xbins) * a.ybins * K;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < count; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long bin = j / K;
    const int col = static_cast<int>(j - bin * K);
    const long long s = a.acc[kPadded<K> * bin + col];
    T v;
    if constexpr (sizeof(T) == 4)
      v = from_fixed2(s, a.fine[kPadded<K> * bin + col], e,
                      faint_exp(a.fmax + kPadded<K> * bin + col, a.n));
    else
      v = from_fixed(s, e, T(0));
    out[j] = with_flags(v, (a.flags[bin] >> (3 * col)) & 7u);
  }
}

template <typename T, int K>
int launch(const HistArgs<T>& a, int route, void* out, cudaStream_t s) {
  const long long groups = (a.n + RAYS - 1) / RAYS;
  const long long smem =
      route == kGlobal ? 0 : 4LL * K * a.xbins * a.ybins;
  if (smem > MAX_SHARED_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0, err = 0;
  if (a.n > 0) {  // with no rays only the conversion runs: zeros
    err = grid_blocks(groups, THREADS, 2, &blocks);
    if (err) return err;
    hist2d_scale_kernel<T, K><<<blocks, THREADS, 0, s>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    if constexpr (sizeof(T) == 4) {
      hist2d_faint_kernel<K><<<blocks, THREADS, 0, s>>>(a);
      err = static_cast<int>(cudaGetLastError());
      if (err) return err;
    }
    const int b = static_cast<int>(smem);
    err = route == kShared
        ? launch_kernel(hist2d_kernel<T, K, kShared>, groups, b, s, a)
        : launch_kernel(hist2d_kernel<T, K, kGlobal>, groups, b, s, a);
    if (err) return err;
  }
  err = grid_blocks(static_cast<long long>(a.xbins) * a.ybins * K, 256, 8,
                    &blocks);
  if (err) return err;
  hist2d_out_kernel<T, K><<<blocks, 256, 0, s>>>(a, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// the bin of a ray, as hist2d_kernel adds it; -1 when the ray is outside
template <typename T>
__device__ __forceinline__ int ray_bin(T xv, T yv, bool has_y, T xlo,
                                       T xspan, T xb, int xbins, T ylo,
                                       T yspan, T yb) {
  const int ix = axis_bin(xv, xlo, xspan, xb);
  if (!has_y) return ix;
  const int iy = axis_bin(yv, ylo, yspan, yb);
  return ix >= 0 && iy >= 0 ? iy * xbins + ix : -1;
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

}  // namespace

// int64 entries of the work buffer of hist2d_launch for a (ybins, xbins,
// k) histogram: the sums, the scale pass's maximum (two entries), the
// flags (32 bits a bin) and, for float32 weights, the fine words and
// their largest faint weights (32 bits each).
extern "C" long long hist2d_work(int is_double, int k, int xbins, int ybins) {
  const long long nb = static_cast<long long>(xbins) * ybins;
  const long long sums = nb * (k == 1 ? 1 : 4);
  return sums + 2 + (nb + 1) / 2 + (is_double ? 0 : sums + (sums + 1) / 2);
}

// x, y: (n,) of float (is_double 0) or double (1), y may be null for a 1D
// histogram (ybins must then be 1); w: (n, k) row-major, k 1 or 3; out:
// (ybins, xbins, k), written in full.  xspan = xhi - xlo.  route: 0 a
// private copy of the table in each CTA's shared memory (a table too
// large for it is refused), 1 device memory.  work: hist2d_work(is_double,
// k, xbins, ybins) int64 zeros.  Returns the first failed launch's cudaError_t, or 0.
extern "C" int hist2d_launch(int is_double, int k, const void* x,
                             const void* y, const void* w, long long n,
                             double xlo, double xspan, int xbins, double ylo,
                             double yspan, int ybins, void* out, int route,
                             void* work, void* stream) {
  const long long nb = static_cast<long long>(xbins) * ybins;
  if (n < 0 || xbins <= 0 || ybins <= 0 || (y == nullptr && ybins != 1) ||
      nb * 4 > 0x7fffffffLL || route < 0 || route > 1 || (k != 1 && k != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  long long* acc = static_cast<long long*>(work);
  u64* mbits = reinterpret_cast<u64*>(acc + nb * (k == 1 ? 1 : 4));
  unsigned* flags = reinterpret_cast<unsigned*>(mbits + 2);
  long long* fine = reinterpret_cast<long long*>(mbits + 2) + (nb + 1) / 2;
  unsigned* fmax = reinterpret_cast<unsigned*>(fine + nb * (k == 1 ? 1 : 4));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XRT_HIST_CASE(T, K)                                                 \
  return launch<T, K>(                                                      \
      HistArgs<T>{static_cast<const T*>(x), static_cast<const T*>(y),       \
                  static_cast<const T*>(w), n, T(xlo), T(xspan), T(xbins),  \
                  T(ylo), T(yspan), T(ybins), xbins, ybins, mbits, acc,     \
                  fine, flags, fmax},                                       \
      route, out, s)
  if (!is_double && k == 1) XRT_HIST_CASE(float, 1);
  if (!is_double && k == 3) XRT_HIST_CASE(float, 3);
  if (is_double && k == 1) XRT_HIST_CASE(double, 1);
  XRT_HIST_CASE(double, 3);
#undef XRT_HIST_CASE
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
