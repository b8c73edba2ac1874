// All eight histograms of one plot and one traced pass in one read of the
// rays: runner.histogram_plot's colorize, |flux|, the plot mask and the six
// 1D and two 2D histograms (xh, xhRGB, yh, yhRGB, eh, ehRGB, xyh, xyhRGB)
// and the total |flux|.  It is the histogram kernel B4 (which replaces the
// TPU kernel xrt_tpu/histogram.py:89 hist2d_mxu) on the trace's main path.
//
// Bound: bytes.  A ray is read once, 5 * sizeof(T) + 1 bytes (x, y, cData,
// flux, w2d and the mask), where eight separate histograms and colorize
// read and write ~100 bytes a ray; the outputs are written once.  What
// can cost more is the adds: every ray adds 4 columns (|flux| or w2d, and
// r, g, b) into 4 tables.  The low words of the three 1D tables (16 bytes
// a bin) live in every CTA's shared memory (csrc/hist_accum.cuh), and so do
// those of the 2D table's colour columns where they fit (route kShared:
// 128 x 128 bins, 192 KB); else (1024 x 1024 bins) the colour columns add
// to device memory.  The 2D intensity column always does.  Float32 weights
// far below the largest (with a rounding residual) also carry a fine word
// at their sum's own scale (hist_ray.cuh), added to a second set of tables:
// the 1D tables' low words in shared memory beside the coarse ones (so a
// plot of 128 bins takes 204 KB a CTA), the 2D table's in device memory.
// A bin of faint rays keeps their sum, as a float sum does.
//
// Launches on the stream, no host read between them: the scale pass (the
// largest finite |flux * mask| and |w2d * mask|: the fixed-point scales,
// hist_ray.cuh), for float32 the faint pass (each sum's largest faint
// weight),
// the main kernel, and the conversion of the integer sums and flags into
// the output's dtype.  The per-ray arithmetic
// (hist_ray.cuh: plot_ray) is the plain version's operation for operation.
#include "hist_accum.cuh"

namespace {

using namespace xhist;

template <typename T>
struct PlotArgs {
  const T *x, *y, *c, *flux, *w2d;
  const bool* mask;
  long long n;
  PlotAxes<T> ax;
  int xb, yb, cb;
  u64* mbits;        // [max |flux m|, max |w2d m|] as doubles' bits
  long long* acc;    // x [xb][4], y [yb][4], c [cb][4], xy [yb*xb][4], total
  long long* fine;   // float32: the fine words, laid out as acc
  unsigned* flags;   // x [xb], y [yb], c [cb], xy [yb*xb], total
  unsigned* fmax;    // float32: the largest faint |w| (faint_max) of each
                     // sum, laid out as acc
};

// the fixed-point exponents of the |flux| and colour columns (ea) and of
// the 2D intensity column (eb), from the scale pass
template <typename T>
__device__ __forceinline__ void plot_exps(const u64* mbits, T s, long long n,
                                          int* ea, int* eb) {
  T ma = rgb_bound(static_cast<T>(max_of(mbits)), s);
  if (!isfinite(ma)) ma = sizeof(T) == 4 ? T(3.4028234663852886e38)
                                         : T(1.7976931348623157e308);
  *ea = fixed_exp(static_cast<double>(ma), scale_count<T>(n));
  *eb = fixed_exp(max_of(mbits + 1), scale_count<T>(n));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
plot_scale_kernel(PlotArgs<T> a) {
  const long long groups = (a.n + RAYS - 1) / RAYS;
  const bool vec = aligned16(a.flux) && aligned16(a.w2d) &&
                   reinterpret_cast<u64>(a.mask) % 4 == 0;
  double m1 = 0.0, m2 = 0.0;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    T f[RAYS], w[RAYS];
    bool m[RAYS];
    load_run<T, RAYS>(a.flux, g * RAYS, a.n, vec, f);
    load_run<T, RAYS>(a.w2d, g * RAYS, a.n, vec, w);
    load_mask(a.mask, g * RAYS, a.n, vec, m);
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      const T mr = m[r] ? T(1) : T(0);
      m1 = fmax(m1, static_cast<double>(finite_abs(f[r] * mr)));
      m2 = fmax(m2, static_cast<double>(finite_abs(w[r] * mr)));
    }
  }
  block_max_into(m1, a.mbits);
  block_max_into(m2, a.mbits + 1);
}

// float32: each sum's largest faint weight; those of the 1D tables in
// every CTA's shared memory first (a few bins take many rays), the 2D
// table's in device memory
__global__ void __launch_bounds__(THREADS)
plot_faint_kernel(PlotArgs<float> a) {
  extern __shared__ __align__(16) unsigned smem[];
  const int n1 = a.xb + a.yb + a.cb;
  for (int j = threadIdx.x; j < 4 * n1; j += blockDim.x) smem[j] = 0u;
  __syncthreads();
  int ea, eb;
  plot_exps(a.mbits, a.ax.s, a.n, &ea, &eb);
  const double sa = ldexp(1.0, ea), sb = ldexp(1.0, eb);
  const int o1[3] = {0, a.xb, a.xb + a.yb};
  const long long nb = n1 + static_cast<long long>(a.xb) * a.yb;
  const bool vec = aligned16(a.x) && aligned16(a.y) && aligned16(a.c) &&
                   aligned16(a.flux) && aligned16(a.w2d) &&
                   reinterpret_cast<u64>(a.mask) % 4 == 0;
  const long long groups = (a.n + RAYS - 1) / RAYS;
  float total = 0.0f;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = g * RAYS;
    float xv[RAYS], yv[RAYS], cv[RAYS], fv[RAYS], wv[RAYS];
    bool mv[RAYS];
    load_run<float, RAYS>(a.x, i, a.n, vec, xv);
    load_run<float, RAYS>(a.y, i, a.n, vec, yv);
    load_run<float, RAYS>(a.c, i, a.n, vec, cv);
    load_run<float, RAYS>(a.flux, i, a.n, vec, fv);
    load_run<float, RAYS>(a.w2d, i, a.n, vec, wv);
    load_mask(a.mask, i, a.n, vec, mv);
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      if (i + r >= a.n) continue;
      const PlotRay<float> p = plot_ray(xv[r], yv[r], cv[r], fv[r], wv[r],
                                        mv[r], a.ax);
      const float fa = faint_of(p.af, sa), fw = faint_of(p.w2, sb);
      const float fc[3] = {faint_of(p.rgb[0], sa), faint_of(p.rgb[1], sa),
                           faint_of(p.rgb[2], sa)};
      total = fmaxf(total, fa);
      if (fa == 0.0f && fw == 0.0f && fc[0] == 0.0f && fc[1] == 0.0f &&
          fc[2] == 0.0f)
        continue;
      const int keys[3] = {p.ix, p.iy, p.ic};
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if (keys[t] < 0) continue;
        unsigned* slot = smem + 4 * (o1[t] + keys[t]);
        faint_max(slot, fa);
#pragma unroll
        for (int c = 0; c < 3; ++c) faint_max(slot + 1 + c, fc[c]);
      }
      if (p.ix >= 0 && p.iy >= 0) {
        unsigned* slot = a.fmax + 4 * (n1 + p.iy * a.xb + p.ix);
        faint_max(slot, fw);
#pragma unroll
        for (int c = 0; c < 3; ++c) faint_max(slot + 1 + c, fc[c]);
      }
    }
  }
  block_faint_max(total, a.fmax + 4 * nb);
  __syncthreads();
  for (int j = threadIdx.x; j < 4 * n1; j += blockDim.x)
    if (smem[j] != 0u) atomicMax(a.fmax + j, smem[j]);
}

template <typename T, int ROUTE>
__global__ void __launch_bounds__(THREADS)
plot_kernel(PlotArgs<T> a) {
  extern __shared__ __align__(16) unsigned smem[];
  const int n1 = a.xb + a.yb + a.cb;          // 1D bins
  unsigned* tab2 = smem + 4 * n1;              // the 2D colour columns
  const int b1[3] = {a.xb, a.yb, a.cb};        // the 1D tables
  const int o1[3] = {0, a.xb, a.xb + a.yb};
  const int bins2 = a.xb * a.yb;
  const int words = 4 * n1 + (ROUTE == kGlobal ? 0 : 3 * bins2);
  unsigned* fine1 = smem + words;              // float32: the 1D fine words
  const int fine_words = sizeof(T) == 4 ? 4 * n1 : 0;
  for (int j = threadIdx.x; j < words + fine_words; j += blockDim.x)
    smem[j] = 0u;
  __syncthreads();
  int ea, eb;
  plot_exps(a.mbits, a.ax.s, a.n, &ea, &eb);
  const double sa = ldexp(1.0, ea), sb = ldexp(1.0, eb);
  const long long o2 = 4LL * n1;               // the 2D table in acc
  const long long ot = o2 + 4LL * a.xb * a.yb;  // the total
  const bool vec = aligned16(a.x) && aligned16(a.y) && aligned16(a.c) &&
                   aligned16(a.flux) && aligned16(a.w2d) &&
                   reinterpret_cast<u64>(a.mask) % 4 == 0;
  const int lane = threadIdx.x & 31;
  const long long groups = (a.n + RAYS - 1) / RAYS;
  long long total = 0, total_f = 0;
  // every lane of a warp takes the same number of steps (warp_sum)
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g - lane < groups; g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = g * RAYS;
    T xv[RAYS], yv[RAYS], cv[RAYS], fv[RAYS], wv[RAYS];
    bool mv[RAYS];
    load_run<T, RAYS>(a.x, i, a.n, vec, xv);
    load_run<T, RAYS>(a.y, i, a.n, vec, yv);
    load_run<T, RAYS>(a.c, i, a.n, vec, cv);
    load_run<T, RAYS>(a.flux, i, a.n, vec, fv);
    load_run<T, RAYS>(a.w2d, i, a.n, vec, wv);
    load_mask(a.mask, i, a.n, vec, mv);
#pragma unroll
    for (int r = 0; r < RAYS; ++r) {
      PlotRay<T> p = plot_ray(xv[r], yv[r], cv[r], fv[r], wv[r], mv[r], a.ax);
      const bool valid = i + r < a.n;
      if (!valid) p.ix = p.iy = p.ic = -1;
      const unsigned fa = nonfinite(p.af), fw = nonfinite(p.w2),
                     fr = nonfinite(p.rgb[0]), fg = nonfinite(p.rgb[1]),
                     fb = nonfinite(p.rgb[2]);
      const long long qa = fa || !valid ? 0 : to_fixed(p.af, sa);
      const long long qw = fw || !valid ? 0 : to_fixed(p.w2, sb);
      long long qc[3];
      qc[0] = fr || !valid ? 0 : to_fixed(p.rgb[0], sa);
      qc[1] = fg || !valid ? 0 : to_fixed(p.rgb[1], sa);
      qc[2] = fb || !valid ? 0 : to_fixed(p.rgb[2], sa);
      total += qa;
      // the rounding residuals (float32): zero for a weight on the coarse
      // grid
      double ra = 0.0, rw = 0.0, rc[3] = {0.0, 0.0, 0.0};
      if constexpr (sizeof(T) == 4) {
        if (valid) {
          if (!fa) ra = residual(p.af, qa, sa);
          if (!fw) rw = residual(p.w2, qw, sb);
          if (!fr) rc[0] = residual(p.rgb[0], qc[0], sa);
          if (!fg) rc[1] = residual(p.rgb[1], qc[1], sa);
          if (!fb) rc[2] = residual(p.rgb[2], qc[2], sa);
        }
      }
      const bool faint = ra != 0.0 || rw != 0.0 || rc[0] != 0.0 ||
                         rc[1] != 0.0 || rc[2] != 0.0;
      const int k2 = p.ix >= 0 && p.iy >= 0 ? p.iy * a.xb + p.ix : -1;
      if (valid && (fa | fw | fr | fg | fb)) {  // rare: non-finite weights
        const unsigned c3 = fr << 3 | fg << 6 | fb << 9;
        if (p.ix >= 0 && (fa | c3)) atomicOr(a.flags + p.ix, fa | c3);
        if (p.iy >= 0 && (fa | c3))
          atomicOr(a.flags + a.xb + p.iy, fa | c3);
        if (p.ic >= 0 && (fa | c3))
          atomicOr(a.flags + a.xb + a.yb + p.ic, fa | c3);
        if (k2 >= 0 && (fw | c3)) atomicOr(a.flags + n1 + k2, fw | c3);
        if (fa) atomicOr(a.flags + n1 + a.xb * a.yb, fa);
      }
      const int keys[3] = {p.ix, p.iy, p.ic};
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        long long v[4] = {qa, qc[0], qc[1], qc[2]};
        if (keys[t] >= 0)
          smem_add<4>(smem + 4 * o1[t], b1[t], keys[t], v,
                      a.acc + 4 * (o1[t] + keys[t]));
      }
      if constexpr (ROUTE == kGlobal) {
        long long v[4] = {qw, qc[0], qc[1], qc[2]};
        const bool lead = warp_sum<4>(k2, v);
        global_add<4>(a.acc + o2, lead ? k2 : -1, v);
      } else {
        long long w[1] = {qw};
        const bool lead = warp_sum<1>(k2, w);
        if (lead && w[0] != 0)
          atomicAdd(reinterpret_cast<u64*>(a.acc + o2 + 4 * k2),
                    static_cast<u64>(w[0]));
        if (k2 >= 0) smem_add<3>(tab2, bins2, k2, qc, a.acc + o2 + 4 * k2 + 1);
      }
      // the fine words at each sum's fine exponent (float32)
      const unsigned lanes =
          sizeof(T) == 4 ? __ballot_sync(0xffffffffu, faint) : 0u;
      if (lanes != 0u) {
        const bool many = __popc(lanes) > FINE_WARP_LANES;
        const unsigned* fm = a.fmax;
        if (faint) {
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            if (keys[t] < 0) continue;
            const unsigned* slot = fm + 4 * (o1[t] + keys[t]);
            long long v[4];
            v[0] = fine_at(ra, slot, ea, a.n);
#pragma unroll
            for (int c = 0; c < 3; ++c)
              v[c + 1] = fine_at(rc[c], slot + 1 + c, ea, a.n);
            smem_add<4>(fine1 + 4 * o1[t], b1[t], keys[t], v,
                        a.fine + 4 * (o1[t] + keys[t]));
          }
        }
        long long v[4] = {0, 0, 0, 0};
        if (faint && k2 >= 0) {
          const unsigned* slot = fm + 4 * (n1 + k2);
          v[0] = fine_at(rw, slot, eb, a.n);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            v[c + 1] = fine_at(rc[c], slot + 1 + c, ea, a.n);
        }
        if (many || faint)
          fine_add<4>(a.fine + o2, faint ? k2 : -1, v, many);
        total_f += fine_at(ra, fm + 4 * (n1 + bins2), ea, a.n);
      }
    }
  }
  block_sum_into(total, a.acc + ot);
  if constexpr (sizeof(T) == 4) block_sum_into(total_f, a.fine + ot);
  __syncthreads();
  for (int t = 0; t < 3; ++t)
    merge_table<4, 4>(smem + 4 * o1[t], b1[t], a.acc + 4 * o1[t]);
  if constexpr (ROUTE == kShared) merge_table<3, 4>(tab2, bins2, a.acc + o2 + 1);
  if constexpr (sizeof(T) == 4)
    for (int t = 0; t < 3; ++t)
      merge_table<4, 4>(fine1 + 4 * o1[t], b1[t], a.fine + 4 * o1[t]);
}

// The integer sums and flags into the output, laid out as xh [xb],
// xhRGB [xb][3], yh, yhRGB, eh, ehRGB, xyh [yb][xb], xyhRGB [yb][xb][3] and
// the total: the same count as acc, whose entry j = 4 bin + col of a table
// goes to column col of that histogram pair.
template <typename T>
__global__ void plot_out_kernel(PlotArgs<T> a, T* out) {
  int ea, eb;
  plot_exps(a.mbits, a.ax.s, a.n, &ea, &eb);
  // the sum j in T: the coarse and, for float32, the fine word
  auto value = [&](long long j, int e) {
    if constexpr (sizeof(T) == 4)
      return from_fixed2(a.acc[j], a.fine[j], e, faint_exp(a.fmax + j, a.n));
    else
      return from_fixed(a.acc[j], e, T(0));
  };
  const int n1 = a.xb + a.yb + a.cb;
  const long long nb = n1 + static_cast<long long>(a.xb) * a.yb;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j <= 4 * nb; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (j == 4 * nb) {  // the total
      out[j] = with_flags(value(j, ea), a.flags[nb] & 7u);
      continue;
    }
    const long long bin = j >> 2;
    const int col = static_cast<int>(j & 3);
    long long start, size;  // the table's first bin and bins
    if (bin < a.xb) { start = 0; size = a.xb; }
    else if (bin < a.xb + a.yb) { start = a.xb; size = a.yb; }
    else if (bin < n1) { start = a.xb + a.yb; size = a.cb; }
    else { start = n1; size = nb - n1; }
    const int e = start == n1 && col == 0 ? eb : ea;
    const T v = with_flags(value(j, e), (a.flags[bin] >> (3 * col)) & 7u);
    const long long b = bin - start;
    out[4 * start + (col == 0 ? b : size + 3 * b + col - 1)] = v;
  }
}

template <typename T>
int launch(const PlotArgs<T>& a, int route, void* out, cudaStream_t s) {
  const long long groups = (a.n + RAYS - 1) / RAYS;
  const int n1 = a.xb + a.yb + a.cb;
  const long long smem = 16LL * n1 * (sizeof(T) == 4 ? 2 : 1) +
                         (route == kGlobal ? 0 : 12LL * a.xb * a.yb);
  if (smem > MAX_SHARED_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0, err = 0;
  if (a.n > 0) {  // with no rays only the conversion runs: zeros
    err = grid_blocks(groups, THREADS, 2, &blocks);
    if (err) return err;
    plot_scale_kernel<T><<<blocks, THREADS, 0, s>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    if constexpr (sizeof(T) == 4) {
      err = launch_kernel(plot_faint_kernel, groups, 16 * n1, s, a);
      if (err) return err;
    }
    const int b = static_cast<int>(smem);
    err = route == kShared
        ? launch_kernel(plot_kernel<T, kShared>, groups, b, s, a)
        : launch_kernel(plot_kernel<T, kGlobal>, groups, b, s, a);
    if (err) return err;
  }
  const long long entries = 4 * (n1 + static_cast<long long>(a.xb) * a.yb) + 1;
  err = grid_blocks(entries, 256, 8, &blocks);
  if (err) return err;
  plot_out_kernel<T><<<blocks, 256, 0, s>>>(a, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// int64 entries of the work buffer of hist_plot_launch: the sums and the
// total, the scale pass's two maxima, the flags (32 bits a bin and the
// total) and, for float32 rays, the fine words of the sums and the total
// and their largest faint weights (32 bits each).
extern "C" long long hist_plot_work(int is_double, int xb, int yb, int cb) {
  const long long nb = xb + yb + cb + static_cast<long long>(xb) * yb;
  return 4 * nb + 1 + 2 + (nb + 2) / 2 +
         (is_double ? 0 : 4 * nb + 1 + (4 * nb + 2) / 2);
}

// One plot's histograms.  x, y, c (cData), flux, w2d: (n,) of float
// (is_double 0) or double (1); mask: (n,) bool.  Axes: lo and span (hi -
// lo) and bins of x, y and c; cf, cs: colorFactor, colorSaturation.  route:
// 0 shared, 1 global (the 2D colour columns'; the 1D tables are always in
// shared memory, the 2D intensity column in device memory).  work:
// hist_plot_work(is_double, xb, yb, cb) int64 zeros.  out:
// 4 nb + 1 values of the dtype, nb = xb + yb + cb + xb yb (see
// plot_out_kernel).  Returns the first failed launch's cudaError_t, or 0.
extern "C" int hist_plot_launch(int is_double, const void* x, const void* y,
                                const void* c, const void* flux,
                                const void* w2d, const void* mask, long long n,
                                double xlo, double xspan, int xb, double ylo,
                                double yspan, int yb, double clo, double cspan,
                                int cb, double cf, double cs, int route,
                                void* work, void* out, void* stream) {
  if (n < 0 || xb <= 0 || yb <= 0 || cb <= 0 || route < 0 || route > 1 ||
      static_cast<long long>(xb) * yb > 0x7fffffffLL / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = xb + yb + cb + static_cast<long long>(xb) * yb;
  long long* acc = static_cast<long long*>(work);
  u64* mbits = reinterpret_cast<u64*>(acc + 4 * nb + 1);
  unsigned* flags = reinterpret_cast<unsigned*>(mbits + 2);
  long long* fine = reinterpret_cast<long long*>(mbits + 2) + (nb + 2) / 2;
  unsigned* fmax = reinterpret_cast<unsigned*>(fine + 4 * nb + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    PlotArgs<double> a{static_cast<const double*>(x),
                       static_cast<const double*>(y),
                       static_cast<const double*>(c),
                       static_cast<const double*>(flux),
                       static_cast<const double*>(w2d),
                       static_cast<const bool*>(mask), n,
                       {xlo, xspan, double(xb), ylo, yspan, double(yb), clo,
                        cspan, double(cb), cf, cs},
                       xb, yb, cb, mbits, acc, fine, flags, fmax};
    return launch(a, route, out, s);
  }
  PlotArgs<float> a{static_cast<const float*>(x),
                    static_cast<const float*>(y),
                    static_cast<const float*>(c),
                    static_cast<const float*>(flux),
                    static_cast<const float*>(w2d),
                    static_cast<const bool*>(mask), n,
                    {float(xlo), float(xspan), float(xb), float(ylo),
                     float(yspan), float(yb), float(clo), float(cspan),
                     float(cb), float(cf), float(cs)},
                    xb, yb, cb, mbits, acc, fine, flags, fmax};
  return launch(a, route, out, s);
}
