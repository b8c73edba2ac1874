// The per-ray arithmetic of the histogram kernels, for the device and the
// host: the bin index, the colour of a ray (colorize / hsv_to_rgb of
// histogram.py) and the fixed-point weights whose sums do not depend on the
// order of the adds.  Nothing here touches memory, so the CPU tests compile
// this header with g++ -ffp-contract=off and a stub cuda_runtime.h and hold
// it against the plain PyTorch versions bit for bit
// (tests/test_torch_hist_plot.py).  The build has --fmad=false: every
// expression is the plain version's operations in its order.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace xhist {

// The bin of coordinate v on an axis [lo, lo + span) of `bins` bins, or -1:
// floor((v - lo) / span * bins) as a separate subtract, divide and multiply
// (histogram._bin_index divides by a 0-dim tensor for the same bits);
// inside when 0 <= index < bins and v is finite, so v == hi is outside and
// a NaN index (comparisons with NaN are false) too.
template <typename T>
__device__ __forceinline__ int axis_bin(T v, T lo, T span, T bins) {
  const T f = floor((v - lo) / span * bins);
  return f >= T(0) && f < bins && isfinite(v) ? static_cast<int>(f) : -1;
}

// torch.clamp(v, 0, 1): NaN stays NaN (fminf / fmaxf would drop it)
template <typename T>
__device__ __forceinline__ T clamp01(T v) {
  return v != v ? v : (v < T(0) ? T(0) : (v > T(1) ? T(1) : v));
}

// colorize(c, v, (lo, lo + span), cf, s): hue from c, brightness v; the
// operations of histogram.colorize and hsv_to_rgb in their order.  i % 6 is
// Python's (an i of 6 at h = 1 wraps to 0; a NaN hue converts as the plain
// version's .long() does on the same machine).
template <typename T>
__device__ __forceinline__ void colorize(T c, T v, T lo, T span,
                                                  T cf, T s, T* rgb) {
  const T h = clamp01((c - lo) * cf / span);
  const T fi = floor(h * T(6));
  const T f = h * T(6) - fi;
  const T p = v * (T(1) - s);
  const T q = v * (T(1) - s * f);
  const T t = v * (T(1) - s * (T(1) - f));
  const long long i6 = static_cast<long long>(fi) % 6;
  switch (i6 < 0 ? i6 + 6 : i6) {
    case 0: rgb[0] = v; rgb[1] = t; rgb[2] = p; break;
    case 1: rgb[0] = q; rgb[1] = v; rgb[2] = p; break;
    case 2: rgb[0] = p; rgb[1] = v; rgb[2] = t; break;
    case 3: rgb[0] = p; rgb[1] = q; rgb[2] = v; break;
    case 4: rgb[0] = t; rgb[1] = p; rgb[2] = v; break;
    default: rgb[0] = v; rgb[1] = p; rgb[2] = q; break;
  }
}

// The largest |rgb| colorize can give for brightness at most m, whatever
// the hue: every channel is v times 1, (1 - s), (1 - s f) or
// (1 - s (1 - f)) with 0 <= f < 1, and rounding is monotone, so
// m * max(1, |1 - s|) bounds them all.
template <typename T>
__device__ __forceinline__ T rgb_bound(T m, T s) {
  const T a = fabs(T(1) - s);
  return m * (a > T(1) ? a : T(1));
}

// The inputs of one plot's histograms that are the same for every ray.
template <typename T>
struct PlotAxes {
  T xlo, xspan, xbins, ylo, yspan, ybins, clo, cspan, cbins;
  T cf, s;  // colorFactor, colorSaturation
};

// Everything one ray adds to a plot: its bin on each axis (-1 outside), its
// weight |flux| (masked), its 2D weight w2d (masked) and its colour.
template <typename T>
struct PlotRay {
  int ix, iy, ic;
  T af, w2, rgb[3];
};

// runner.histogram_plot's arithmetic for one ray: the mask multiplies (a
// masked NaN stays NaN, as flux * fmask does), |flux| is the brightness.
template <typename T>
__device__ __forceinline__ PlotRay<T> plot_ray(
    T x, T y, T c, T flux, T w2d, bool mask, const PlotAxes<T>& a) {
  PlotRay<T> r;
  const T m = mask ? T(1) : T(0);
  r.af = fabs(flux * m);
  r.w2 = w2d * m;
  colorize(c, r.af, a.clo, a.cspan, a.cf, a.s, r.rgb);
  r.ix = axis_bin(x, a.xlo, a.xspan, a.xbins);
  r.iy = axis_bin(y, a.ylo, a.yspan, a.ybins);
  r.ic = axis_bin(c, a.clo, a.cspan, a.cbins);
  return r;
}

// ---------------------------------------------------------------------------
// Fixed point.  A launch adds n weights of magnitude at most m (finite) as
// integers w * 2^e rounded to nearest, e = 62 - ceil(log2(n m)) (n at least
// 2^34 for float32: scale_count): no partial sum can exceed 2^62 + n / 2
// < 2^63, and integer adds give the same bits in any order.  The one
// rounding is per weight, 2^-e / 2 <= n m 2^-63.
//
// A float32 weight far below m would round to 0 there (its unit is
// m 2^-28), and a bin that only such rays fill would come out empty where
// a float sum keeps it.  So a faint float32 weight, one below 2^17 units
// (about m 2^-11: a weight above it is rounded to 2^-18 of itself), also
// carries its rounding residual r = w 2^e - q (|r| <= 1/2 and |r 2^-e| <=
// |w|, exact in double) as a fine word at a scale of its sum's own: rint(r
// 2^(f - e)), f = fixed_exp(M, scale_count(n)) for M the largest faint |w|
// that enters that sum (one column of one bin; a pass before the sums takes
// it).  The fine sums stay within 2^62 + n / 2, a weight is rounded once
// more, by at most M 2^-29, and a sum that only faint rays enter keeps them
// to that, however faint they are against m (a float sum keeps them to its
// own ulp, 2^-24 of it).  The conversion combines the two sums in double
// and rounds once to float32.  Float64 weights keep the one word at their
// true count.
// Non-finite weights are carried apart as flags (kNaN, kPosInf, kNegInf).
// ---------------------------------------------------------------------------

// e for n weights bounded by m; 0 when every weight is zero; within
// +-1000 so that 2^e and 2^-e are finite doubles (a tighter e only costs
// bits of weights far below m)
__device__ __forceinline__ int fixed_exp(double m, long long n) {
  if (!(m > 0.0) || n <= 0) return 0;
  int pm, p;  // n m = f 2^(pm + p), f in [0.5, 1), without overflow
  const double f = frexp(frexp(m, &pm) * static_cast<double>(n), &p);
  const int e = 62 - (pm + p - (f == 0.5 ? 1 : 0));
  return e > 1000 ? 1000 : (e < -1000 ? -1000 : e);
}

// The count the scale of T weights is taken for.  A float32 weight's
// coarse word takes 28 bits (what it lacks, the fine word carries), so at
// most one add in 16 to a low word carries into device memory (add_low).
// A float64 sum takes the full 62 bits.
template <typename T>
__device__ __forceinline__ long long scale_count(long long n) {
  return sizeof(T) == 4 && n < (1LL << 34) ? (1LL << 34) : n;
}

// w * 2^e to the nearest integer (scale = 2^e, so the product is exact);
// w finite and |w| <= m
template <typename T>
__device__ __forceinline__ long long to_fixed(T w, double scale) {
  return __double2ll_rn(static_cast<double>(w) * scale);
}

// the rounding residual w 2^e - q of a faint float32 weight w whose word is
// q = to_fixed(w, scale), scale = 2^e (exact: both are doubles within 1/2
// of each other on the grid of w's last bit), 0 for a weight of 2^17 units
// or more
__device__ __forceinline__ double residual(float w, long long q,
                                           double scale) {
  const double u = static_cast<double>(w) * scale;
  return fabs(u) < 131072.0 ? u - static_cast<double>(q) : 0.0;
}

// the fine word of residual r (in units of 2^-e) at the fine exponent f:
// r 2^(f - e) to the nearest integer
__device__ __forceinline__ long long fine_fixed(double r, int f, int e) {
  return __double2ll_rn(r * ldexp(1.0, f - e));
}

// the sum back in T, rounded once: s to T, then times 2^-e (exact outside
// the subnormal range)
__device__ __forceinline__ float from_fixed(long long s, int e,
                                                     float) {
  return ldexpf(__ll2float_rn(s), -e);
}
__device__ __forceinline__ double from_fixed(long long s, int e,
                                                      double) {
  return ldexp(__ll2double_rn(s), -e);
}

// a float32 sum from its coarse sum s at exponent e and its fine sum g at
// exponent f: s 2^-e + g 2^-f in double, rounded once to float
__device__ __forceinline__ float from_fixed2(long long s, long long g, int e,
                                             int f) {
  return static_cast<float>(ldexp(__ll2double_rn(s), -e) +
                            ldexp(__ll2double_rn(g), -f));
}

enum : unsigned { kNaN = 1u, kPosInf = 2u, kNegInf = 4u };

// the flag of a non-finite weight, 0 for a finite one
template <typename T>
__device__ __forceinline__ unsigned nonfinite(T w) {
  return w != w ? kNaN : (isinf(w) ? (w > T(0) ? kPosInf : kNegInf) : 0u);
}

// what a float sum of the bin gives once non-finite weights entered it: NaN
// if a NaN did or both infinities did, else the infinity (order-free)
template <typename T>
__device__ __forceinline__ T with_flags(T v, unsigned f) {
  if ((f & kNaN) || (f & (kPosInf | kNegInf)) == (kPosInf | kNegInf))
    return T(NAN);
  if (f & kPosInf) return T(INFINITY);
  if (f & kNegInf) return -T(INFINITY);
  return v;
}

// q into a 64-bit sum kept in two places: its low 32-bit word in shared
// memory, where 32-bit adds are native and 64-bit ones are not, and the
// rest in device memory.  The add to the low word returns its old value,
// which tells whether it carried; the high half of q (floor(q / 2^32)) plus
// that carry is returned, for the device-memory sum to take times 2^32
// (zero for most adds of a 28-bit weight).  The device-memory sum plus the
// low word, unsigned, is then the exact sum modulo 2^64, in any order of
// the adds.
__device__ __forceinline__ long long add_low(unsigned* lo, long long q) {
  const unsigned l = static_cast<unsigned>(q);
  long long h = q >> 32;
  if (l != 0u) {
    const unsigned old = atomicAdd(lo, l);
    h += old + l < old;  // the carry out of the low word
  }
  return h;
}

// |w| where it is finite, else 0: what the scale pass takes the maximum of
template <typename T>
__device__ __forceinline__ T finite_abs(T w) {
  return isfinite(w) ? fabs(w) : T(0);
}

}  // namespace xhist
