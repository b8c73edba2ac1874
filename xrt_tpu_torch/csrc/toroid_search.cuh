// The intersection search of one ray with a toroid crystal's surface, for
// the device and the host: oes/base.find_intersection_dz as OE._reflect_local
// runs it on JohannToroid.local_z (JohannToroid, JohanssonToroid,
// GeneralBraggToroid) and on _DicedMethods.local_z (DicedJohannToroid,
// DicedJohanssonToroid), step for step.  Both bracket ends, the lost / over
// / good classification, the Illinois loop with its bisection fallback and
// the halving of the stale end, then two Newton steps whose dF/dt is taken
// in forward mode: the surface is written once over a scalar type S and
// instantiated on T and on Dual<T>, so the derivative is the one
// torch.func.jvp takes (zero through the facet's rounding, the taken side
// of each select).  Nothing here touches memory, so the CPU tests compile
// this header with g++ -ffp-contract=off and a stub cuda_runtime.h and hold
// it against the PyTorch search (tests/test_torch_search_kernel.py).  The
// build has --fmad=false: every expression is the PyTorch version's
// operations in its order, with Python numbers rounded to T first, as
// PyTorch rounds a scalar operand.  One exception is the device's: PyTorch
// on a card divides by a Python number as a multiply by its reciprocal
// (Params::recip), on the CPU it divides.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define XTS_HD __host__ __device__ __forceinline__

namespace xts {

enum Kind { TOROID = 0, DICED_JOHANN = 1, DICED_JOHANSSON = 2 };
enum Flag { INACTIVE = 0, LOST = 1, OVER = 2, GOOD = 3 };

// One element's surface and the search's tolerances.  Rm2 = Rm ** 2 and
// RmRs = Rm - Rs are formed in double, as Python forms them, then rounded.
template <typename T>
struct Params {
  int kind, recip, max_iter;
  T Rm, Rs, Rm2, RmRs, invRm, xStep, yStep, inv, eps, rel;
};

template <typename T>
XTS_HD Params<T> make_params(int kind, int recip, int max_iter, double Rm,
                             double Rs, double Rm2, double RmRs, double dx,
                             double dxGap, double dy, double dyGap,
                             double inv, double eps, double rel) {
  Params<T> p;
  p.kind = kind;
  p.recip = recip;
  p.max_iter = max_iter;
  p.Rm = T(Rm);
  p.Rs = T(Rs);
  p.Rm2 = T(Rm2);
  p.RmRs = T(RmRs);
  p.invRm = T(1) / T(Rm);       // PyTorch's reciprocal, in T
  p.xStep = T(dx) + T(dxGap);   // _DicedMethods._facets: 0-dim sums in T
  p.yStep = T(dy) + T(dyGap);
  p.inv = T(inv);
  p.eps = T(eps);
  p.rel = T(rel);
  return p;
}

// ---- a value and its derivative along the ray ------------------------
template <typename T>
struct Dual {
  T v, d;
};

template <typename T> XTS_HD T val(T a) { return a; }
template <typename T> XTS_HD T val(Dual<T> a) { return a.v; }

template <typename T>
XTS_HD Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <typename T>
XTS_HD Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <typename T>
XTS_HD Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <typename T>
XTS_HD Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
XTS_HD Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - b.d * q) / b.v};
}
template <typename T>
XTS_HD Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.d}; }
template <typename T>
XTS_HD Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.d}; }
template <typename T>
XTS_HD Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }
template <typename T>
XTS_HD Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }
template <typename T>
XTS_HD Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <typename T>
XTS_HD Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }
template <typename T>
XTS_HD Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }

// sqrt(max(v, 1e-30)) (oes/bragg._root): torch.clamp keeps a NaN, and its
// derivative passes where v >= 1e-30
template <typename T> XTS_HD T root(T v) {
  return sqrt(v < T(1e-30) ? T(1e-30) : v);
}
template <typename T> XTS_HD Dual<T> root(Dual<T> a) {
  const T r = root(a.v);
  return {r, a.v >= T(1e-30) ? a.d / (T(2) * r) : T(0)};
}
template <typename T> XTS_HD T absv(T v) { return fabs(v); }
template <typename T> XTS_HD Dual<T> absv(Dual<T> a) {
  const T s = a.v > T(0) ? T(1) : (a.v < T(0) ? T(-1) : T(0));
  return {fabs(a.v), s * a.d};
}
// torch.where(torch.isnan(s), 0, s)
template <typename T> XTS_HD T nan_to_zero(T v) { return v != v ? T(0) : v; }
template <typename T> XTS_HD Dual<T> nan_to_zero(Dual<T> a) {
  return a.v != a.v ? Dual<T>{T(0), T(0)} : a;
}
// torch.minimum / torch.maximum: a NaN operand gives NaN
template <typename T> XTS_HD T nmin(T a, T b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
template <typename T> XTS_HD T nmax(T a, T b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}
// v / Rm with Rm a Python number, as PyTorch divides on the rays' device
template <typename T> XTS_HD T over_Rm(const Params<T>& p, T v) {
  return p.recip ? v * p.invRm : v / p.Rm;
}
template <typename T>
XTS_HD Dual<T> over_Rm(const Params<T>& p, Dual<T> v) {
  return p.recip ? v * p.invRm : Dual<T>{v.v / p.Rm, v.d / p.Rm};
}
// a constant in the scalar type of `like` (torch.zeros_like)
template <typename T> XTS_HD T lift(T v, T) { return v; }
template <typename T> XTS_HD Dual<T> lift(T v, Dual<T>) { return {v, T(0)}; }

// ---- the surfaces -------------------------------------------------------
// JohannToroid.local_z
template <typename T, typename S>
XTS_HD S toroid_z(const Params<T>& p, S x, S y) {
  const S z = p.RmRs - root(p.Rm2 - y * y);
  const S absz = absv(z);
  const S cosangle = root(z * z - x * x) / absz;
  const S sinangle = (-x) / absz;
  // rotate_y(zeros, z, cosangle, sinangle)[1]
  return ((-sinangle) * T(0) + cosangle * z) + p.Rs;
}

// The surface normal of JohannToroid.local_n_toroid(x, y, Rm, Rs, False):
// the last three components of both facet_center_n
template <typename T>
XTS_HD void toroid_n(const Params<T>& p, T x, T y, T& n0, T& n1, T& n2) {
  const T ry = root(p.Rm2 - y * y);
  const T b = over_Rm(p, -y);
  const T c = over_Rm(p, ry);
  const T r = p.Rs - (p.Rm - ry);
  const T cosangle = root(r * r - x * x) / r;
  const T sinangle = (-x) / r;
  n0 = cosangle * T(0) + sinangle * c;
  n1 = b;
  n2 = (-sinangle) * T(0) + cosangle * c;
}

// The current facet's centre (cx, cy), its height and normal there: a ray
// crosses few facets, so they are recomputed only when the facet changes.
// A NaN centre never compares equal and is recomputed every time.
template <typename T>
struct Facet {
  T cx, cy, cz, n0, n1, n2;
};

// _DicedMethods._facets: the facet centre of the coordinate v for facets
// of the step (size plus gap) in v's dtype, by round half to even of a true
// division, so that a point at a facet edge takes the PyTorch facet
template <typename T>
XTS_HD T facet_centre(T v, T step) {
  return rint(v / step) * step;
}

// _DicedMethods.local_z: the facet of (x, y), the centre height from
// JohannToroid.local_z, the plane of the centre normal, plus facet_delta_z
// (DicedJohanssonToroid: v^2 / 2 / Rm; DicedJohannToroid: 0)
template <typename T, typename S>
XTS_HD S diced_z(const Params<T>& p, Facet<T>& f, S x, S y) {
  const T cx = facet_centre(val(x), p.xStep);
  const T cy = facet_centre(val(y), p.yStep);
  if (!(cx == f.cx && cy == f.cy)) {
    f.cx = cx;
    f.cy = cy;
    f.cz = toroid_z<T, T>(p, cx, cy);
    toroid_n(p, cx, cy, f.n0, f.n1, f.n2);
  }
  const S fx = x - cx;
  const S fy = y - cy;
  const S dzf = p.kind == DICED_JOHANSSON ? over_Rm(p, (fy * fy) * T(0.5))
                                          : lift(T(0), fy);
  return f.cz + ((dzf - f.n0 * fx) - f.n1 * fy) / f.n2;
}

// The search function: (z - surf(x, y)) * inv with a NaN surface taken as 0
template <typename T, typename S>
XTS_HD S dz(const Params<T>& p, Facet<T>& f, S x, S y, S z) {
  const S surf = p.kind == TOROID ? toroid_z<T, S>(p, x, y)
                                  : diced_z<T, S>(p, f, x, y);
  return (z - nan_to_zero(surf)) * p.inv;
}

template <typename T>
struct Ray {
  T x, y, z, a, b, c;
};

template <typename T>
XTS_HD T F(const Params<T>& p, Facet<T>& f, const Ray<T>& r, T t) {
  return dz<T, T>(p, f, r.x + r.a * t, r.y + r.b * t, r.z + r.c * t);
}

// F and dF/dt: x + a t carries the tangent a, exactly as jvp's
template <typename T>
XTS_HD Dual<T> F_dual(const Params<T>& p, Facet<T>& f, const Ray<T>& r,
                      T t) {
  return dz<T, Dual<T>>(p, f, Dual<T>{r.x + r.a * t, r.a},
                        Dual<T>{r.y + r.b * t, r.b},
                        Dual<T>{r.z + r.c * t, r.c});
}

template <typename T>
struct Result {
  T t, t0;    // the result and the bracket's (before the Newton steps)
  int flag;   // Flag
  int iters;  // Illinois iterations this ray ran
};

// find_intersection_dz for one ray.  Inactive rays come back at tMax, lost
// rays (below the surface at tMin) at tMin, rays that never cross (over)
// at tMax.  newton = 0 leaves t at the bracket's result t0 (the caller
// takes the Newton steps on the autograd tape).
template <typename T>
XTS_HD Result<T> search_ray(const Params<T>& p, const Ray<T>& r, T tMin,
                            T tMax, bool active, bool newton) {
  Result<T> out{tMax, tMax, INACTIVE, 0};
  if (!active) return out;
  const T nan = T(NAN);
  Facet<T> f{nan, nan, nan, nan, nan, nan};
  T fa = F(p, f, r, tMin);
  T fb = F(p, f, r, tMax);
  if (fa <= T(0)) {
    out.flag = LOST;
    out.t = out.t0 = tMin;
    return out;
  }
  if (fb >= T(0)) {
    out.flag = OVER;
    return out;
  }
  // Illinois iteration on the bracket [ta, tb], f(ta) > 0 > f(tb)
  T ta = tMin, tb = tMax;
  T ts = T(0.5) * (ta + tb);
  bool act = true;
  int it = 0;
  for (; it < p.max_iter && act; ++it) {
    T denom = fb - fa;
    if (denom == T(0)) denom = T(1);
    T tn = ta - fa * (tb - ta) / denom;
    // fall back to bisection when the step leaves the bracket
    if (tn <= nmin(ta, tb) || tn >= nmax(ta, tb) || tn != tn)
      tn = T(0.5) * (ta + tb);
    const T fs = F(p, f, r, tn);
    if (fs <= T(0)) {  // root in [ta, tn]; halve the stale end's value
      fb = fs;
      fa = fa * T(0.5);
      tb = tn;
    } else {
      fa = fs;
      fb = fb * T(0.5);
      ta = tn;
    }
    ts = tn;
    const T tol = p.eps + p.rel * (fabs(ta) + fabs(tb));
    act = fabs(fs) > p.eps && fabs(tb - ta) > tol;
  }
  out.flag = GOOD;
  out.iters = it;
  out.t0 = out.t = ts;
  if (!newton) return out;
  T t = ts;
  for (int k = 0; k < 2; ++k) {
    const Dual<T> g = F_dual(p, f, r, t);
    const T d = fabs(g.d) < T(1e-12) ? T(1e-12) : g.d;
    t = t - g.v / d;
  }
  // keep the Newton result only where it stays within the bracket
  if (t >= tMin && t <= tMax && isfinite(t)) out.t = t;
  return out;
}

}  // namespace xts
