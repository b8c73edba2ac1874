// The physics at the surface of a thick Bragg-reflecting crystal on a
// toroid, one ray at a time, for the device and the host: OE._interact as
// it runs for the toroid crystals (JohannToroid, JohanssonToroid,
// GeneralBraggToroid, DicedJohannToroid, DicedJohanssonToroid) with a
// CrystalFcc / CrystalDiamond in 'Bragg reflected' geometry of infinite
// thickness, step for step:
//  1. the normals of local_n (the facet of a diced element by
//     toroid_search.cuh's facet_centre, in the rays' dtype; the facet
//     centre's normal; DicedJohanssonToroid's delta normal);
//  2. beamInDotNormal (clamped), theta, beamInDotSurfaceNormal;
//  3. the grating vector of the Bragg planes with the sign of the mean
//     incidence (launch A's sum), then _grating_deflection with order 1
//     and sig -1;
//  4. rollAngle = roll + atan2(nsx, nsz) and the coherency matrix rotated
//     by -rollAngle;
//  5. f1 + i f2 at E (Element.get_f1f2: ops/interp.fast_interp);
//  6. F0, Fhkl, Fhkl_ (CrystalFcc, CrystalDiamond), chi0, chih, chih_ and
//     thetaB (get_sin_Bragg_angle's clamp);
//  7. the thick-Bragg two_beam_amplitude for s and p;
//  8. the NaN guards of the amplitudes, Jss, Jpp, Jsp.
// Everything past the facet index is computed in double, whatever the
// rays' dtype T, and rounded to T once at the outputs: the float64 PyTorch
// path's operations in its order (--fmad=false), with the guards of the
// PyTorch path rounded to T (1e-100 is 0 in float32, 1 - 1e-16 is 1).
// Nothing here touches memory but the element's f1 / f2 table, so the CPU
// tests compile this header with g++ -ffp-contract=off and a stub
// cuda_runtime.h and hold it to the float64 PyTorch path
// (tests/test_torch_interact_kernel.py).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "toroid_search.cuh"

#define XCI_HD __host__ __device__ __forceinline__

namespace xci {

// The Bragg-plane normal of the element (or of its facet centre): the
// surface's own (JohannToroid), the Johansson planes' (JohanssonToroid), or
// a toroid of other radii (GeneralBraggToroid)
enum Center { JOHANN = 0, JOHANSSON = 1, GENERAL = 2 };

// The numbers of a call, in this order (oes/crystal_interact.py NUMBERS):
// the radii (Rm2 = Rm ** 2 as Python forms it; RmB, RsB the Bragg planes'
// of GeneralBraggToroid), the facets' sizes and gaps, the element's roll,
// the constants CH and 2 pi, and the crystal's d, chiToF, factDW, Z, f0 at
// 0.5 / d, the factor of F0 (2 for the diamond structure, else 1) and the
// complex factor dj of Fhkl (CrystalDiamond; 1 for fcc)
enum Num {
  RM, RS, RM2, RMB, RSB, RMB2, DX, DX_GAP, DY, DY_GAP, ROLL, CH, PI2, D,
  CHI_TO_F, FACT_DW, Z, F0, F0_FACTOR, DJ_RE, DJ_IM, NNUM
};
// ... and the integers: the Center, diced (0/1), the delta normal (0/1),
// Fhkl allowed (0: zero, h, k, l of mixed parity) and the table's length
enum Int { CENTER, DICED, DELTA, ALLOWED, NTAB, NINT };

struct Cx {
  double re, im;
};
XCI_HD Cx operator+(Cx a, Cx b) { return {a.re + b.re, a.im + b.im}; }
XCI_HD Cx operator-(Cx a, Cx b) { return {a.re - b.re, a.im - b.im}; }
XCI_HD Cx operator*(Cx a, Cx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
// a complex times a real tensor: PyTorch multiplies by (r + 0i), which
// for finite values is each part times r
XCI_HD Cx scale(Cx a, double r) { return {a.re * r, a.im * r}; }
XCI_HD Cx conj(Cx a) { return {a.re, -a.im}; }
XCI_HD double cabs(Cx a) { return hypot(a.re, a.im); }
// PyTorch's complex division (c10::complex, numpy's scaled form)
XCI_HD Cx cdiv(Cx x, Cx y) {
  const double a = x.re, b = x.im, c = y.re, d = y.im;
  if (fabs(c) >= fabs(d)) {
    if (c == 0.0 && d == 0.0) return {a / fabs(c), b / fabs(d)};
    const double rat = d / c;
    const double scl = 1.0 / (c + d * rat);
    return {(a + b * rat) * scl, (b - a * rat) * scl};
  }
  const double rat = c / d;
  const double scl = 1.0 / (d + c * rat);
  return {(a * rat + b) * scl, (b * rat - a) * scl};
}
// the principal square root (C99 csqrt's branch cut)
XCI_HD Cx csqrt(Cx z) {
  if (z.re == 0.0 && z.im == 0.0) return {0.0, z.im};
  const double t = sqrt((fabs(z.re) + hypot(z.re, z.im)) * 0.5);
  if (z.re >= 0.0) return {t, z.im / (2.0 * t)};
  return {fabs(z.im) / (2.0 * t), copysign(t, z.im)};
}
// torch.clamp(v, lo, hi): a NaN stays NaN
XCI_HD double clampv(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
struct Params {
  int center, diced, delta, allowed, ntab;
  T xStep, yStep;  // the facets' steps, sums in T as _facets forms them
  double Rm, Rs, Rm2, RmB, RsB, RmB2, roll, ch, pi2, d, chiToF, factDW, Z,
      f0, F0factor;
  Cx dj;
  double rootMin;           // oes/bragg._root's 1e-30 in T
  double ampMin;            // two_beam_amplitude's 1e-100 in T
  double sinMin, sinMax;    // get_sin_Bragg_angle's clamp in T
  const double *tabE, *tabF1, *tabF2;  // the element's table in double
};

// The parameters of a call from its host arrays num (Num) and ints (Int)
// and the table's three device pointers tab (E, f1, f2)
template <typename T>
XCI_HD Params<T> make_params(const double* num, const int* ints,
                             const void* const* tab) {
  Params<T> p;
  p.center = ints[CENTER];
  p.diced = ints[DICED];
  p.delta = ints[DELTA];
  p.allowed = ints[ALLOWED];
  p.ntab = ints[NTAB];
  p.xStep = T(num[DX]) + T(num[DX_GAP]);
  p.yStep = T(num[DY]) + T(num[DY_GAP]);
  p.Rm = num[RM];
  p.Rs = num[RS];
  p.Rm2 = num[RM2];
  p.RmB = num[RMB];
  p.RsB = num[RSB];
  p.RmB2 = num[RMB2];
  p.roll = num[ROLL];
  p.ch = num[CH];
  p.pi2 = num[PI2];
  p.d = num[D];
  p.chiToF = num[CHI_TO_F];
  p.factDW = num[FACT_DW];
  p.Z = num[Z];
  p.f0 = num[F0];
  p.F0factor = num[F0_FACTOR];
  p.dj = Cx{num[DJ_RE], num[DJ_IM]};
  p.rootMin = double(T(1e-30));
  p.ampMin = double(T(1e-100));
  p.sinMin = double(T(-1.0 + 1e-16));
  p.sinMax = double(T(1.0 - 1e-16));
  p.tabE = static_cast<const double*>(tab[0]);
  p.tabF1 = static_cast<const double*>(tab[1]);
  p.tabF2 = static_cast<const double*>(tab[2]);
  return p;
}

// ---- 1. the normals -------------------------------------------------------
struct Normals {
  double nb[3];  // the Bragg planes'
  double ns[3];  // the surface's
  bool asym;     // local_n gave six components
};

// sqrt(max(v, 1e-30)) (oes/bragg._root)
template <typename T>
XCI_HD double root(const Params<T>& p, double v) {
  return sqrt(v < p.rootMin ? p.rootMin : v);
}

// JohannToroid.local_n_toroid(x, y, Rm, Rs, False)
template <typename T>
XCI_HD void toroid_n(const Params<T>& p, double Rm, double Rs, double Rm2,
                     double x, double y, double* n) {
  const double ry = root(p, Rm2 - y * y);
  const double b = -y / Rm;
  const double c = ry / Rm;
  const double r = Rs - (Rm - ry);
  const double cosangle = root(p, r * r - x * x) / r;
  const double sinangle = -x / r;
  n[0] = cosangle * 0.0 + sinangle * c;
  n[1] = b;
  n[2] = -sinangle * 0.0 + cosangle * c;
}

// the Bragg-plane normal of JohanssonToroid.local_n
template <typename T>
XCI_HD void johansson_n(const Params<T>& p, double x, double y, double* n) {
  const double ry = root(p, p.Rm2 - y * y);
  const double b0 = -y;
  const double c0 = ry + p.Rm;
  const double norm = sqrt(b0 * b0 + c0 * c0);
  const double b = b0 / norm;
  const double c = c0 / norm;
  const double r = p.Rs - (p.Rm - ry);
  const double cosangle = root(p, r * r - x * x) / r;
  const double sinangle = -x / r;
  n[0] = cosangle * 0.0 + sinangle * c;
  n[1] = b;
  n[2] = -sinangle * 0.0 + cosangle * c;
}

// local_n(x, y): the element's own, or _DicedMethods.local_n's facet
// centre normal with DicedJohanssonToroid's delta normal added to the
// surface normal (to both where local_n has three components)
template <typename T>
XCI_HD Normals normals(const Params<T>& p, T x, T y) {
  double px = x, py = y, fy = 0.0;
  if (p.diced) {
    const T cx = xts::facet_centre(x, p.xStep);
    const T cy = xts::facet_centre(y, p.yStep);
    px = cx;
    py = cy;
    fy = T(y - cy);
  }
  Normals n;
  toroid_n(p, p.Rm, p.Rs, p.Rm2, px, py, n.ns);
  n.asym = p.center != JOHANN;
  if (p.center == JOHANSSON) {
    johansson_n(p, px, py, n.nb);
  } else if (p.center == GENERAL) {
    toroid_n(p, p.RmB, p.RsB, p.RmB2, px, py, n.nb);
  }
  if (p.diced && p.delta) {
    const double b = -fy / p.Rm;
    const double norm = sqrt(b * b + 1.0);
    const double n1 = n.ns[2] + 1.0 / norm;
    const double n2 = n.ns[1] + b / norm;
    const double n3 = n.ns[0];
    const double nn = sqrt(n1 * n1 + n2 * n2 + n3 * n3);
    n.ns[0] = n3 / nn;
    n.ns[1] = n2 / nn;
    n.ns[2] = n1 / nn;
  }
  if (!n.asym)
    for (int q = 0; q < 3; ++q) n.nb[q] = n.ns[q];
  return n;
}

XCI_HD double dot3(double ax, double ay, double az, const double* n) {
  return ax * n[0] + ay * n[1] + az * n[2];
}

// launch A's term: clamp(dot(k, n_bragg), -1, 1), every ray
template <typename T>
XCI_HD double incidence(const Params<T>& p, T x, T y, double a, double b,
                        double c) {
  const Normals n = normals(p, x, y);
  return clampv(dot3(a, b, c, n.nb), -1.0, 1.0);
}

// ---- 5.-7. the crystal -------------------------------------------------
// Element.get_f1f2 at E: ops/interp.fast_interp (ends clamped, the index
// searchsorted(right=True) - 1 clamped to [0, n - 2])
template <typename T>
XCI_HD Cx f1f2(const Params<T>& p, double E) {
  const int n = p.ntab;
  if (n == 1) return {p.tabF1[0], p.tabF2[0]};
  const double xf = clampv(E, p.tabE[0], p.tabE[n - 1]);
  if (xf >= p.tabE[n - 1]) return {p.tabF1[n - 1], p.tabF2[n - 1]};
  int lo = 0, hi = n;  // the first entry above xf
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p.tabE[mid] <= xf)
      lo = mid + 1;
    else
      hi = mid;
  }
  int i = lo - 1;
  i = i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
  const double x0 = p.tabE[i], x1 = p.tabE[i + 1];
  const double w = (xf - x0) / (x1 - x0);
  return {p.tabF1[i] + w * (p.tabF1[i + 1] - p.tabF1[i]),
          p.tabF2[i] + w * (p.tabF2[i + 1] - p.tabF2[i])};
}

struct Amplitudes {
  Cx s, p;
};

// _CrystalMethods.get_amplitude(E, beamInDotNormal=bIn, beamOutDotNormal=
// bOut, beamInDotHNormal=bInH) with t None: get_F_chi, get_Bragg_angle and
// two_beam_amplitude's thick-Bragg branch for polFactor 1 and cos 2 thetaB
template <typename T>
XCI_HD Amplitudes amplitudes(const Params<T>& p, double E, double bIn,
                             double bOut, double bInH) {
  const Cx anom = f1f2(p, E);
  // CrystalFcc.get_structure_factor, then CrystalDiamond's factors
  Cx F0 = scale(scale(Cx{p.Z + anom.re, anom.im}, 4.0), p.factDW);
  Cx Fh = p.allowed ? scale(scale(Cx{p.f0 + anom.re, anom.im}, 4.0),
                            p.factDW)
                    : Cx{0.0, 0.0};
  F0 = scale(F0, p.F0factor);
  const Cx Fh_ = Fh * conj(p.dj);
  Fh = Fh * p.dj;
  const double waveLength = p.ch / E;
  const double chiL2 = p.chiToF * (waveLength * waveLength);
  const Cx chi0 = scale(conj(F0), chiL2);
  const Cx chih = scale(conj(Fh), chiL2);
  const Cx chih_ = scale(conj(Fh_), chiL2);
  const double thetaB =
      asin(clampv(p.ch / ((2.0 * p.d) * E), p.sinMin, p.sinMax));
  // two_beam_amplitude
  const double k = p.pi2 / waveLength;
  const double k0s = -bIn * k;
  double kHs = -bOut * k;
  const bool kHs0 = kHs == 0.0;
  kHs = kHs0 ? 1.0 : kHs;
  const double b = kHs0 ? -1.0 : k0s / kHs;
  const double HoverK = waveLength / p.d;
  const double ob = 1.0 / b - 1.0;
  const Cx alpha{HoverK * (0.5 * HoverK - fabs(bInH)) + (chi0.re / 2) * ob,
                 (chi0.im / 2) * ob};
  const double rootb = sqrt(fabs(b));
  const Cx aa = alpha * alpha;
  Amplitudes out;
  for (int q = 0; q < 2; ++q) {
    const double pol = q == 0 ? 1.0 : cos(2.0 * thetaB);
    const Cx t = scale(chih, pol * pol) * chih_;
    const Cx delta = csqrt(aa + cdiv(t, Cx{b, 0.0}));
    Cx apd = alpha + delta;
    Cx amd = alpha - delta;
    if (amd.re == 0.0 && amd.im == 0.0) amd = Cx{p.ampMin, 0.0};
    if (apd.re == 0.0 && apd.im == 0.0) apd = Cx{p.ampMin, 0.0};
    const Cx num = scale(chih, pol);
    Cx ra = cdiv(num, apd);
    const Cx rb = cdiv(num, amd);
    const double absa = cabs(ra);
    if (absa != absa || cabs(rb) < absa) ra = rb;
    ra = cdiv(ra, Cx{rootb, 0.0});
    if (q == 0)
      out.s = ra;
    else
      out.p = ra;
  }
  return out;
}

// ---- the ray ------------------------------------------------------------
struct Out {
  double a, b, c, theta, Jss, Jpp;
  Cx Jsp;
  double rollAngle;
};

// OE._interact for one ray that has state 1 (good) or not; sg is the
// grating vector's sign (the incidences' sum < 0: 1, else -1, NaN too).
// A ray that is not good gets its rollAngle only.
template <typename T>
XCI_HD Out interact_ray(const Params<T>& p, T x, T y, double a, double b,
                        double c, double E, double Jss, double Jpp, Cx Jsp,
                        bool good, double sg) {
  Out o;
  const Normals n = normals(p, x, y);
  const double* nb = n.nb;
  const double* ns = n.ns;
  o.rollAngle = p.roll + atan2(ns[0], ns[2]);
  if (!good) return o;
  // 2. the incidence
  const double bIn = clampv(dot3(a, b, c, nb), -1.0, 1.0);
  o.theta = acos(bIn) - 1.5707963267948966;  // math.pi / 2
  const double bInS = n.asym ? dot3(a, b, c, ns) : bIn;
  // 3. the grating vector and _grating_deflection (order 1, sig -1)
  const double nDotNs = nb[0] * ns[0] + nb[1] * ns[1] + nb[2] * ns[2];
  const double wHd = 1.0 / (p.d * 1e-7);
  const double gx = ((nb[0] - nDotNs * ns[0]) * wHd) * sg;
  const double gy = ((nb[1] - nDotNs * ns[1]) * wHd) * sg;
  const double gz = ((nb[2] - nDotNs * ns[2]) * wHd) * sg;
  const double bInG = a * gx + b * gy + c * gz;
  const double G2 = gx * gx + gy * gy + gz * gz;
  const double oL = (p.ch / E) * 1e-7;
  const double u = (bInS * bInS - (2.0 * bInG) * oL) - G2 * (oL * oL);
  const double dn = bInS + -sqrt(fabs(u));
  const double ao = (a - ns[0] * dn) + gx * oL;
  const double bo = (b - ns[1] * dn) + gy * oL;
  const double co = (c - ns[2] * dn) + gz * oL;
  const double norm = sqrt(ao * ao + bo * bo + co * co);
  o.a = ao / norm;
  o.b = bo / norm;
  o.c = co / norm;
  // 4. the coherency matrix in the surface's s / p frame
  const double cr = cos(-o.rollAngle), sr = sin(-o.rollAngle);
  const double c2 = cr * cr, s2 = sr * sr, cs = cr * sr;
  const double JssL = (Jss * c2 + Jpp * s2) + (2.0 * Jsp.re) * cs;
  const double JppL = (Jss * s2 + Jpp * c2) - (2.0 * Jsp.re) * cs;
  const Cx JspL{(Jpp - Jss) * cs + Jsp.re * (c2 - s2), Jsp.im};
  // 5.-8. the amplitudes and the coherency matrix after the reflection
  const double bOutS = dot3(o.a, o.b, o.c, ns);
  Amplitudes r = amplitudes(p, E, bInS, bOutS, bIn);
  const double as = cabs(r.s), ap = cabs(r.p);
  if (as != as) r.s = Cx{0.0, 0.0};
  if (ap != ap) r.p = Cx{0.0, 0.0};
  o.Jss = (JssL * r.s.re) * r.s.re + (JssL * r.s.im) * r.s.im;
  o.Jpp = (JppL * r.p.re) * r.p.re + (JppL * r.p.im) * r.p.im;
  o.Jsp = (JspL * r.s) * conj(r.p);
  return o;
}

// ---- the rays in memory ------------------------------------------------
template <typename T>
struct Rays {
  const T *x, *y, *a, *b, *c, *E, *Jss, *Jpp, *Jsp, *theta;  // theta: null
  const bool* good;
  T *oa, *ob, *oc, *otheta, *oJss, *oJpp, *oJsp, *oroll;
  long long n;
};

// in: x, y, a, b, c, E, Jss, Jpp, Jsp (interleaved complex), theta (null:
// zeros); good: state == 1; out: a, b, c, theta, Jss, Jpp, Jsp
// (interleaved), rollAngle
template <typename T>
XCI_HD Rays<T> make_rays(const void* const* in, const void* good,
                         void* const* out, long long n) {
  const T* const* q = reinterpret_cast<const T* const*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
  return Rays<T>{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9],
                 static_cast<const bool*>(good),
                 o[0], o[1], o[2], o[3], o[4], o[5], o[6], o[7], n};
}

// launch A's term of ray i
template <typename T>
XCI_HD double incidence_at(const Params<T>& p, const Rays<T>& r,
                           long long i) {
  return incidence(p, r.x[i], r.y[i], double(r.a[i]), double(r.b[i]),
                   double(r.c[i]));
}

// launch B's work on ray i given the incidences' sum: every output, those
// of a ray that is not good its inputs (theta 0 where there is none)
template <typename T>
XCI_HD void interact_at(const Params<T>& p, const Rays<T>& r, long long i,
                        double sum) {
  const double sg = sum < 0.0 ? 1.0 : -1.0;
  const bool good = r.good[i];
  const T a = r.a[i], b = r.b[i], c = r.c[i], Jss = r.Jss[i],
          Jpp = r.Jpp[i];
  const T JspRe = r.Jsp[2 * i], JspIm = r.Jsp[2 * i + 1];
  const Out o = interact_ray(p, r.x[i], r.y[i], double(a), double(b),
                             double(c), double(r.E[i]), double(Jss),
                             double(Jpp), Cx{double(JspRe), double(JspIm)},
                             good, sg);
  r.oroll[i] = T(o.rollAngle);
  if (good) {
    r.oa[i] = T(o.a);
    r.ob[i] = T(o.b);
    r.oc[i] = T(o.c);
    r.otheta[i] = T(o.theta);
    r.oJss[i] = T(o.Jss);
    r.oJpp[i] = T(o.Jpp);
    r.oJsp[2 * i] = T(o.Jsp.re);
    r.oJsp[2 * i + 1] = T(o.Jsp.im);
  } else {
    r.oa[i] = a;
    r.ob[i] = b;
    r.oc[i] = c;
    r.otheta[i] = r.theta == nullptr ? T(0) : r.theta[i];
    r.oJss[i] = Jss;
    r.oJpp[i] = Jpp;
    r.oJsp[2 * i] = JspRe;
    r.oJsp[2 * i + 1] = JspIm;
  }
}

}  // namespace xci
