// The undulator's radiation integral, one ray at a time, for the device and
// the host: Undulator._integrate (sources/undulator.py) over one period in
// the far field, or over all Np periods when tapered or in the near field,
// with the same expressions in the rays' dtype T:
//  * the per-ray terms once (1 / gamma, 1 / gamma^2, w / wu, ww1, the
//    angles, A1m = 0.5 (dx^2 + dy^2), their products with K; in the near
//    field R0x, R0y and the carrier's sine and cosine);
//  * per node of nonzero weight and per copy of the node grid: the phase
//    (far field, taper) or its three wrapped pieces by angle addition (near
//    field), beta and beta', 1 - n.beta from regrouped small terms (never
//    1 - beta), and the s / p integrands times the node's weight;
//  * the sums Bs, Bp in double, whatever T is, and wu / gamma times them
//    rounded to T once.
// The node table (node_table in sources/undulator_integral.py) holds, for
// each node of nonzero weight, the rows of Row: its position tg in the
// period, its weight and the sines and cosines of its trajectory phase
// with and without the elliptic phase, made in double and rounded to T.
// A copy c of the grid adds the period's offset -(Np - 1) pi + 2 pi c to
// tg, as the plain path's node list does.  Nothing here touches memory but
// the table and the rays, so the CPU tests compile this header with g++
// -ffp-contract=off and a stub cuda_runtime.h and hold it to the plain
// loop (tests/test_torch_undulator_kernel.py).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define XUND_HD __host__ __device__ __forceinline__

namespace xund {

// far field (one period, the periodic factor outside), linear taper (all
// periods), near field at distance R0 (all periods)
enum Mode { FAR = 0, TAPER = 1, NEAR = 2 };

// The numbers of a call, in this order (sources/undulator_integral.py
// NUMBERS): Kx, Ky; the taper's alphaS = taper_val / E2WC; the near
// field's R0n = 2 pi R0 / L0 and (1 + Kx^2 / 2 + Ky^2 / 2) / 2; pi, 2 pi
enum Num { KX, KY, ALPHA_S, R0N, OMB, PI_, PI2_, NNUM };
// ... and the integers: the Mode, the copies of the node grid, the nodes
enum Int { MODE, NCOPIES, NNODES, NINT };
// the rows of the node table, each NNODES long
enum Row { TG, AG, SINX, COSX, SINXPH, COSXPH, SIN2X, SIN2XPH, NROW };

XUND_HD float xsqrt(float x) { return sqrtf(x); }
XUND_HD double xsqrt(double x) { return sqrt(x); }
XUND_HD float xtan(float x) { return tanf(x); }
XUND_HD double xtan(double x) { return tan(x); }
XUND_HD void xsincos(float x, float* s, float* c) { sincosf(x, s, c); }
XUND_HD void xsincos(double x, double* s, double* c) { sincos(x, s, c); }

template <typename T>
struct Params {
  int mode, ncopies, nnodes;
  // the source's numbers as the plain path's scalars meet a T tensor
  T Kx, Ky, nKx, nKy, Kx2, Ky2, alphaS, R0n, omb;
  double alphaS2, pi, pi2;
  const T* table;  // NROW x nnodes
};

template <typename T>
XUND_HD Params<T> make_params(const double* num, const int* ints,
                              const void* table) {
  Params<T> p;
  p.mode = ints[MODE];
  p.ncopies = ints[NCOPIES];
  p.nnodes = ints[NNODES];
  p.Kx = T(num[KX]);
  p.Ky = T(num[KY]);
  p.nKx = T(-num[KX]);
  p.nKy = T(-num[KY]);
  p.Kx2 = T(num[KX] * num[KX]);
  p.Ky2 = T(num[KY] * num[KY]);
  p.alphaS = T(num[ALPHA_S]);
  p.alphaS2 = 2 * num[ALPHA_S];
  p.R0n = T(num[R0N]);
  p.omb = T(num[OMB]);
  p.pi = num[PI_];
  p.pi2 = num[PI2_];
  p.table = static_cast<const T*>(table);
  return p;
}

// The offset of copy c of the node grid, as numpy forms it in double
template <typename T>
XUND_HD T copy_offset(const Params<T>& p, int c) {
  return p.ncopies > 1 ? T(-double(p.ncopies - 1) * p.pi + p.pi2 * double(c))
                       : T(0);
}

template <typename T>
struct Ray {
  T ww1, wwu, rg, rg2, dx, dy, dz, A1m;
  T wr, kdx, kdy, r8, kyr, nkxr, hrg;  // wwu rg, -Ky dx, Kx dy, rg / 8, ...
  T aw, aw2;                           // taper: alphaS / wu, 2 alphaS / wu
  T R0x, R0y, sz, cz, omb, betam;      // near field
  double scale;                        // wu / gamma
};

// The per-ray terms of the plain path, from ww1, w, wu, gamma and the
// angles of the ray in T
template <typename T, int MODE>
XUND_HD Ray<T> ray_terms(const Params<T>& p, T ww1, T w, T wu, T gamma,
                         T ddphi, T ddpsi) {
  Ray<T> r;
  const T revgamma = T(1) / gamma;
  r.ww1 = ww1;
  r.wwu = w / wu;
  r.rg = revgamma;
  r.rg2 = revgamma * revgamma;
  r.dx = ddphi;
  r.dy = ddpsi;
  r.dz = T(1) - T(0.5) * (ddphi * ddphi + ddpsi * ddpsi);
  r.A1m = T(0.5) * (ddphi * ddphi + ddpsi * ddpsi);
  r.wr = r.wwu * r.rg;
  r.kdx = p.nKy * ddphi;
  r.kdy = p.Kx * ddpsi;
  r.r8 = T(0.125) * r.rg;
  r.kyr = p.Ky * r.rg;
  r.nkxr = p.nKx * r.rg;
  r.hrg = T(0.5) * r.rg;
  r.aw = r.aw2 = r.R0x = r.R0y = r.sz = r.cz = r.omb = r.betam = T(0);
  if (MODE == TAPER) {
    r.aw = p.alphaS / wu;
    r.aw2 = T(p.alphaS2) / wu;
  }
  if (MODE == NEAR) {
    r.omb = p.omb * r.rg2;
    r.betam = T(1) - r.omb;
    r.R0x = xtan(ddphi) * p.R0n;
    r.R0y = xtan(ddpsi) * p.R0n;
    xsincos(r.wwu * p.R0n, &r.sz, &r.cz);
  }
  r.scale = double(wu * revgamma);
  return r;
}

struct Acc {
  double sr, si, pr, pi;  // Bs, Bp
};

// One node's term: the plain path's expressions at the node of position
// zloc (tg plus its copy's offset), weight ag and trajectory phase terms
template <typename T, int MODE>
XUND_HD void node_term(const Params<T>& p, const Ray<T>& r, T zloc, T ag,
                       T sinx, T cosx, T sinxph, T cosxph, T sin2x,
                       T sin2xph, Acc& a) {
  T er, ei, betax, betaPx, betaPz;
  T drx = T(0), dry = T(0), drz = T(0), dist = T(0);
  const T zt = p.Ky2 * sin2x + p.Kx2 * sin2xph;
  if (MODE == TAPER) {
    const T taperC = T(1) - r.aw * zloc;
    const T ucos =
        r.ww1 * zloc +
        r.wr * (r.kdx * (sinx + r.aw * (T(1) - cosx - zloc * sinx)) +
                r.kdy * sinx +
                r.r8 * (p.Kx2 * sin2xph +
                        p.Ky2 * (sin2x - r.aw2 * (zloc * zloc + cosx * cosx +
                                                  zloc * sin2x))));
    xsincos(ucos, &ei, &er);
    betax = taperC * r.kyr * cosx;
    betaPx = p.nKy * (p.alphaS * cosx + taperC * sinx);
    betaPz = r.hrg * (p.Ky2 * taperC *
                          (p.alphaS * (cosx * cosx) + taperC * sin2x) +
                      p.Kx2 * sin2xph);
  } else if (MODE == NEAR) {
    const T zterm = T(0.5) * zt * r.rg;
    drx = r.R0x - p.Ky * sinx * r.rg;
    dry = r.R0y - p.Kx * sinxph * r.rg;
    drz = p.R0n - (r.betam * zloc - T(0.25) * zterm * r.rg);
    dist = xsqrt(drx * drx + dry * dry + drz * drz);
    const T drs = T(0.5) * (drx * drx + dry * dry) / drz;
    T sinzloc, coszloc, sindrs, cosdrs;
    xsincos(r.wwu * zloc * r.omb, &sinzloc, &coszloc);
    xsincos(r.wwu * (drs + T(0.25) * zterm * r.rg), &sindrs, &cosdrs);
    er = -r.sz * sinzloc * cosdrs - r.sz * coszloc * sindrs -
         r.cz * sinzloc * sindrs + r.cz * coszloc * cosdrs;
    ei = -r.sz * sinzloc * sindrs + r.sz * coszloc * cosdrs +
         r.cz * sinzloc * cosdrs + r.cz * coszloc * sindrs;
    betax = r.kyr * cosx;
    betaPx = p.nKy * sinx;
    betaPz = r.hrg * zt;
  } else {
    const T ucos = r.ww1 * zloc + r.wr * (r.kdx * sinx + r.kdy * sinxph +
                                          r.r8 * zt);
    xsincos(ucos, &ei, &er);
    betax = r.kyr * cosx;
    betaPx = p.nKy * sinx;
    betaPz = r.hrg * zt;
  }
  const T betay = r.nkxr * cosxph;
  const T betaPy = p.Kx * sinxph;
  const T B1m = T(0.5) * (r.rg2 + betax * betax + betay * betay);
  T one_minus_nb, bnz, ndx, ndy, ndz;
  if (MODE == NEAR) {
    // the node's own direction dr / dist; 1 - dirz =
    // (drx^2 + dry^2) / (dist (dist + drz))
    const T t2 = (drx * drx + dry * dry) / (dist * (dist + drz));
    one_minus_nb = B1m + (T(1) - B1m) * t2 - (drx * betax + dry * betay) / dist;
    bnz = B1m - t2;
    ndx = drx / dist;
    ndy = dry / dist;
    ndz = drz / dist;
  } else {
    const T bx = r.dx - betax, by = r.dy - betay;
    one_minus_nb = T(0.5) * (r.rg2 + bx * bx + by * by) - r.A1m * B1m;
    bnz = B1m - r.A1m;
    ndx = r.dx;
    ndy = r.dy;
    ndz = r.dz;
  }
  const T rkrel = T(1) / one_minus_nb;
  const T f = ag * (rkrel * rkrel);
  er = er * f;
  ei = ei * f;
  const T bnx = ndx - betax;
  const T bny = ndy - betay;
  const T dirDotBetaP = ndx * betaPx + ndy * betaPy + ndz * betaPz;
  const T dirDotDmB = ndx * bnx + ndy * bny + ndz * bnz;
  const T s = bnx * dirDotBetaP - betaPx * dirDotDmB;
  const T q = bny * dirDotBetaP - betaPy * dirDotDmB;
  a.sr += double(er * s);
  a.si += double(ei * s);
  a.pr += double(er * q);
  a.pi += double(ei * q);
}

// The terms of m nodes of a table whose row k holds node j at
// tab[k * stride + j], for every copy of the grid
template <typename T, int MODE>
XUND_HD void tile_sum(const Params<T>& p, const Ray<T>& r, const T* tab,
                      int stride, int m, Acc& a) {
  for (int c = 0; c < p.ncopies; ++c) {
    const T off = copy_offset(p, c);
    for (int j = 0; j < m; ++j)
      node_term<T, MODE>(p, r, tab[TG * stride + j] + off,
                         tab[AG * stride + j], tab[SINX * stride + j],
                         tab[COSX * stride + j], tab[SINXPH * stride + j],
                         tab[COSXPH * stride + j], tab[SIN2X * stride + j],
                         tab[SIN2XPH * stride + j], a);
  }
}

template <typename T>
struct Rays {
  const T *ww1, *w, *wu, *gamma, *ddphi, *ddpsi;
  T *Is, *Ip;  // interleaved complex
  long long n;
};

// in: ww1, w, wu, gamma, ddphi, ddpsi; out: Is, Ip (interleaved complex)
template <typename T>
XUND_HD Rays<T> make_rays(const void* const* in, void* const* out,
                          long long n) {
  const T* const* q = reinterpret_cast<const T* const*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
  return Rays<T>{q[0], q[1], q[2], q[3], q[4], q[5], o[0], o[1], n};
}

template <typename T, int MODE>
XUND_HD Ray<T> ray_at(const Params<T>& p, const Rays<T>& r, long long i) {
  return ray_terms<T, MODE>(p, r.ww1[i], r.w[i], r.wu[i], r.gamma[i],
                            r.ddphi[i], r.ddpsi[i]);
}

// Is, Ip of ray i: wu / gamma times the sums, rounded to T once
template <typename T>
XUND_HD void store(const Rays<T>& r, long long i, const Ray<T>& ray,
                   const Acc& a) {
  r.Is[2 * i] = T(ray.scale * a.sr);
  r.Is[2 * i + 1] = T(ray.scale * a.si);
  r.Ip[2 * i] = T(ray.scale * a.pr);
  r.Ip[2 * i + 1] = T(ray.scale * a.pi);
}

// Ray i with the table read in tiles of `tile` nodes, in the kernel's
// order (for the host)
template <typename T, int MODE>
XUND_HD void integrate_at(const Params<T>& p, const Rays<T>& r, long long i,
                          int tile) {
  const Ray<T> ray = ray_at<T, MODE>(p, r, i);
  Acc a{0.0, 0.0, 0.0, 0.0};
  for (int t0 = 0; t0 < p.nnodes; t0 += tile) {
    const int m = p.nnodes - t0 < tile ? p.nnodes - t0 : tile;
    tile_sum<T, MODE>(p, ray, p.table + t0, p.nnodes, m, a);
  }
  store(r, i, ray, a);
}

}  // namespace xund
