// The per-point preparation of the forward Kirchhoff kernels B1 and B2,
// for the device and the host: ops/kirchhoff.py recentre_kirchhoff_inputs
// (the recentred scheme: 0 mono, 1 narrowband, 2 poly) and ddphase_inputs
// (the per-pair double-float scheme: 3 'fast', 4 'exact'), operation for
// operation, with the keys written where B1 / B2 read them: a destination's
// column of D (NDK, nd) and a source's row of (ns_pad, 4 ceil(NSK / 4)),
// zeros past the last key (ops/kirchhoff.py forward_sources).
//
// Nothing here needs the device: the launches are in kirchhoff_prep.cu, so
// the CPU tests compile this header with g++ -ffp-contract=off and a stub
// cuda_runtime.h and hold it, given the same six means, to the plain
// version bit for bit (tests/test_torch_prep_kernel.py).  The build has
// --fmad=false: every expression is the plain version's operations in its
// order, with Python numbers rounded to float first, as PyTorch rounds a
// scalar operand.  The six recentring means are sums in double in the
// fixed order of centre_sums below, rounded to float and times the float
// reciprocal of the count: the plain version's means on a card, whose
// double sums (in torch's order) round to the same float but where a sum
// lies within its double rounding of a float tie.  (On the CPU the plain
// version sums in float32, as the reference package does.)
#pragma once
#include <cuda_runtime.h>

#include "dd.cuh"

#define XKP_HD __host__ __device__ __forceinline__

namespace xkp {

using xdd::dd;

enum Variant { MONO, NARROWBAND, POLY, FAST, EXACT };

// the inputs, per point: the destinations' (hi, lo) positions, then the
// sources' positions, fields (re, im), k (hi, lo), normal, n . direction
// and weights
enum In {
  XDH, XDL, YDH, YDL, ZDH, ZDL,
  XSH, XSL, YSH, YSL, ZSH, ZSL, ESR, ESI, EPR, EPI, KH, KL, N0, N1, N2, NL,
  W, NIN
};

// each input's first element and its stride in floats (0: one value for
// every point); a null pointer reads as zero
struct Inputs {
  const float* p[NIN];
  long long s[NIN];
};

XKP_HD float at(const Inputs& in, int k, long long i) {
  return in.p[k] == nullptr ? 0.0f : in.p[k][i * in.s[k]];
}

// the centre buffer: the ten scalars that B1 reads (ops/kirchhoff.py
// _PARAM_KEYS; the kappas zero but for mono), then the double-float
// scalars the points need
enum Cen {
  CX, CY, CZ, LX, LY, LZ, RHO, INVR0, KAPH, KAPL,
  D0X, D0Y, D0Z, S0X, S0Y, S0Z, LXH, LXL, LYH, LYL, LZH, LZL, R0H, R0L,
  HALFR0, K0H, K0L, NCEN
};

// f32 keys of a destination and of a source (the kernels' NDK and NSK)
XKP_HD constexpr int ndk(int v) { return v == POLY ? 8 : 6; }
XKP_HD constexpr int nsk(int v) {
  return v == NARROWBAND ? 23 : (v == POLY ? 24 : 20);
}
XKP_HD constexpr int width(int v) { return (nsk(v) + 3) / 4 * 4; }

// 1 / (4 pi) as the plain version's Python number rounded to float
XKP_HD float inv_four_pi() {
  return static_cast<float>(1.0 / (4 * 3.141592653589793));
}

// ---- the centre: the six means and the call's scalars -----------------

// threads a block of either launch
constexpr int BLOCK = 256;
// the centre launch's blocks: one for every POINTS_A_THREAD x BLOCK points
// of the larger cloud, at most MAX_BLOCKS (the partials buffer holds
// 6 x MAX_BLOCKS doubles)
constexpr int POINTS_A_THREAD = 8;
constexpr int MAX_BLOCKS = 160;

XKP_HD long long centre_blocks(long long nd, long long ns) {
  const long long n = nd > ns ? nd : ns;
  const long long b = (n + BLOCK * POINTS_A_THREAD - 1) /
                      (BLOCK * POINTS_A_THREAD);
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

// The six sums (xd, yd, zd over the nd destinations; xs, ys, zs over the
// ns sources; hi parts) of the points first, first + step, ... in double,
// in that order: one thread's share of the centre launch.
XKP_HD void centre_sums(const Inputs& in, long long nd, long long ns,
                        long long first, long long step, double* acc) {
  for (int q = 0; q < 6; ++q) acc[q] = 0.0;
  for (long long i = first; i < nd; i += step) {
    acc[0] += at(in, XDH, i);
    acc[1] += at(in, YDH, i);
    acc[2] += at(in, ZDH, i);
  }
  for (long long i = first; i < ns; i += step) {
    acc[3] += at(in, XSH, i);
    acc[4] += at(in, YSH, i);
    acc[5] += at(in, ZSH, i);
  }
}

// the mean of n points from their sum: the sum rounded to float, times
// the float reciprocal of the count (the plain mean_h)
XKP_HD float mean_of(double sum, long long n) {
  return static_cast<float>(sum) *
         static_cast<float>(1.0 / static_cast<double>(n));
}

// The call's scalars into cen (NCEN floats) from the six means (D0, then
// S0) and the first source's k: C = D0 - S0, R0 = |C|, rho, L = C / R0 in
// double-float, the ten scalars P, half R0 and kappa_0 = k_0 / (2 pi).
XKP_HD void centre(const float* mean, float k0h, float k0l, int variant,
                   float* cen) {
  dd C[3], L[3];
  for (int i = 0; i < 3; ++i) C[i] = xdd::two_sum(mean[i], -mean[3 + i]);
  dd c2 = xdd::sqr(C[0]);
  c2 = xdd::add(c2, xdd::sqr(C[1]));
  c2 = xdd::add(c2, xdd::sqr(C[2]));
  const dd R0 = xdd::sqrt(c2);
  const dd rho = xdd::sub(c2, xdd::sqr(R0));
  for (int i = 0; i < 3; ++i) L[i] = xdd::div(C[i], R0);
  const dd ka0 = xdd::mul({k0h, k0l}, xdd::inv_two_pi());
  for (int i = 0; i < 3; ++i) {
    cen[CX + i] = C[i].h + C[i].l;
    cen[LX + i] = L[i].h + L[i].l;
    cen[D0X + i] = mean[i];
    cen[S0X + i] = mean[3 + i];
    cen[LXH + 2 * i] = L[i].h;
    cen[LXL + 2 * i] = L[i].l;
  }
  cen[RHO] = rho.h + rho.l;
  cen[INVR0] = 1.0f / (R0.h + R0.l);
  cen[KAPH] = variant == MONO ? ka0.h : 0.0f;
  cen[KAPL] = variant == MONO ? ka0.l : 0.0f;
  cen[R0H] = R0.h;
  cen[R0L] = R0.l;
  cen[HALFR0] = 0.5f * (R0.h + R0.l);
  cen[K0H] = ka0.h;
  cen[K0L] = ka0.l;
}

// ---- the points ---------------------------------------------------------

// L . w in double-float
XKP_HD dd ldot(const dd* L, const dd* w) {
  dd m = xdd::mul(L[0], w[0]);
  m = xdd::add(m, xdd::mul(L[1], w[1]));
  return xdd::add(m, xdd::mul(L[2], w[2]));
}

// the transverse offsets w - (L . w) L, each rounded to float
XKP_HD void transverse(const dd* w, dd p, const dd* L, float* t) {
  for (int i = 0; i < 3; ++i) {
    const dd d = xdd::sub(w[i], xdd::mul(p, L[i]));
    t[i] = d.h + d.l;
  }
}

XKP_HD void centre_l(const float* cen, dd* L) {
  for (int i = 0; i < 3; ++i) L[i] = {cen[LXH + 2 * i], cen[LXL + 2 * i]};
}

// destination i's NDK keys, in the kernels' order (stride nd apart in D)
template <int V>
XKP_HD void dst_keys(const Inputs& in, const float* cen, long long i,
                     float* d) {
  if constexpr (V == FAST || V == EXACT) {
    for (int q = 0; q < 6; ++q) d[q] = at(in, XDH + q, i);
    return;
  }
  dd L[3], u[3];
  centre_l(cen, L);
  for (int q = 0; q < 3; ++q)
    u[q] = xdd::add_f({at(in, XDH + 2 * q, i), at(in, XDL + 2 * q, i)},
                      -cen[D0X + q]);
  const dd pd = ldot(L, u);
  transverse(u, pd, L, d);
  d[3] = cen[HALFR0] + (pd.h + pd.l);
  d[4] = pd.h;
  if constexpr (V == POLY) {
    const dd s = xdd::presplit(pd.h);
    d[5] = pd.l;
    d[6] = s.h;
    d[7] = s.l;
  } else {
    const dd ka0 = {cen[K0H], cen[K0L]};
    const dd md = xdd::mul_f(ka0, pd.h);
    const float mdl = md.l + ka0.h * pd.l;
    d[5] = xdd::frac_cycles(md.h, mdl);
  }
}

// source j's NSK keys, in the kernels' order, then zeros to width(V)
template <int V>
XKP_HD void src_keys(const Inputs& in, const float* cen, long long j,
                     float* s) {
  const float kh = at(in, KH, j), kl = at(in, KL, j);
  const float kw = kh * at(in, W, j) * inv_four_pi();
  const float kwnl = kw * at(in, NL, j);
  const float k2 = kh * kh * inv_four_pi();
  const float n0 = at(in, N0, j), n1 = at(in, N1, j), n2 = at(in, N2, j);
  const float esr = at(in, ESR, j), esi = at(in, ESI, j);
  const float epr = at(in, EPR, j), epi = at(in, EPI, j);
  for (int q = nsk(V); q < width(V); ++q) s[q] = 0.0f;
  if constexpr (V == FAST || V == EXACT) {
    for (int q = 0; q < 6; ++q) s[q] = at(in, XSH + q, j);
    const dd kp = V == FAST ? xdd::mul({kh, kl}, xdd::inv_two_pi())
                            : dd{kh, kl};
    const float rest[14] = {kp.h, kp.l, kwnl, kw, k2, esr, esi, epr, epi,
                            esr + epr, esi + epi, n0, n1, n2};
    for (int q = 0; q < 14; ++q) s[6 + q] = rest[q];
    return;
  }
  dd L[3], v[3];
  centre_l(cen, L);
  for (int q = 0; q < 3; ++q)
    v[q] = xdd::add_f({at(in, XSH + 2 * q, j), at(in, XSL + 2 * q, j)},
                      -cen[S0X + q]);
  const dd lv = ldot(L, v);
  transverse(v, lv, L, s);
  const dd ka = xdd::mul({kh, kl}, xdd::inv_two_pi());
  dd q = xdd::add_f({-lv.h, -lv.l}, cen[R0H]);
  q = xdd::add_f(q, cen[R0L]);
  const dd m = xdd::mul(ka, q);
  s[3] = cen[HALFR0] - (lv.h + lv.l);
  s[4] = lv.h;
  s[5] = xdd::frac_cycles(m.h, m.l);
  s[6] = kw;
  s[7] = kwnl;
  s[8] = k2;
  s[9] = cen[LX] * n0 + cen[LY] * n1 + cen[LZ] * n2;
  s[10] = cen[CX] * n0 + cen[CY] * n1 + cen[CZ] * n2;
  s[11] = n0;
  s[12] = n1;
  s[13] = n2;
  s[14] = esr;
  s[15] = esi;
  s[16] = epr;
  s[17] = epi;
  s[18] = esr + epr;
  s[19] = esi + epi;
  if constexpr (V == NARROWBAND) {
    s[20] = ka.h;
    s[21] = ka.l;
    s[22] = (ka.h - cen[K0H]) + (ka.l - cen[K0L]);
  } else if constexpr (V == POLY) {
    const dd sp = xdd::presplit(ka.h);
    s[20] = ka.h;
    s[21] = ka.l;
    s[22] = sp.h;
    s[23] = sp.l;
  }
}

}  // namespace xkp
