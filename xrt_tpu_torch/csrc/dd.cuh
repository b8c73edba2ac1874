// Double-float ("double-double" style) arithmetic on float32 pairs, as
// helpers for the Kirchhoff kernels; those the preparation kernel uses
// (csrc/kirchhoff_prep.cuh) also for the host, where the CPU tests build
// them with g++ -ffp-contract=off.
//
// Op-for-op counterpart of xrt_tpu_torch/ops/dd.py (itself the port of the
// reference package's ops/dd.py): a value is (hi, lo) with value = hi + lo
// and |lo| <= ulp(hi)/2, ~48 bits of mantissa from f32 arithmetic.
//
// Exactness hazards, and what this file does about them:
//  * FMA contraction breaks the Dekker split c - (c - a) and the two-sum
//    error terms.  The kernels are built with --fmad=false, so every
//    a * b + c below stays a rounded multiply followed by a rounded add,
//    exactly as the plain PyTorch version computes it, unless it is
//    written as __fmaf_rn.
//  * two_prod takes its error term from one FMA: p = a * b and
//    e = fma(a, b, -p) give the same (p, e) bits as the plain version's
//    Dekker product (the exact error of a rounded product is unique) while
//    nothing overflows or underflows, in 2 instructions instead of 16.
//  * Round-half-to-even: jnp.round / torch.round, so rintf (not roundf).
//  * No --use_fast_math: sqrtf and 1.0f / x stay correctly rounded.
#pragma once

#define XDD_HD __host__ __device__ __forceinline__

namespace xdd {

struct dd {
  float h, l;
};

XDD_HD dd two_sum(float a, float b) {
  float s = a + b;
  float bb = s - a;
  float e = (a - (s - bb)) + (b - bb);
  return {s, e};
}

XDD_HD dd quick_two_sum(float a, float b) {
  float s = a + b;
  float e = b - (s - a);
  return {s, e};
}

XDD_HD void split(float a, float& hi, float& lo) {
  float c = 4097.0f * a;  // 2^12 + 1
  hi = c - (c - a);
  lo = a - hi;
}

XDD_HD dd two_prod(float a, float b) {
  float p = a * b;
#ifdef __CUDA_ARCH__
  float e = __fmaf_rn(a, b, -p);
#else
  float e = fmaf(a, b, -p);  // the host's correctly rounded FMA
#endif
  return {p, e};
}

XDD_HD dd add(dd a, dd b) {
  dd s = two_sum(a.h, b.h);
  float e = s.l + (a.l + b.l);
  return quick_two_sum(s.h, e);
}

XDD_HD dd sub(dd a, dd b) {
  return add(a, {-b.h, -b.l});
}

XDD_HD dd mul(dd a, dd b) {
  dd p = two_prod(a.h, b.h);
  float e = p.l + (a.h * b.l + a.l * b.h);
  return quick_two_sum(p.h, e);
}

XDD_HD dd sqr(dd a) {
  dd p = two_prod(a.h, a.h);
  float e = p.l + 2.0f * a.h * a.l;
  return quick_two_sum(p.h, e);
}

// dd + float
XDD_HD dd add_f(dd a, float b) {
  dd s = two_sum(a.h, b);
  float e = s.l + a.l;
  return quick_two_sum(s.h, e);
}

// dd * float
XDD_HD dd mul_f(dd a, float b) {
  dd p = two_prod(a.h, b);
  float e = p.l + a.l * b;
  return quick_two_sum(p.h, e);
}

// dd / dd by one Newton refinement of the f32 quotient
XDD_HD dd div(dd a, dd b) {
  float q1 = a.h / b.h;
  dd r = sub(a, mul_f(b, q1));
  float q2 = (r.h + r.l) / b.h;
  return quick_two_sum(q1, q2);
}

// the Dekker halves of a (each with at most 12 mantissa bits), for exact
// products against another pre-split factor
XDD_HD dd presplit(float a) {
  float hi, lo;
  split(a, hi, lo);
  return {hi, lo};
}

XDD_HD dd sqrt(dd a) {
  float s0 = sqrtf(a.h);
  if (a.h <= 0.0f) s0 = 0.0f;
  dd s2 = two_prod(s0, s0);
  dd r = sub(a, s2);
  float denom = (s0 == 0.0f) ? 1.0f : 2.0f * s0;
  float corr = (r.h + r.l) / denom;
  return quick_two_sum(s0, corr);
}

// frac(m) in [-0.5, 0.5] cycles for dd m = phase / (2 pi)
XDD_HD float frac_cycles(float mh, float ml) {
  float n = rintf(mh);
  float f1 = mh - n;  // exact
  float n2 = rintf(ml);
  float f2 = ml - n2;  // exact
  float c = f1 + f2;
  return c - rintf(c);
}

// 2 pi frac(m) in [-2 pi, 2 pi] radians for dd m = phase / (2 pi)
__device__ __forceinline__ float frac_two_pi(float mh, float ml) {
  const float TWO_PI_HI = 0x1.921fb6p+2f;   // f32(2 pi)
  const float TWO_PI_LO = -0x1.777a5cp-23f;  // f32(2 pi - TWO_PI_HI)
  float n = rintf(mh);
  float f1 = mh - n;
  float n2 = rintf(ml);
  float f2 = ml - n2;
  float f = f1 + f2;
  return TWO_PI_HI * f + TWO_PI_LO * f;
}

// (sin, cos) of 2 pi c for c in [-0.5, 0.5]: minimax polynomials of
// degree 11 / 10 (Horner; coefficients rounded to f32 like the plain
// version's Python scalars)
__device__ __forceinline__ void sincos_cycles(float c, float& s, float& co) {
  float c2 = c * c;
  float sv = static_cast<float>(-12.37227202917199);
  sv = sv * c2 + static_cast<float>(41.26979637356224);
  sv = sv * c2 + static_cast<float>(-76.59489967393306);
  sv = sv * c2 + static_cast<float>(81.59765524711817);
  sv = sv * c2 + static_cast<float>(-41.34148025958734);
  sv = sv * c2 + static_cast<float>(6.283183465409586);
  s = sv * c;
  float cv = static_cast<float>(-21.28277632550657);
  cv = cv * c2 + static_cast<float>(58.91242234401467);
  cv = cv * c2 + static_cast<float>(-85.29594600637849);
  cv = cv * c2 + static_cast<float>(64.93061147431378);
  cv = cv * c2 + static_cast<float>(-19.73903432200607);
  cv = cv * c2 + static_cast<float>(0.999999443415578);
  co = cv;
}

// The same polynomials with each Horner step one FMA, for the kernels'
// amplitude: within an ulp or two of sincos_cycles, not its bits (those
// are what the self-test holds against the plain version).
__device__ __forceinline__ void sincos_cycles_fma(float c, float& s,
                                                  float& co) {
  float c2 = c * c;
  float sv = static_cast<float>(-12.37227202917199);
  sv = __fmaf_rn(sv, c2, static_cast<float>(41.26979637356224));
  sv = __fmaf_rn(sv, c2, static_cast<float>(-76.59489967393306));
  sv = __fmaf_rn(sv, c2, static_cast<float>(81.59765524711817));
  sv = __fmaf_rn(sv, c2, static_cast<float>(-41.34148025958734));
  sv = __fmaf_rn(sv, c2, static_cast<float>(6.283183465409586));
  s = sv * c;
  float cv = static_cast<float>(-21.28277632550657);
  cv = __fmaf_rn(cv, c2, static_cast<float>(58.91242234401467));
  cv = __fmaf_rn(cv, c2, static_cast<float>(-85.29594600637849));
  cv = __fmaf_rn(cv, c2, static_cast<float>(64.93061147431378));
  cv = __fmaf_rn(cv, c2, static_cast<float>(-19.73903432200607));
  co = __fmaf_rn(cv, c2, static_cast<float>(0.999999443415578));
}

// 1 / (2 pi) as a dd constant
XDD_HD dd inv_two_pi() {
  return {0x1.45f306p-3f, 0x1.b93910p-28f};
}

}  // namespace xdd
