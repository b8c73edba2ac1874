// Kernel B3 (per-pair double-float phase): the adjoint of the Kirchhoff
// double sum of kernel B2, float32.
//
// Replaces the backward of the TPU package's custom VJP,
// xrt_tpu/ops/kirchhoff.py:1141 _kirchhoff_pallas_diff (backward
// _kirchhoff_bwd_blocked, :1076: autodiff of the XLA formulation in blocks)
// for phase_mode 'fast' (variant 0) and 'exact' (variant 1).  Plain version
// beside it: xrt_tpu_torch/ops/kirchhoff.py kirchhoff_bwd_blocked.
//
// What it computes: given the cotangents G (10, Nd) of the ten sums of
// kernel B2 (csrc/kirchhoff_ddphase.cu), the cotangents of its destination
// keys (6 rows over Nd) and source keys (20 rows over Ns).  Each pair is
// recomputed with the forward's operations; nothing per pair was saved.
//
// Derivative conventions (those of autodiff through the plain version): the
// error terms of the error-free transforms (the low word of two_sum,
// two_prod, quick_two_sum, the Dekker split) have derivative zero, which is
// what op-by-op autodiff gives them up to rounding; so the hi and lo keys
// of a coordinate get the same cotangent, and the cotangent of a double-
// float result is that of its high word.  rintf has zero derivative; the
// sincos_cycles pair differentiates as (2 pi cos, -2 pi sin), cosf / sinf
// as (-sin, cos).
//
// What bounds it: f32 instruction issue.  One pair needs at least 351
// operations ('fast') or 391 ('exact': forward without its sums, reverse
// sweep, 20 sums; chip_smoke.py counts them term by term).  Bytes are
// O(Nd + Ns).
//
// Design: the one-pass skeleton of csrc/kirchhoff_bwd.cuh with this pair
// function: a thread owns a source (17 distinct cotangent rows), each pair
// is evaluated once, and the three distinct destination rows of two
// destinations at a time are summed over the warp by one transpose-reduce.
//
// FMA policy: built with --fmad=false (see dd.cuh).  The recomputed
// distance and phase are the forward's double-float code, unfused: their
// error-free transforms (two_sum, two_prod's Dekker split) are exact only
// without contraction.  The amplitude part (the obliquity dot product, h)
// and the reverse sweep are written with __fmaf_rn.
#include <cuda_runtime.h>

#include "dd.cuh"
#include "kirchhoff_bwd.cuh"

namespace {

constexpr float TWO_PI = 6.283185307179586f;

// source key rows (ops/kirchhoff.py _DD_SRC_KEYS)
enum Src {
  XSH, XSL, YSH, YSL, ZSH, ZSL, KP0, KP1, KWNL, KW, K2, ESR, ESI, EPR, EPI,
  SER, SEI, N0, N1, N2
};
// distinct source cotangent rows: the three coordinates (hi and lo share),
// then the keys from KP0 on, each at its key row less three
enum Row { RX, RY, RZ };
__host__ __device__ constexpr int R(int key) { return key - 3; }

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// V: 0 'fast', 1 'exact'
template <int V>
struct DDPair {
  static constexpr int NDK = 6;
  static constexpr int NSK = 20;
  static constexpr int RD = 3;   // x, y, z: hi and lo share
  static constexpr int RS = 17;
  static constexpr int NPA = 0;
  static constexpr int NP = 0;

  __device__ static int dst_row(int k) { return k >> 1; }
  __device__ static int src_row(int k) { return k < KP0 ? k >> 1 : R(k); }

  __device__ __forceinline__ static void eval(const float* d, const float* G,
                                              const float* s, const float*,
                                              float* sp, float* dv) {
    // ---- the forward pair, as in kirchhoff_ddphase.cu ----
    const xdd::dd dx = xdd::sub({d[0], d[1]}, {s[XSH], s[XSL]});
    const xdd::dd dy = xdd::sub({d[2], d[3]}, {s[YSH], s[YSL]});
    const xdd::dd dz = xdd::sub({d[4], d[5]}, {s[ZSH], s[ZSL]});
    const float kp0 = s[KP0], kp1 = s[KP1];
    float sph, cph, rinv;
    // kept for the reverse sweep
    float s0, corr, resid = 0.0f, denom = 1.0f;
    xdd::dd ka{0.0f, 0.0f}, r{0.0f, 0.0f};
    if constexpr (V == 0) {
      const xdd::dd p1 = xdd::two_prod(dx.h, dx.h);
      const xdd::dd p2 = xdd::two_prod(dy.h, dy.h);
      const xdd::dd p3 = xdd::two_prod(dz.h, dz.h);
      const xdd::dd s1 = xdd::two_sum(p1.h, p2.h);
      const xdd::dd s2 = xdd::two_sum(s1.h, p3.h);
      const float lo = s1.l + s2.l + p1.l + p2.l + p3.l +
                       2.0f * (dx.h * dx.l + dy.h * dy.l + dz.h * dz.l);
      s0 = sqrtf(s2.h);
      rinv = 1.0f / s0;
      const xdd::dd qq = xdd::two_prod(s0, s0);
      resid = (s2.h - qq.h) + (lo - qq.l);
      corr = resid * (0.5f * rinv);
      const xdd::dd mm = xdd::two_prod(kp0, s0);
      const float ml = mm.l + kp0 * corr + kp1 * s0;
      const float cyc = xdd::frac_cycles(mm.h, ml);
      xdd::sincos_cycles(cyc, sph, cph);
    } else {
      const xdd::dd r2 =
          xdd::add(xdd::add(xdd::sqr(dx), xdd::sqr(dy)), xdd::sqr(dz));
      // xdd::sqrt, written out: the reverse sweep needs its parts
      s0 = sqrtf(r2.h);
      if (r2.h <= 0.0f) s0 = 0.0f;
      const xdd::dd sq = xdd::two_prod(s0, s0);
      const xdd::dd rr = xdd::sub(r2, sq);
      denom = (s0 == 0.0f) ? 1.0f : 2.0f * s0;
      corr = (rr.h + rr.l) / denom;
      r = xdd::quick_two_sum(s0, corr);
      ka = xdd::mul({kp0, kp1}, xdd::inv_two_pi());
      const xdd::dd mm = xdd::mul(ka, r);
      const float phase = xdd::frac_two_pi(mm.h, mm.l);
      rinv = 1.0f / r.h;
      cph = cosf(phase);
      sph = sinf(phase);
    }

    // ---- the amplitude, fused ----
    const float a = dx.h, b = dy.h, c = dz.h;
    const float dotn = fma_(a, s[N0], fma_(b, s[N1], c * s[N2]));
    const float rk = rinv * s[KW];
    const float inner = fma_(dotn, rk, s[KWNL]);
    const float pre = inner * rinv;
    const float U_r = -pre * sph;
    const float U_i = pre * cph;
    const float f = s[K2] * rinv;
    const float ser = s[SER], sei = s[SEI];
    const float hr = fma_(ser, U_r, -sei * U_i);
    const float hi = fma_(ser, U_i, sei * U_r);
    const float g_r = f * hr;
    const float g_i = f * hi;

    // ---- the reverse sweep, fused ----
    const float esr = s[ESR], esi = s[ESI], epr = s[EPR], epi = s[EPI];
    sp[R(ESR)] = fma_(G[0], U_r, fma_(G[1], U_i, sp[R(ESR)]));
    sp[R(ESI)] = fma_(G[1], U_r, fma_(-G[0], U_i, sp[R(ESI)]));
    sp[R(EPR)] = fma_(G[2], U_r, fma_(G[3], U_i, sp[R(EPR)]));
    sp[R(EPI)] = fma_(G[3], U_r, fma_(-G[2], U_i, sp[R(EPI)]));
    const float bgr = fma_(G[4], a, fma_(G[6], b, G[8] * c));
    const float bgi = fma_(G[5], a, fma_(G[7], b, G[9] * c));
    float ba = fma_(G[4], g_r, G[5] * g_i);
    float bb = fma_(G[6], g_r, G[7] * g_i);
    float bcz = fma_(G[8], g_r, G[9] * g_i);
    const float bf = fma_(bgr, hr, bgi * hi);
    const float bhr = bgr * f, bhi = bgi * f;
    sp[R(SER)] = fma_(bhr, U_r, fma_(bhi, U_i, sp[R(SER)]));
    sp[R(SEI)] = fma_(bhi, U_r, fma_(-bhr, U_i, sp[R(SEI)]));
    const float bUr = fma_(G[0], esr, fma_(G[1], esi, fma_(G[2], epr,
                      fma_(G[3], epi, fma_(bhr, ser, bhi * sei)))));
    const float bUi = fma_(G[1], esr, fma_(-G[0], esi, fma_(G[3], epr,
                      fma_(-G[2], epi, fma_(bhi, ser, -bhr * sei)))));
    sp[R(K2)] = fma_(bf, rinv, sp[R(K2)]);
    float brinv = bf * s[K2];
    // U = pre (-sin, cos)
    const float bpre = fma_(bUi, cph, -bUr * sph);
    // bsin cos - bcos sin, with bsin = -bUr pre, bcos = bUi pre
    const float bsc = -pre * fma_(bUr, cph, bUi * sph);
    // pre = (kwnl + dotn rinv kw) rinv
    const float binner = bpre * rinv;
    brinv = fma_(bpre, inner, brinv);
    sp[R(KWNL)] += binner;
    const float bdotn = binner * rk;
    const float brk = binner * dotn;
    brinv = fma_(brk, s[KW], brinv);
    sp[R(KW)] = fma_(brk, rinv, sp[R(KW)]);
    sp[R(N0)] = fma_(bdotn, a, sp[R(N0)]);
    sp[R(N1)] = fma_(bdotn, b, sp[R(N1)]);
    sp[R(N2)] = fma_(bdotn, c, sp[R(N2)]);
    ba = fma_(bdotn, s[N0], ba);
    bb = fma_(bdotn, s[N1], bb);
    bcz = fma_(bdotn, s[N2], bcz);
    float ox, oy, oz;
    if constexpr (V == 0) {
      // cyc = frac(kp0 s0 + (kp0 corr + kp1 s0)), r = s0 + corr
      const float bcyc = TWO_PI * bsc;
      sp[R(KP0)] += fma_(bcyc, corr, bcyc * s0);
      sp[R(KP1)] = fma_(bcyc, s0, sp[R(KP1)]);
      const float bcorr = bcyc * kp0;
      float bs0 = bcyc * (kp1 + kp0);
      const float bresid = bcorr * (0.5f * rinv);
      brinv = fma_(bcorr * resid, 0.5f, brinv);
      bs0 = fma_(-2.0f * bresid, s0, bs0);  // through q = s0 s0
      bs0 = fma_(-brinv, rinv * rinv, bs0);
      const float bs2 = fma_(bs0, 0.5f * rinv, bresid);
      const float b2 = 2.0f * bs2, l2 = 2.0f * bresid;
      ox = fma_(b2, dx.h, fma_(l2, dx.l, ba));
      oy = fma_(b2, dy.h, fma_(l2, dy.l, bb));
      oz = fma_(b2, dz.h, fma_(l2, dz.l, bcz));
    } else {
      // frac_two_pi: phase = 2 pi frac(m), in two parts
      const float bmh = fma_(0x1.921fb6p+2f, bsc, -0x1.777a5cp-23f * bsc);
      // m = ka r (double-float product): high word ka.h r.h + ka.h r.l +
      // ka.l r.h
      const float bkah = fma_(bmh, r.h, bmh * r.l);
      float brh = fma_(bmh, ka.h, bmh * ka.l);
      brh = fma_(-brinv, rinv * rinv, brh);
      const xdd::dd i2p = xdd::inv_two_pi();
      sp[R(KP0)] += fma_(bkah, i2p.h, bkah * i2p.l);
      sp[R(KP1)] = fma_(bkah, i2p.h, sp[R(KP1)]);
      // r = s0 + corr, corr = (r2 - s0 s0) / (2 s0), s0 = sqrt(r2)
      float bs0 = brh;
      const float bnum = brh / denom;
      if (s0 != 0.0f) bs0 += -2.0f * (brh * corr / denom);
      bs0 = fma_(-2.0f * bnum, s0, bs0);
      float br2 = bnum;
      if (s0 != 0.0f) br2 += bs0 * 0.5f / s0;
      const float b2 = 2.0f * br2;
      ox = fma_(b2, dx.h, fma_(b2, dx.l, ba));
      oy = fma_(b2, dy.h, fma_(b2, dy.l, bb));
      oz = fma_(b2, dz.h, fma_(b2, dz.l, bcz));
    }
    // the differences are destination minus source
    dv[RX] = ox;
    dv[RY] = oy;
    dv[RZ] = oz;
    sp[RX] -= ox;
    sp[RY] -= oy;
    sp[RZ] -= oz;
  }
};

}  // namespace

// The pass: as kirchhoff_recentred_bwd_launch, with dst (6, nd), src
// (20, ns_pad) and variant 0 'fast', 1 'exact'.  This scheme has no
// scalars: params and ppart are not read or written (pass null).
extern "C" int kirchhoff_ddphase_bwd_launch(
    int variant, const float* dst, int nd, const float* src, int ns_pad,
    const float* params, const float* gout, int nslab, int slab, int ngroup,
    float* dpart, float* spart, double* ppart, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return xbwd::launch_pass<DDPair<0>>(dst, nd, src, ns_pad, params, gout,
                                          nslab, slab, ngroup, dpart, spart,
                                          ppart, s);
    case 1:
      return xbwd::launch_pass<DDPair<1>>(dst, nd, src, ns_pad, params, gout,
                                          nslab, slab, ngroup, dpart, spart,
                                          ppart, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The partials of the pass summed into ddst (6, nd) and dsrc (20, ns_pad).
extern "C" int kirchhoff_ddphase_bwd_reduce(int variant, const float* dpart,
                                            int ngroup, int nd, float* ddst,
                                            const float* spart, int nslab,
                                            int ns_pad, float* dsrc,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return xbwd::launch_reduce<DDPair<0>>(dpart, ngroup, nd, ddst, spart,
                                            nslab, ns_pad, dsrc, s);
    case 1:
      return xbwd::launch_reduce<DDPair<1>>(dpart, ngroup, nd, ddst, spart,
                                            nslab, ns_pad, dsrc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
