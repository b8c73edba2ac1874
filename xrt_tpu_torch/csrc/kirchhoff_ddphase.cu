// Kernel B2: the Kirchhoff double sum with a per-pair double-float
// distance and phase, float32.
//
// Replaces the TPU kernel xrt_tpu/ops/kirchhoff.py:903
// _kirchhoff_pallas_ddphase (pallas_call at :1027).  Plain version beside
// it: xrt_tpu_torch/ops/kirchhoff.py kirchhoff_integral_dd.
//
// What it computes: for every (destination, source) pair the distance r in
// double-float from (hi, lo) coordinates and the phase k r reduced to
// cycles ('fast', variant 0: _phase_dd_fast with the sincos_cycles
// polynomials) or to radians ('exact', variant 1: the renormalized chain
// of _phase_dd with IEEE cosf/sinf); then the propagator and the same ten
// f32 sums as kernel B1.  It serves geometries outside the recentred
// envelope (short distances, long footprints).
//
// What bounds it: the SMs' f32 instruction rate: ~160 operations a pair in
// 'fast', ~185 with cosf/sinf in 'exact' (two_prod at 3; chip_smoke.py
// counts them term by term); the bytes are O(Nd + Ns).
//
// Design: the forward skeleton csrc/kirchhoff_fwd.cuh with this pair
// function, as B1: two destinations a thread holding their six (hi, lo)
// coordinates, 16-byte broadcast loads of the sources' twenty keys from a
// double-buffered stage, a grid of destination tiles x source groups, and
// the groups' partials added in a fixed order in double.  The per-source
// folding (kappa = k/2pi in dd, kw, kwnl, k2) is done before the launch, as
// the XLA code around the TPU kernel did: by csrc/kirchhoff_prep.cu when
// nothing requires grad, else in plain PyTorch.
//
// FMA policy: built with --fmad=false (see dd.cuh).  The distance and the
// phase are the plain version's double-float code, unfused: every two_sum
// and quick_two_sum must stay error-free, and two_prod takes its error
// term from one written FMA (the bits of the Dekker product).  Fused with
// __fmaf_rn: the obliquity dot product, pre, the weight g, the sin/cos
// polynomials ('fast': sincos_cycles_fma) and the ten sums.  1/r is
// __frcp_rn (the bits of 1.0f / r); 'exact' takes sin and cos from one
// sincosf, which gives the bits of sinf and cosf on the card.
#include <cuda_runtime.h>

#include "dd.cuh"
#include "kirchhoff_fwd.cuh"

namespace {

// source key rows (ops/kirchhoff.py _DD_SRC_KEYS)
enum Src {
  XSH, XSL, YSH, YSL, ZSH, ZSL, KP0, KP1, KWNL, KW, K2, ESR, ESI, EPR, EPI,
  SER, SEI, N0, N1, N2
};

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// V: 0 'fast', 1 'exact'
template <int V>
struct DDPair {
  static constexpr int NDK = 6;
  static constexpr int NSK = 20;
  static constexpr int NP = 0;

  __device__ __forceinline__ static void eval(const float* d, const float* s,
                                              const float*, float* acc) {
    // ---- the distance and the phase, unfused ----
    const xdd::dd dx = xdd::sub({d[0], d[1]}, {s[XSH], s[XSL]});
    const xdd::dd dy = xdd::sub({d[2], d[3]}, {s[YSH], s[YSL]});
    const xdd::dd dz = xdd::sub({d[4], d[5]}, {s[ZSH], s[ZSL]});
    const float kp0 = s[KP0], kp1 = s[KP1];
    float sph, cph, rinv;
    if constexpr (V == 0) {
      // _phase_dd_fast: kp = kappa = k / (2 pi) as dd
      const xdd::dd p1 = xdd::two_prod(dx.h, dx.h);
      const xdd::dd p2 = xdd::two_prod(dy.h, dy.h);
      const xdd::dd p3 = xdd::two_prod(dz.h, dz.h);
      const xdd::dd s1 = xdd::two_sum(p1.h, p2.h);
      const xdd::dd s2 = xdd::two_sum(s1.h, p3.h);
      const float lo = s1.l + s2.l + p1.l + p2.l + p3.l +
                       2.0f * (dx.h * dx.l + dy.h * dy.l + dz.h * dz.l);
      const float s0 = sqrtf(s2.h);
      rinv = __frcp_rn(s0);
      const xdd::dd qq = xdd::two_prod(s0, s0);
      const float corr = ((s2.h - qq.h) + (lo - qq.l)) * (0.5f * rinv);
      const xdd::dd mm = xdd::two_prod(kp0, s0);
      const float ml = mm.l + kp0 * corr + kp1 * s0;
      const float cyc = xdd::frac_cycles(mm.h, ml);
      xdd::sincos_cycles_fma(cyc, sph, cph);
    } else {
      // _phase_dd: kp = k as dd; radian phase, IEEE cos / sin
      const xdd::dd r2 =
          xdd::add(xdd::add(xdd::sqr(dx), xdd::sqr(dy)), xdd::sqr(dz));
      const xdd::dd r = xdd::sqrt(r2);
      const xdd::dd ka = xdd::mul({kp0, kp1}, xdd::inv_two_pi());
      const xdd::dd mm = xdd::mul(ka, r);
      const float phase = xdd::frac_two_pi(mm.h, mm.l);
      rinv = __frcp_rn(r.h);
      // the bits of cosf and sinf, which the adjoint recomputes (held by
      // chip_smoke.py phase 2), with one argument reduction
      sincosf(phase, &sph, &cph);
    }

    // ---- the amplitude and the ten sums, fused ----
    const float a = dx.h, b = dy.h, c = dz.h;
    const float dotn = fma_(a, s[N0], fma_(b, s[N1], c * s[N2]));
    const float pre = fma_(dotn, rinv * s[KW], s[KWNL]) * rinv;
    const float U_r = -pre * sph;
    const float U_i = pre * cph;
    const float f = s[K2] * rinv;
    const float ser = s[SER], sei = s[SEI];
    const float g_r = f * fma_(ser, U_r, -sei * U_i);
    const float g_i = f * fma_(ser, U_i, sei * U_r);
    const float esr = s[ESR], esi = s[ESI], epr = s[EPR], epi = s[EPI];
    acc[0] = fma_(esr, U_r, fma_(-esi, U_i, acc[0]));
    acc[1] = fma_(esr, U_i, fma_(esi, U_r, acc[1]));
    acc[2] = fma_(epr, U_r, fma_(-epi, U_i, acc[2]));
    acc[3] = fma_(epr, U_i, fma_(epi, U_r, acc[3]));
    acc[4] = fma_(g_r, a, acc[4]);
    acc[5] = fma_(g_i, a, acc[5]);
    acc[6] = fma_(g_r, b, acc[6]);
    acc[7] = fma_(g_i, b, acc[7]);
    acc[8] = fma_(g_r, c, acc[8]);
    acc[9] = fma_(g_i, c, acc[9]);
  }
};

}  // namespace

// The pass.  dst: (6, nd) f32 (x, y, z as hi/lo rows); src: (ns_pad, 20)
// f32, the sources' keys as rows, ns_pad a multiple of 128; grid and ngroup
// from ops/kirchhoff.py forward_grid; part: (ngroup, 10, nd) f32.  variant
// 0 'fast', 1 'exact'; params unused.  Returns cudaGetLastError() after
// the launch.
extern "C" int kirchhoff_ddphase_launch(int variant, const float* dst,
                                        int nd, const float* src,
                                        int ns_pad, const float* params,
                                        int ngroup, float* part,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return xfwd::launch<DDPair<0>>(dst, nd, src, ns_pad, params, ngroup,
                                     part, s);
    case 1:
      return xfwd::launch<DDPair<1>>(dst, nd, src, ns_pad, params, ngroup,
                                     part, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The ten sums out (10, nd) of the partials part (ngroup, 10, nd), added
// in a fixed order in double.  Returns cudaGetLastError() after the launch.
extern "C" int kirchhoff_ddphase_reduce(const float* part, int ngroup,
                                        int nd, float* out, void* stream) {
  return xfwd::launch_reduce(part, ngroup, nd, out,
                             static_cast<cudaStream_t>(stream));
}
