// Kernel B1: the recentred-phase Kirchhoff double sum, float32.
//
// Replaces the TPU kernel xrt_tpu/ops/kirchhoff.py:565
// _kirchhoff_pallas_recentred (pallas_call at :802), reached from
// kirchhoff_integral_pallas (:823).  Plain version beside it:
// xrt_tpu_torch/ops/kirchhoff.py kirchhoff_integral_recentred.
//
// What it computes: for every destination d and source s the propagator
// U = pre * e^{2 pi i c} of _recentred_core, from per-point double-float
// precomputations (recentre_kirchhoff_inputs: csrc/kirchhoff_prep.cu when
// nothing requires grad, else plain PyTorch on the card), and the ten f32
// sums over s: Es and Ep (re/im) and the a/b/c direction integrals
// (re/im).  Variants: 0 mono, 1 narrowband, 2 poly.
//
// What bounds it: the SMs' f32 instruction rate.  A mono pair needs 116
// operations (one reciprocal, no transcendental: the phase uses the
// sincos_cycles polynomials; chip_smoke.py counts them term by term), ~100
// SASS instructions once the amplitude is fused; the bytes are
// O(Nd + Ns).
//
// Design: the forward skeleton csrc/kirchhoff_fwd.cuh with this pair
// function: two destinations a thread, the sources' keys as 16-byte
// broadcast loads from a double-buffered shared-memory stage, a grid of
// destination tiles x source groups, and the groups' partial sums added in
// a fixed order in double by a second kernel.  Every 'accumulate' value
// of the TPU kernel ('mxu', 'mxu2', 'mxu-fast', 'mxu32', 'vpu') runs here
// as the per-pair f32 contraction ('vpu'): a 3xTF32 mma.sync contraction
// of the ten sums, which are ~27% of a pair's instructions, was measured
// 22-26% slower on an H100 (PERF.md, ROADMAP A12).
//
// FMA policy: the build has --fmad=false (see dd.cuh), so nothing is fused
// unless written so.  Fused with __fmaf_rn: the obliquity numerator num,
// pre, the direction numerators ax/ay/az, the weight g, the sin/cos
// polynomials (sincos_cycles_fma) and the ten sums: sums of products with
// no error-free transform in them.  Unfused: the phase (the offsets, wp2,
// 1/A, x, the delta series, phic, lo2, the rintf reductions and the poly
// variant's two-product residual): c is a difference of large cycle
// counts, where one rounding more moves the result, and it keeps the bits
// that the adjoint (csrc/kirchhoff_recentred_bwd.cu) recomputes.  1/A is
// __frcp_rn, the correctly rounded reciprocal: the bits of 1.0f / A.
#include <cuda_runtime.h>

#include "dd.cuh"
#include "kirchhoff_fwd.cuh"

namespace {

// source key rows (ops/kirchhoff.py _SRC_KEYS_COMMON + variant keys)
enum Src {
  TSX, TSY, TSZ, AS_, LVH, PHIS, KW, KWNL, K2, LNS, CNS, N0, N1, N2,
  ESR, ESI, EPR, EPI, SER, SEI, KAH, KAL, DKS = 22, KA1 = 22, KA2 = 23
};
// destination key rows: mono/narrowband, and poly
enum Dst { TDX, TDY, TDZ, AD, PDH, PHID = 5, PDL = 5, PD1 = 6, PD2 = 7 };
// the ten scalars (ops/kirchhoff.py _PARAM_KEYS), read from a small device
// buffer (the TPU kernel kept them in SMEM): they are computed on the card
// and never travel to the host
enum Par { CX, CY, CZ, LX, LY, LZ, RHO, INVR0, KAPH, KAPL };

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// V: 0 mono, 1 narrowband, 2 poly
template <int V>
struct RecentredPair {
  static constexpr int NDK = V == 2 ? 8 : 6;
  static constexpr int NSK = V == 0 ? 20 : (V == 1 ? 23 : 24);
  static constexpr int NP = 10;

  __device__ __forceinline__ static void eval(const float* d, const float* s,
                                              const float* p, float* acc) {
    // ---- the phase, unfused ----
    const float tx = d[TDX] - s[TSX];
    const float ty = d[TDY] - s[TSY];
    const float tz = d[TDZ] - s[TSZ];
    const float wp2 = tx * tx + ty * ty + tz * tz + p[RHO];
    const float A = d[AD] + s[AS_];
    const float rinv = __frcp_rn(A);
    const float x = wp2 * rinv * rinv;
    const float poly = 0.5f - x * (0.125f - x * (0.0625f - 0.0390625f * x));
    const float delta = wp2 * rinv * poly;
    float m;
    if constexpr (V == 0) {
      const float phic = p[KAPH] * delta;
      const float lo2 = d[PHID] + s[PHIS] + p[KAPL] * delta;
      m = lo2 - rintf(lo2) + (phic - rintf(phic));
    } else if constexpr (V == 1) {
      const float phic = s[KAH] * delta;
      const float u = s[DKS] * d[PDH];
      const float lo2 = d[PHID] + s[PHIS] + (u - rintf(u)) + s[KAL] * delta;
      m = lo2 - rintf(lo2) + (phic - rintf(phic));
    } else {
      // exact kappa_s * (L.u)_d via the pre-split two-product
      const float kah = s[KAH], kal = s[KAL], ka1 = s[KA1], ka2 = s[KA2];
      const float pp = kah * d[PDH];
      const float e = ((ka1 * d[PD1] - pp) + ka1 * d[PD2] + ka2 * d[PD1]) +
                      ka2 * d[PD2];
      const float phic = kah * delta;
      const float lo2 = e + kal * d[PDH] + kah * d[PDL] + s[PHIS] +
                        kal * delta;
      const float c0 = xdd::frac_cycles(pp, lo2);
      m = c0 + (phic - rintf(phic));
    }
    const float c = m - rintf(m);
    float sph, cph;
    xdd::sincos_cycles_fma(c, sph, cph);

    // ---- the amplitude and the ten sums, fused ----
    const float lw = d[PDH] - s[LVH];
    const float num = fma_(lw, s[LNS], fma_(tz, s[N2], fma_(ty, s[N1],
                                                            fma_(tx, s[N0],
                                                                 s[CNS]))));
    const float pre = fma_(num * rinv, s[KW], s[KWNL]) * rinv;
    const float U_r = -pre * sph;
    const float U_i = pre * cph;
    const float ax = fma_(lw, p[LX], p[CX] + tx);
    const float ay = fma_(lw, p[LY], p[CY] + ty);
    const float az = fma_(lw, p[LZ], p[CZ] + tz);
    const float f = s[K2] * rinv;
    const float ser = s[SER], sei = s[SEI];
    const float g_r = f * fma_(ser, U_r, -sei * U_i);
    const float g_i = f * fma_(ser, U_i, sei * U_r);
    const float esr = s[ESR], esi = s[ESI], epr = s[EPR], epi = s[EPI];
    acc[0] = fma_(esr, U_r, fma_(-esi, U_i, acc[0]));
    acc[1] = fma_(esr, U_i, fma_(esi, U_r, acc[1]));
    acc[2] = fma_(epr, U_r, fma_(-epi, U_i, acc[2]));
    acc[3] = fma_(epr, U_i, fma_(epi, U_r, acc[3]));
    acc[4] = fma_(g_r, ax, acc[4]);
    acc[5] = fma_(g_i, ax, acc[5]);
    acc[6] = fma_(g_r, ay, acc[6]);
    acc[7] = fma_(g_i, ay, acc[7]);
    acc[8] = fma_(g_r, az, acc[8]);
    acc[9] = fma_(g_i, az, acc[9]);
  }
};

}  // namespace

// The pass.  dst: (ndkeys, nd) f32; src: (ns_pad, 4 * ceil(nskeys / 4))
// f32, the sources' keys as rows, ns_pad a multiple of 128 (zero rows past
// the last source); params: (10,) f32; grid and ngroup from
// ops/kirchhoff.py forward_grid; part: (ngroup, 10, nd) f32, the source
// groups' partial sums.  Returns cudaGetLastError() after the launch.
extern "C" int kirchhoff_recentred_launch(int variant, const float* dst,
                                          int nd, const float* src,
                                          int ns_pad, const float* params,
                                          int ngroup, float* part,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XRT_PASS(V)                                                       \
  return xfwd::launch<RecentredPair<V>>(dst, nd, src, ns_pad, params,     \
                                        ngroup, part, s)
  switch (variant) {
    case 0: XRT_PASS(0);
    case 1: XRT_PASS(1);
    case 2: XRT_PASS(2);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XRT_PASS
}

// The ten sums out (10, nd) of the partials part (ngroup, 10, nd), added
// in a fixed order in double.  Returns cudaGetLastError() after the launch.
extern "C" int kirchhoff_recentred_reduce(const float* part, int ngroup,
                                          int nd, float* out, void* stream) {
  return xfwd::launch_reduce(part, ngroup, nd, out,
                             static_cast<cudaStream_t>(stream));
}
