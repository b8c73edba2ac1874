// Kernel B3 (recentred): the adjoint of the recentred-phase Kirchhoff
// double sum, float32.
//
// Replaces the backward of the TPU package's custom VJP,
// xrt_tpu/ops/kirchhoff.py:1141 _kirchhoff_pallas_diff, whose backward
// (_kirchhoff_bwd_blocked, :1076) re-evaluates the XLA formulation under
// reverse-mode autodiff in blocks of 8192 destinations x 4096 sources.
// Plain version beside it: xrt_tpu_torch/ops/kirchhoff.py
// kirchhoff_bwd_blocked (autograd through the plain forward, blocked and
// checkpointed).
//
// What it computes: given the cotangents G (10, Nd) of the ten forward sums
// of kernel B1 (csrc/kirchhoff_recentred.cu), the cotangents of every input
// of that kernel: the destination keys (6 or 8 rows over Nd), the source
// keys (20, 23 or 24 rows over Ns) and the ten scalars.  Nothing per pair
// was saved by the forward: each pair's propagator is recomputed here with
// the forward's own operations, and its reverse sweep is contracted with G.
//
// Derivative conventions (those of autodiff through the plain version):
// rintf has zero derivative; frac_cycles passes both arguments through with
// derivative 1; the sincos_cycles pair differentiates as (2 pi cos,
// -2 pi sin) with the polynomial values standing for cos and sin (the
// polynomials' own derivatives differ from that by their approximation
// error, ~1e-6 relative); in the poly variant the pre-split halves ka1, ka2,
// pd1, pd2 are inputs of their own and share one cotangent, and the
// two-product residual e = ka*pd - p keeps its term-by-term derivative.
//
// What bounds it: f32 instruction issue.  One pair needs at least 259
// operations in the mono variant (the forward's 88 without its sums, 137
// for the reverse sweep, 34 sums; chip_smoke.py counts them term by term).
// Bytes are O(Nd + Ns).
//
// Design: one pass over the pairs (csrc/kirchhoff_bwd.cuh): a thread owns a
// source, destinations and their G are staged in shared memory, each pair
// is evaluated once with one full reverse sweep, its destination
// cotangents are summed over the warp by a transpose-reduce, and partial
// sums across blocks are added in a fixed order by a second kernel: no
// atomics, the same bits from run to run.  The scalars' sums ride along:
// per-block partials in double, which the wrapper sums in float64 (sums
// over all pairs of large terms with cancelling signs).
//
// FMA policy: the build has --fmad=false (see dd.cuh), so nothing is fused
// unless written so.  The recomputed phase (offsets, wp2, 1/A, the delta
// series, the rintf reductions, frac_cycles, sincos_cycles) keeps the
// forward kernel's unfused operations, so c has B1's bits: the phase is a
// difference of large cycle counts, where one rounding more moves the
// result.  The amplitude part (num, inner, h) and the whole reverse sweep
// are sums of products with no error-free transform in them: they are
// written with __fmaf_rn, and each source cotangent that is a product is
// fused into its running sum.
#include <cuda_runtime.h>

#include "dd.cuh"
#include "kirchhoff_bwd.cuh"

namespace {

constexpr int NPARAM = 10;
constexpr float TWO_PI = 6.283185307179586f;

// source key rows (ops/kirchhoff.py _SRC_KEYS_COMMON + variant keys)
enum Src {
  TSX, TSY, TSZ, AS_, LVH, PHIS, KW, KWNL, K2, LNS, CNS, N0, N1, N2,
  ESR, ESI, EPR, EPI, SER, SEI, KAH, KAL, DKS = 22, KA1 = 22, KA2 = 23
};
// destination key rows: mono/narrowband, and poly
enum Dst { TDX, TDY, TDZ, AD, PDH, PHID = 5, PDL = 5, PD1 = 6, PD2 = 7 };
// scalar rows (ops/kirchhoff.py _PARAM_KEYS)
enum Par { CX, CY, CZ, LX, LY, LZ, RHO, INVR0, KAPH, KAPL };

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// V: 0 mono, 1 narrowband, 2 poly
template <int V>
struct RecentredPair {
  static constexpr int NDK = V == 2 ? 8 : 6;
  static constexpr int NSK = V == 0 ? 20 : (V == 1 ? 23 : 24);
  static constexpr int RD = V == 2 ? 7 : 6;   // pd2 shares pd1's row
  static constexpr int RS = V == 0 ? 20 : 23;  // ka2 shares ka1's row
  // Cx Cy Cz Lx Ly Lz rho (the order of Par), and kappa in mono
  static constexpr int NPA = V == 0 ? 8 : 7;
  static constexpr int NP = NPARAM;

  __device__ static int dst_row(int k) { return V == 2 && k == PD2 ? PD1 : k; }
  __device__ static int src_row(int k) { return V == 2 && k == KA2 ? KA1 : k; }

  __device__ static void write_params(double* row, const double* sum) {
#pragma unroll
    for (int q = 0; q <= RHO; ++q) row[q] = sum[q];
    row[INVR0] = 0.0;
    // kappa_h and kappa_l enter only as their sum
    row[KAPH] = row[KAPL] = NPA == 8 ? sum[NPA - 1] : 0.0;
  }

  __device__ __forceinline__ static void eval(const float* d, const float* G,
                                              const float* s, const float* p,
                                              float* sp, float* dv) {
    // ---- the forward pair, as in kirchhoff_recentred.cu ----
    const float tx = d[TDX] - s[TSX];
    const float ty = d[TDY] - s[TSY];
    const float tz = d[TDZ] - s[TSZ];
    const float wp2 = tx * tx + ty * ty + tz * tz + p[RHO];
    const float A = d[AD] + s[AS_];
    const float rinv = 1.0f / A;
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
    xdd::sincos_cycles(c, sph, cph);

    // ---- the amplitude, fused ----
    const float lw = d[PDH] - s[LVH];
    const float num = fma_(lw, s[LNS], fma_(tz, s[N2], fma_(ty, s[N1],
                                                            fma_(tx, s[N0],
                                                                 s[CNS]))));
    const float nr = num * rinv;
    const float inner = fma_(nr, s[KW], s[KWNL]);
    const float pre = inner * rinv;
    const float U_r = -pre * sph;
    const float U_i = pre * cph;
    const float ax = fma_(lw, p[LX], p[CX] + tx);
    const float ay = fma_(lw, p[LY], p[CY] + ty);
    const float az = fma_(lw, p[LZ], p[CZ] + tz);
    const float f = s[K2] * rinv;
    const float ser = s[SER], sei = s[SEI];
    const float hr = fma_(ser, U_r, -sei * U_i);
    const float hi = fma_(ser, U_i, sei * U_r);
    const float g_r = f * hr;
    const float g_i = f * hi;

    // ---- the reverse sweep, fused ----
    const float esr = s[ESR], esi = s[ESI], epr = s[EPR], epi = s[EPI];
    sp[ESR] = fma_(G[0], U_r, fma_(G[1], U_i, sp[ESR]));
    sp[ESI] = fma_(G[1], U_r, fma_(-G[0], U_i, sp[ESI]));
    sp[EPR] = fma_(G[2], U_r, fma_(G[3], U_i, sp[EPR]));
    sp[EPI] = fma_(G[3], U_r, fma_(-G[2], U_i, sp[EPI]));
    const float bgr = fma_(G[4], ax, fma_(G[6], ay, G[8] * az));
    const float bgi = fma_(G[5], ax, fma_(G[7], ay, G[9] * az));
    const float bax = fma_(G[4], g_r, G[5] * g_i);
    const float bay = fma_(G[6], g_r, G[7] * g_i);
    const float baz = fma_(G[8], g_r, G[9] * g_i);
    const float bf = fma_(bgr, hr, bgi * hi);
    const float bhr = bgr * f, bhi = bgi * f;
    sp[SER] = fma_(bhr, U_r, fma_(bhi, U_i, sp[SER]));
    sp[SEI] = fma_(bhi, U_r, fma_(-bhr, U_i, sp[SEI]));
    const float bUr = fma_(G[0], esr, fma_(G[1], esi, fma_(G[2], epr,
                      fma_(G[3], epi, fma_(bhr, ser, bhi * sei)))));
    const float bUi = fma_(G[1], esr, fma_(-G[0], esi, fma_(G[3], epr,
                      fma_(-G[2], epi, fma_(bhi, ser, -bhr * sei)))));
    sp[K2] = fma_(bf, rinv, sp[K2]);
    float brinv = bf * s[K2];
    float* pa = sp + RS;  // the scalars' cotangents
    pa[CX] += bax;
    pa[CY] += bay;
    pa[CZ] += baz;
    pa[LX] = fma_(bax, lw, pa[LX]);
    pa[LY] = fma_(bay, lw, pa[LY]);
    pa[LZ] = fma_(baz, lw, pa[LZ]);
    float blw = fma_(bax, p[LX], fma_(bay, p[LY], baz * p[LZ]));
    // U = pre (-sin, cos): bsin = -bUr pre, bcos = bUi pre, and
    // bc = 2 pi (bsin cos - bcos sin) = -2 pi pre (bUr cos + bUi sin)
    const float bpre = fma_(bUi, cph, -bUr * sph);
    const float bc = -TWO_PI * pre * fma_(bUr, cph, bUi * sph);
    // pre = (kwnl + num rinv kw) rinv
    const float binner = bpre * rinv;
    brinv = fma_(bpre, inner, brinv);
    sp[KWNL] += binner;
    sp[KW] = fma_(binner, nr, sp[KW]);
    const float bnr = binner * s[KW];
    const float bnum = bnr * rinv;
    brinv = fma_(bnr, num, brinv);
    sp[CNS] += bnum;
    sp[N0] = fma_(bnum, tx, sp[N0]);
    sp[N1] = fma_(bnum, ty, sp[N1]);
    sp[N2] = fma_(bnum, tz, sp[N2]);
    sp[LNS] = fma_(bnum, lw, sp[LNS]);
    blw = fma_(bnum, s[LNS], blw);
    sp[PHIS] += bc;
    // the phase: c = phid + phis + kappa delta (+ the variant's cross term)
    float bdelta, pdh_x;
    if constexpr (V == 0) {
      bdelta = bc * (p[KAPH] + p[KAPL]);
      pa[NPA - 1] = fma_(bc, delta, pa[NPA - 1]);
      pdh_x = 0.0f;
      dv[PHID] = bc;
    } else if constexpr (V == 1) {
      bdelta = bc * (s[KAH] + s[KAL]);
      const float bk = bc * delta;
      sp[KAH] += bk;
      sp[KAL] += bk;
      sp[DKS] = fma_(bc, d[PDH], sp[DKS]);
      pdh_x = bc * s[DKS];
      dv[PHID] = bc;
    } else {
      bdelta = bc * (s[KAH] + s[KAL]);
      const float bk = bc * delta;
      // p = kah pdh enters frac_cycles with +1 and e with -1: no net term
      sp[KAH] += fma_(bc, d[PDL], bk);
      sp[KAL] += fma_(bc, d[PDH], bk);
      sp[KA1] = fma_(bc, d[PD1] + d[PD2], sp[KA1]);
      dv[PD1] = bc * (s[KA1] + s[KA2]);
      pdh_x = bc * s[KAL];
      dv[PDL] = bc * s[KAH];
    }
    // lw = pdh - lvh
    dv[PDH] = blw + pdh_x;
    sp[LVH] -= blw;
    // delta = wp2 rinv poly(x), x = wp2 rinv^2
    const float bdw = bdelta * wp2;
    const float bpoly = bdw * rinv;
    brinv = fma_(bdw, poly, brinv);
    const float dpoly = fma_(x, fma_(-0.1171875f, x, 0.125f), -0.125f);
    const float bxr = bpoly * dpoly * rinv;
    const float bwp2 = fma_(bdelta * rinv, poly, bxr * rinv);
    brinv = fma_(2.0f * bxr, wp2, brinv);
    // A = ad + as, rinv = 1 / A
    const float bA = -brinv * rinv * rinv;
    dv[AD] = bA;
    sp[AS_] += bA;
    pa[RHO] += bwp2;
    // t = td - ts
    const float b2 = 2.0f * bwp2;
    const float otx = fma_(b2, tx, fma_(bnum, s[N0], bax));
    const float oty = fma_(b2, ty, fma_(bnum, s[N1], bay));
    const float otz = fma_(b2, tz, fma_(bnum, s[N2], baz));
    dv[TDX] = otx;
    dv[TDY] = oty;
    dv[TDZ] = otz;
    sp[TSX] -= otx;
    sp[TSY] -= oty;
    sp[TSZ] -= otz;
  }
};

}  // namespace

// The pass.  dst: (ndkeys, nd); src: (nskeys, ns_pad), ns_pad a multiple
// of 128; params: (10,); gout: (10, nd), all f32 on the device.  Grid
// nslab x ngroup with slab destinations a slab (ops/kirchhoff.py
// adjoint_grid).  Writes the partials dpart (ngroup, RD, nd), spart
// (nslab, RS, ns_pad) and ppart (ngroup * nslab, 10) doubles.  Returns
// cudaGetLastError() after the launch.
extern "C" int kirchhoff_recentred_bwd_launch(
    int variant, const float* dst, int nd, const float* src, int ns_pad,
    const float* params, const float* gout, int nslab, int slab, int ngroup,
    float* dpart, float* spart, double* ppart, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XRT_PASS(V)                                                         \
  return xbwd::launch_pass<RecentredPair<V>>(dst, nd, src, ns_pad, params,  \
                                             gout, nslab, slab, ngroup,     \
                                             dpart, spart, ppart, s)
  switch (variant) {
    case 0: XRT_PASS(0);
    case 1: XRT_PASS(1);
    case 2: XRT_PASS(2);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XRT_PASS
}

// The partials of the pass summed into ddst (ndkeys, nd) and dsrc (nskeys,
// ns_pad).  Returns cudaGetLastError() after the launch.
extern "C" int kirchhoff_recentred_bwd_reduce(int variant, const float* dpart,
                                              int ngroup, int nd, float* ddst,
                                              const float* spart, int nslab,
                                              int ns_pad, float* dsrc,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XRT_REDUCE(V)                                                       \
  return xbwd::launch_reduce<RecentredPair<V>>(dpart, ngroup, nd, ddst,     \
                                               spart, nslab, ns_pad, dsrc, \
                                               s)
  switch (variant) {
    case 0: XRT_REDUCE(0);
    case 1: XRT_REDUCE(1);
    case 2: XRT_REDUCE(2);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XRT_REDUCE
}
