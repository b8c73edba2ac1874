// Kernel B3 (recentred): the adjoint of the recentred-phase Kirchhoff
// double sum, float32.
//
// Replaces the backward of the TPU package's custom VJP,
// xrt_tpu/ops/kirchhoff.py:1141 _kirchhoff_pallas_diff, whose backward
// (_kirchhoff_bwd_blocked, :1076) re-evaluates the XLA formulation under
// reverse-mode autodiff in blocks of 8192 destinations x 4096 sources.  Plain version
// beside it: xrt_tpu_torch/ops/kirchhoff.py kirchhoff_bwd_blocked (autograd
// through the plain forward, blocked and checkpointed).
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
// pd1, pd2 are inputs of their own, and the two-product residual
// e = ka*pd - p keeps its term-by-term derivative.
//
// What bounds it: f32 ALU work.  One pair needs at least 259 operations in
// the mono variant (the forward's 88 without its sums, 137 for the reverse
// sweep, 34 sums; chip_smoke.py counts them term by term); the two passes
// below each recompute the pair and sweep the part of the reverse they
// need, so the kernel does nearly twice that.  Bytes are O(Nd + Ns).
//
// Design: two passes over all pairs, no atomics, so the result does not
// change from run to run.
//  * dst pass: one thread per destination holding its keys, its ten G and
//    the cotangent accumulators of its keys in registers; the block stages
//    CHUNK sources per step in shared memory, as kernel B1 does.  The same
//    threads accumulate the cotangents of the ten scalars; a block reduces
//    them in double precision and writes one row of partials, which the
//    wrapper sums in float64 (they are sums over all pairs of large terms
//    with cancelling signs).
//  * src pass: one thread per source holding its keys and accumulators in
//    registers; the block stages CHUNK destinations (keys and G) per step.
// Every chunk's sums are taken apart and then added to the accumulators, as
// in B1 (one running f32 sum over 2e5 terms drifts by ~1e-4).  Padded
// sources have zero fields and weights and dead threads zero G, so they
// contribute exact zeros.
//
// Build: nvcc --fmad=false (see dd.cuh), so the recomputed forward has the
// forward kernel's bits.
#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int CHUNK = 256;
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

template <int V>
struct Keys {
  static constexpr int nd = V == 2 ? 8 : 6;
  static constexpr int ns = V == 0 ? 20 : (V == 1 ? 23 : 24);
};

// One pair's cotangents.  t, A, lw and c are those of the transverse offset
// t = td - ts, of A = ad + as_, of lw = pdh - lvh and of the phase c; the
// passes give them to the keys with the signs of those definitions.
struct PairGrad {
  float tx, ty, tz, A, lw, c;
  float pdh_x, pdl, pd12;  // more on pdh (narrowband, poly); pdl; pd1 = pd2
  float kw, kwnl, k2, Lns, Cns, n0, n1, n2, esr, esi, epr, epi, ser, sei;
  float kah, kal, dks, ka12;  // ka1 = ka2
  float Cx, Cy, Cz, Lx, Ly, Lz, rho, kap;  // kappa_h = kappa_l
};

// d: the destination's keys, s: the source's keys, p: the scalars, G: the
// destination's ten output cotangents
template <int V>
__device__ __forceinline__ void pair_grad(const float* d, const float* s,
                                          const float* p, const float* G,
                                          PairGrad& o) {
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
    const float lo2 = e + kal * d[PDH] + kah * d[PDL] + s[PHIS] + kal * delta;
    const float c0 = xdd::frac_cycles(pp, lo2);
    m = c0 + (phic - rintf(phic));
  }
  const float c = m - rintf(m);
  float sph, cph;
  xdd::sincos_cycles(c, sph, cph);

  const float lw = d[PDH] - s[LVH];
  const float num = s[CNS] + tx * s[N0] + ty * s[N1] + tz * s[N2] +
                    lw * s[LNS];
  const float nr = num * rinv;
  const float inner = s[KWNL] + nr * s[KW];
  const float pre = inner * rinv;
  const float U_r = -pre * sph;
  const float U_i = pre * cph;
  const float ax = p[CX] + tx + lw * p[LX];
  const float ay = p[CY] + ty + lw * p[LY];
  const float az = p[CZ] + tz + lw * p[LZ];
  const float f = s[K2] * rinv;
  const float ser = s[SER], sei = s[SEI];
  const float hr = ser * U_r - sei * U_i;
  const float hi = ser * U_i + sei * U_r;
  const float g_r = f * hr;
  const float g_i = f * hi;

  // ---- the reverse sweep ----
  const float esr = s[ESR], esi = s[ESI], epr = s[EPR], epi = s[EPI];
  o.esr = G[0] * U_r + G[1] * U_i;
  o.esi = G[1] * U_r - G[0] * U_i;
  o.epr = G[2] * U_r + G[3] * U_i;
  o.epi = G[3] * U_r - G[2] * U_i;
  const float bgr = G[4] * ax + G[6] * ay + G[8] * az;
  const float bgi = G[5] * ax + G[7] * ay + G[9] * az;
  const float bax = G[4] * g_r + G[5] * g_i;
  const float bay = G[6] * g_r + G[7] * g_i;
  const float baz = G[8] * g_r + G[9] * g_i;
  const float bf = bgr * hr + bgi * hi;
  const float bhr = bgr * f, bhi = bgi * f;
  o.ser = bhr * U_r + bhi * U_i;
  o.sei = bhi * U_r - bhr * U_i;
  const float bUr = G[0] * esr + G[1] * esi + G[2] * epr + G[3] * epi +
                    bhr * ser + bhi * sei;
  const float bUi = G[1] * esr - G[0] * esi + G[3] * epr - G[2] * epi +
                    bhi * ser - bhr * sei;
  o.k2 = bf * rinv;
  float brinv = bf * s[K2];
  o.Cx = bax;
  o.Cy = bay;
  o.Cz = baz;
  o.Lx = bax * lw;
  o.Ly = bay * lw;
  o.Lz = baz * lw;
  float blw = bax * p[LX] + bay * p[LY] + baz * p[LZ];
  // U = pre (-sin, cos)
  const float bpre = bUi * cph - bUr * sph;
  const float bsph = -bUr * pre, bcph = bUi * pre;
  const float bc = TWO_PI * (bsph * cph - bcph * sph);
  // pre = (kwnl + num rinv kw) rinv
  const float binner = bpre * rinv;
  brinv += bpre * inner;
  o.kwnl = binner;
  o.kw = binner * nr;
  const float bnr = binner * s[KW];
  const float bnum = bnr * rinv;
  brinv += bnr * num;
  o.Cns = bnum;
  o.n0 = bnum * tx;
  o.n1 = bnum * ty;
  o.n2 = bnum * tz;
  o.Lns = bnum * lw;
  blw += bnum * s[LNS];
  o.lw = blw;
  o.c = bc;
  // the phase: c = phid + phis + kappa delta (+ the variant's cross term)
  float bdelta;
  if constexpr (V == 0) {
    bdelta = bc * p[KAPH] + bc * p[KAPL];
    o.kap = bc * delta;
    o.pdh_x = 0.0f;
  } else if constexpr (V == 1) {
    bdelta = bc * s[KAH] + bc * s[KAL];
    o.kah = o.kal = bc * delta;
    o.dks = bc * d[PDH];
    o.pdh_x = bc * s[DKS];
  } else {
    bdelta = bc * s[KAH] + bc * s[KAL];
    // p = kah pdh enters frac_cycles with +1 and e with -1: no net term
    o.kah = bc * d[PDL] + bc * delta;
    o.kal = bc * d[PDH] + bc * delta;
    o.ka12 = bc * (d[PD1] + d[PD2]);
    o.pd12 = bc * (s[KA1] + s[KA2]);
    o.pdh_x = bc * s[KAL];
    o.pdl = bc * s[KAH];
  }
  // delta = wp2 rinv poly(x), x = wp2 rinv^2
  const float bpoly = bdelta * wp2 * rinv;
  brinv += bdelta * wp2 * poly;
  const float dpoly = x * (0.125f - 0.1171875f * x) - 0.125f;
  const float bx = bpoly * dpoly;
  const float bwp2 = bdelta * rinv * poly + bx * rinv * rinv;
  brinv += 2.0f * bx * wp2 * rinv;
  o.A = -brinv * rinv * rinv;
  o.rho = bwp2;
  const float b2 = 2.0f * bwp2;
  o.tx = bax + bnum * s[N0] + b2 * tx;
  o.ty = bay + bnum * s[N1] + b2 * ty;
  o.tz = baz + bnum * s[N2] + b2 * tz;
}

// sum of v over the block's threads, in double; valid in thread 0
__device__ __forceinline__ double block_sum(double v, double* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < BLOCK / 32; ++w) t += scratch[w];
  }
  return t;
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
bwd_dst_kernel(const float* __restrict__ dst, int nd,
               const float* __restrict__ src, int ns_pad,
               const float* __restrict__ params,
               const float* __restrict__ gout, float* __restrict__ ddst,
               double* __restrict__ ppart) {
  constexpr int NDK = Keys<V>::nd;
  constexpr int NSK = Keys<V>::ns;
  constexpr int NPA = 8;  // Cx Cy Cz Lx Ly Lz rho kappa
  __shared__ float sh[NSK][CHUNK];
  __shared__ double scratch[BLOCK / 32];

  float p[NPARAM];
#pragma unroll
  for (int q = 0; q < NPARAM; ++q) p[q] = params[q];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < nd;
  const int ii = live ? i : nd - 1;
  float d[NDK], G[10];
#pragma unroll
  for (int q = 0; q < NDK; ++q) d[q] = dst[q * nd + ii];
#pragma unroll
  for (int q = 0; q < 10; ++q) G[q] = live ? gout[q * nd + ii] : 0.0f;

  float acc[NDK], pacc[NPA];
#pragma unroll
  for (int q = 0; q < NDK; ++q) acc[q] = 0.0f;
#pragma unroll
  for (int q = 0; q < NPA; ++q) pacc[q] = 0.0f;

  for (int base = 0; base < ns_pad; base += CHUNK) {
    __syncthreads();
    for (int t = threadIdx.x; t < NSK * CHUNK; t += BLOCK) {
      const int key = t / CHUNK, j = t - key * CHUNK;
      sh[key][j] = src[key * ns_pad + base + j];
    }
    __syncthreads();
    float part[NDK], ppt[NPA];
#pragma unroll
    for (int q = 0; q < NDK; ++q) part[q] = 0.0f;
#pragma unroll
    for (int q = 0; q < NPA; ++q) ppt[q] = 0.0f;
    for (int j = 0; j < CHUNK; ++j) {
      float s[NSK];
#pragma unroll
      for (int q = 0; q < NSK; ++q) s[q] = sh[q][j];
      PairGrad o;
      pair_grad<V>(d, s, p, G, o);
      part[TDX] += o.tx;
      part[TDY] += o.ty;
      part[TDZ] += o.tz;
      part[AD] += o.A;
      part[PDH] += o.lw + o.pdh_x;
      if constexpr (V == 2) {
        part[PDL] += o.pdl;
        part[PD1] += o.pd12;
      } else {
        part[PHID] += o.c;
      }
      ppt[0] += o.Cx;
      ppt[1] += o.Cy;
      ppt[2] += o.Cz;
      ppt[3] += o.Lx;
      ppt[4] += o.Ly;
      ppt[5] += o.Lz;
      ppt[6] += o.rho;
      if constexpr (V == 0) ppt[7] += o.kap;
    }
#pragma unroll
    for (int q = 0; q < NDK; ++q) acc[q] += part[q];
#pragma unroll
    for (int q = 0; q < NPA; ++q) pacc[q] += ppt[q];
  }
  if constexpr (V == 2) acc[PD2] = acc[PD1];  // the halves share a cotangent
  if (live) {
#pragma unroll
    for (int q = 0; q < NDK; ++q) ddst[q * nd + i] = acc[q];
  }
  // the scalars' cotangents: one row of partials per block
#pragma unroll
  for (int q = 0; q < NPA; ++q) {
    const double t = block_sum(static_cast<double>(pacc[q]), scratch);
    if (threadIdx.x == 0) {
      ppart[blockIdx.x * NPARAM + (q < NPA - 1 ? q : KAPH)] = t;
      if (q == NPA - 1) {
        ppart[blockIdx.x * NPARAM + KAPL] = t;
        ppart[blockIdx.x * NPARAM + INVR0] = 0.0;
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
bwd_src_kernel(const float* __restrict__ dst, int nd,
               const float* __restrict__ src, int ns_pad,
               const float* __restrict__ params,
               const float* __restrict__ gout, float* __restrict__ dsrc) {
  constexpr int NDK = Keys<V>::nd;
  constexpr int NSK = Keys<V>::ns;
  __shared__ float shd[NDK + 10][CHUNK];  // destination keys, then G

  float p[NPARAM];
#pragma unroll
  for (int q = 0; q < NPARAM; ++q) p[q] = params[q];
  // ns_pad is a multiple of CHUNK and CHUNK of BLOCK: every thread owns a
  // (possibly padded) source
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  float s[NSK], acc[NSK];
#pragma unroll
  for (int q = 0; q < NSK; ++q) {
    s[q] = src[q * ns_pad + i];
    acc[q] = 0.0f;
  }

  for (int base = 0; base < nd; base += CHUNK) {
    __syncthreads();
    for (int t = threadIdx.x; t < (NDK + 10) * CHUNK; t += BLOCK) {
      const int key = t / CHUNK, j = t - key * CHUNK;
      const int idx = base + j;
      // the ragged edge repeats the last destination with zero cotangents
      float v;
      if (key < NDK)
        v = dst[key * nd + (idx < nd ? idx : nd - 1)];
      else
        v = idx < nd ? gout[(key - NDK) * nd + idx] : 0.0f;
      shd[key][j] = v;
    }
    __syncthreads();
    float part[NSK];
#pragma unroll
    for (int q = 0; q < NSK; ++q) part[q] = 0.0f;
    for (int j = 0; j < CHUNK; ++j) {
      float d[NDK], G[10];
#pragma unroll
      for (int q = 0; q < NDK; ++q) d[q] = shd[q][j];
#pragma unroll
      for (int q = 0; q < 10; ++q) G[q] = shd[NDK + q][j];
      PairGrad o;
      pair_grad<V>(d, s, p, G, o);
      part[TSX] += o.tx;  // negated below: t = td - ts, lw = pdh - lvh
      part[TSY] += o.ty;
      part[TSZ] += o.tz;
      part[AS_] += o.A;
      part[LVH] += o.lw;
      part[PHIS] += o.c;
      part[KW] += o.kw;
      part[KWNL] += o.kwnl;
      part[K2] += o.k2;
      part[LNS] += o.Lns;
      part[CNS] += o.Cns;
      part[N0] += o.n0;
      part[N1] += o.n1;
      part[N2] += o.n2;
      part[ESR] += o.esr;
      part[ESI] += o.esi;
      part[EPR] += o.epr;
      part[EPI] += o.epi;
      part[SER] += o.ser;
      part[SEI] += o.sei;
      if constexpr (V == 1) {
        part[KAH] += o.kah;
        part[KAL] += o.kal;
        part[DKS] += o.dks;
      } else if constexpr (V == 2) {
        part[KAH] += o.kah;
        part[KAL] += o.kal;
        part[KA1] += o.ka12;
      }
    }
#pragma unroll
    for (int q = 0; q < NSK; ++q) acc[q] += part[q];
  }
  if constexpr (V == 2) acc[KA2] = acc[KA1];  // the halves share a cotangent
  acc[TSX] = -acc[TSX];
  acc[TSY] = -acc[TSY];
  acc[TSZ] = -acc[TSZ];
  acc[LVH] = -acc[LVH];
#pragma unroll
  for (int q = 0; q < NSK; ++q) dsrc[q * ns_pad + i] = acc[q];
}

template <int V>
int launch(const float* dst, int nd, const float* src, int ns_pad,
           const float* params, const float* gout, float* ddst, float* dsrc,
           double* ppart, cudaStream_t s) {
  const int nblk = (nd + BLOCK - 1) / BLOCK;
  bwd_dst_kernel<V><<<nblk, BLOCK, 0, s>>>(dst, nd, src, ns_pad, params,
                                           gout, ddst, ppart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_src_kernel<V><<<ns_pad / BLOCK, BLOCK, 0, s>>>(dst, nd, src, ns_pad,
                                                     params, gout, dsrc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dst: (ndkeys, nd); src: (nskeys, ns_pad), ns_pad a multiple of CHUNK;
// params: (10,); gout: (10, nd), all f32 on the device.  Writes ddst
// (ndkeys, nd), dsrc (nskeys, ns_pad) and ppart (ceil(nd / BLOCK), 10)
// doubles, one row per block of the dst pass.
// Returns cudaGetLastError() after the launches.
extern "C" int kirchhoff_recentred_bwd_launch(int variant, const float* dst,
                                              int nd, const float* src,
                                              int ns_pad, const float* params,
                                              const float* gout, float* ddst,
                                              float* dsrc, double* ppart,
                                              void* stream) {
  if (nd <= 0 || ns_pad <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ns_pad % CHUNK != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return launch<0>(dst, nd, src, ns_pad, params, gout, ddst, dsrc, ppart,
                       s);
    case 1:
      return launch<1>(dst, nd, src, ns_pad, params, gout, ddst, dsrc, ppart,
                       s);
    case 2:
      return launch<2>(dst, nd, src, ns_pad, params, gout, ddst, dsrc, ppart,
                       s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
