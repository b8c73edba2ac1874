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
// What bounds it: f32 ALU work.  One pair needs at least 351 operations
// ('fast') or 391 ('exact': forward without its sums, reverse sweep, 20
// sums; chip_smoke.py counts them term by term); the two passes each
// recompute the pair, so the kernel does nearly twice that.  Bytes are
// O(Nd + Ns).
//
// Design: as csrc/kirchhoff_recentred_bwd.cu, two passes without atomics:
// a dst pass (one thread per destination, sources staged in shared memory)
// and a src pass (one thread per source, destinations and their G staged),
// with per-chunk partial sums.
//
// Build: nvcc --fmad=false (see dd.cuh).
#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int CHUNK = 256;
constexpr int NSK = 20;
constexpr int NDK = 6;
constexpr float TWO_PI = 6.283185307179586f;

// source key rows (ops/kirchhoff.py _DD_SRC_KEYS)
enum Src {
  XSH, XSL, YSH, YSL, ZSH, ZSL, KP0, KP1, KWNL, KW, K2, ESR, ESI, EPR, EPI,
  SER, SEI, N0, N1, N2
};

// One pair's cotangents; x, y, z are those of the coordinate differences
// (destination minus source).
struct PairGrad {
  float x, y, z;
  float kp0, kp1, kwnl, kw, k2, esr, esi, epr, epi, ser, sei, n0, n1, n2;
};

template <int V>
__device__ __forceinline__ void pair_grad(const float* d, const float* s,
                                          const float* G, PairGrad& o) {
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
  const float a = dx.h, b = dy.h, c = dz.h;
  const float dotn = a * s[N0] + b * s[N1] + c * s[N2];
  const float rk = rinv * s[KW];
  const float nsk = dotn * rk;
  const float inner = s[KWNL] + nsk;
  const float pre = inner * rinv;
  const float U_r = -pre * sph;
  const float U_i = pre * cph;
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
  const float bgr = G[4] * a + G[6] * b + G[8] * c;
  const float bgi = G[5] * a + G[7] * b + G[9] * c;
  float ba = G[4] * g_r + G[5] * g_i;
  float bb = G[6] * g_r + G[7] * g_i;
  float bcz = G[8] * g_r + G[9] * g_i;
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
  const float bpre = bUi * cph - bUr * sph;
  const float bsph = -bUr * pre, bcph = bUi * pre;
  // pre = (kwnl + dotn rinv kw) rinv
  const float binner = bpre * rinv;
  brinv += bpre * inner;
  o.kwnl = binner;
  const float bdotn = binner * rk;
  const float brk = binner * dotn;
  brinv += brk * s[KW];
  o.kw = brk * rinv;
  o.n0 = bdotn * a;
  o.n1 = bdotn * b;
  o.n2 = bdotn * c;
  ba += bdotn * s[N0];
  bb += bdotn * s[N1];
  bcz += bdotn * s[N2];
  if constexpr (V == 0) {
    // cyc = frac(kp0 s0 + (kp0 corr + kp1 s0)), r = s0 + corr
    const float bcyc = TWO_PI * (bsph * cph - bcph * sph);
    o.kp0 = bcyc * corr + bcyc * s0;
    o.kp1 = bcyc * s0;
    const float bcorr = bcyc * kp0;
    float bs0 = bcyc * kp1 + bcyc * kp0;
    const float bresid = bcorr * (0.5f * rinv);
    brinv += bcorr * resid * 0.5f;
    bs0 += -bresid * 2.0f * s0;  // through q = s0 s0
    bs0 += -brinv * rinv * rinv;
    const float bs2 = bresid + bs0 * (0.5f * rinv);
    const float b2 = 2.0f * bs2, l2 = 2.0f * bresid;
    o.x = ba + b2 * dx.h + l2 * dx.l;
    o.y = bb + b2 * dy.h + l2 * dy.l;
    o.z = bcz + b2 * dz.h + l2 * dz.l;
  } else {
    const float bphase = bsph * cph - bcph * sph;
    // frac_two_pi: phase = 2 pi frac(m), in two parts
    const float bmh = 0x1.921fb6p+2f * bphase + -0x1.777a5cp-23f * bphase;
    // m = ka r (double-float product): high word ka.h r.h + ka.h r.l +
    // ka.l r.h
    const float bkah = bmh * r.h + bmh * r.l;
    float brh = bmh * ka.h + bmh * ka.l;
    brh += -brinv * rinv * rinv;
    const xdd::dd i2p = xdd::inv_two_pi();
    o.kp0 = bkah * i2p.h + bkah * i2p.l;
    o.kp1 = bkah * i2p.h;
    // r = s0 + corr, corr = (r2 - s0 s0) / (2 s0), s0 = sqrt(r2)
    float bs0 = brh;
    const float bnum = brh / denom;
    if (s0 != 0.0f) bs0 += -2.0f * (brh * corr / denom);
    bs0 += -bnum * 2.0f * s0;
    float br2 = bnum;
    if (s0 != 0.0f) br2 += bs0 * 0.5f / s0;
    const float b2 = 2.0f * br2;
    o.x = ba + b2 * dx.h + b2 * dx.l;
    o.y = bb + b2 * dy.h + b2 * dy.l;
    o.z = bcz + b2 * dz.h + b2 * dz.l;
  }
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
bwd_dst_kernel(const float* __restrict__ dst, int nd,
               const float* __restrict__ src, int ns_pad,
               const float* __restrict__ gout, float* __restrict__ ddst) {
  __shared__ float sh[NSK][CHUNK];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < nd;
  const int ii = live ? i : nd - 1;
  float d[NDK], G[10];
#pragma unroll
  for (int q = 0; q < NDK; ++q) d[q] = dst[q * nd + ii];
#pragma unroll
  for (int q = 0; q < 10; ++q) G[q] = live ? gout[q * nd + ii] : 0.0f;
  float acc[3] = {0.0f, 0.0f, 0.0f};

  for (int base = 0; base < ns_pad; base += CHUNK) {
    __syncthreads();
    for (int t = threadIdx.x; t < NSK * CHUNK; t += BLOCK) {
      const int key = t / CHUNK, j = t - key * CHUNK;
      sh[key][j] = src[key * ns_pad + base + j];
    }
    __syncthreads();
    float part[3] = {0.0f, 0.0f, 0.0f};
    for (int j = 0; j < CHUNK; ++j) {
      float s[NSK];
#pragma unroll
      for (int q = 0; q < NSK; ++q) s[q] = sh[q][j];
      PairGrad o;
      pair_grad<V>(d, s, G, o);
      part[0] += o.x;
      part[1] += o.y;
      part[2] += o.z;
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) acc[q] += part[q];
  }
  if (live) {
    // the hi and lo keys of a coordinate share its cotangent
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      ddst[(2 * q) * nd + i] = acc[q];
      ddst[(2 * q + 1) * nd + i] = acc[q];
    }
  }
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
bwd_src_kernel(const float* __restrict__ dst, int nd,
               const float* __restrict__ src, int ns_pad,
               const float* __restrict__ gout, float* __restrict__ dsrc) {
  __shared__ float shd[NDK + 10][CHUNK];  // destination keys, then G
  // ns_pad is a multiple of CHUNK and CHUNK of BLOCK: every thread owns a
  // (possibly padded) source
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  float s[NSK];
#pragma unroll
  for (int q = 0; q < NSK; ++q) s[q] = src[q * ns_pad + i];
  constexpr int NA = 17;  // x y z and the fourteen other keys
  float acc[NA];
#pragma unroll
  for (int q = 0; q < NA; ++q) acc[q] = 0.0f;

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
    float part[NA];
#pragma unroll
    for (int q = 0; q < NA; ++q) part[q] = 0.0f;
    for (int j = 0; j < CHUNK; ++j) {
      float d[NDK], G[10];
#pragma unroll
      for (int q = 0; q < NDK; ++q) d[q] = shd[q][j];
#pragma unroll
      for (int q = 0; q < 10; ++q) G[q] = shd[NDK + q][j];
      PairGrad o;
      pair_grad<V>(d, s, G, o);
      part[0] += o.x;
      part[1] += o.y;
      part[2] += o.z;
      part[3] += o.kp0;
      part[4] += o.kp1;
      part[5] += o.kwnl;
      part[6] += o.kw;
      part[7] += o.k2;
      part[8] += o.esr;
      part[9] += o.esi;
      part[10] += o.epr;
      part[11] += o.epi;
      part[12] += o.ser;
      part[13] += o.sei;
      part[14] += o.n0;
      part[15] += o.n1;
      part[16] += o.n2;
    }
#pragma unroll
    for (int q = 0; q < NA; ++q) acc[q] += part[q];
  }
  // the differences are destination minus source; hi and lo share
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    dsrc[(2 * q) * ns_pad + i] = -acc[q];
    dsrc[(2 * q + 1) * ns_pad + i] = -acc[q];
  }
#pragma unroll
  for (int q = 3; q < NA; ++q) dsrc[(q + 3) * ns_pad + i] = acc[q];
}

template <int V>
int launch(const float* dst, int nd, const float* src, int ns_pad,
           const float* gout, float* ddst, float* dsrc, cudaStream_t s) {
  bwd_dst_kernel<V><<<(nd + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(
      dst, nd, src, ns_pad, gout, ddst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_src_kernel<V><<<ns_pad / BLOCK, BLOCK, 0, s>>>(dst, nd, src, ns_pad,
                                                     gout, dsrc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dst: (6, nd); src: (20, ns_pad), ns_pad a multiple of CHUNK; gout:
// (10, nd), all f32 on the device.  Writes ddst (6, nd) and dsrc
// (20, ns_pad).  variant 0 'fast', 1 'exact'.  Returns cudaGetLastError()
// after the launches.
extern "C" int kirchhoff_ddphase_bwd_launch(int variant, const float* dst,
                                            int nd, const float* src,
                                            int ns_pad, const float* gout,
                                            float* ddst, float* dsrc,
                                            void* stream) {
  if (nd <= 0 || ns_pad <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ns_pad % CHUNK != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return launch<0>(dst, nd, src, ns_pad, gout, ddst, dsrc, s);
    case 1:
      return launch<1>(dst, nd, src, ns_pad, gout, ddst, dsrc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
