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
// What bounds it: f32 ALU work per pair (~230 operations in 'fast', ~270
// with cosf/sinf in 'exact'; chip_smoke.py counts them term by term); the
// bytes are O(Nd + Ns).
//
// Design: as B1 — one thread per destination point holding its six
// (hi, lo) coordinates and ten accumulators in registers, the block
// staging CHUNK sources' twenty keys in shared memory per step, and the
// sums taken per chunk before they join the accumulators.  The
// per-source folding (kappa = k/2pi in dd, kw, kwnl, k2) is done in plain
// PyTorch before the launch, as the XLA code around the TPU kernel did.
//
// Build: nvcc --fmad=false (see dd.cuh): every two_sum / two_prod here
// must stay error-free.
#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int CHUNK = 256;
constexpr int NSK = 20;

// source key rows (ops/kirchhoff.py _DD_SRC_KEYS)
enum Src {
  XSH, XSL, YSH, YSL, ZSH, ZSL, KP0, KP1, KWNL, KW, K2, ESR, ESI, EPR, EPI,
  SER, SEI, N0, N1, N2
};

template <int V>
__global__ void __launch_bounds__(BLOCK)
kirchhoff_ddphase_kernel(const float* __restrict__ dst, int nd,
                         const float* __restrict__ src, int ns_pad,
                         float* __restrict__ out) {
  __shared__ float sh[NSK][CHUNK];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < nd;
  const int ii = live ? i : nd - 1;
  const xdd::dd xd{dst[0 * nd + ii], dst[1 * nd + ii]};
  const xdd::dd yd{dst[2 * nd + ii], dst[3 * nd + ii]};
  const xdd::dd zd{dst[4 * nd + ii], dst[5 * nd + ii]};

  float acc[10];
#pragma unroll
  for (int q = 0; q < 10; ++q) acc[q] = 0.0f;

  for (int base = 0; base < ns_pad; base += CHUNK) {
    __syncthreads();
    for (int t = threadIdx.x; t < NSK * CHUNK; t += BLOCK) {
      const int key = t / CHUNK, j = t - key * CHUNK;
      sh[key][j] = src[key * ns_pad + base + j];
    }
    __syncthreads();
    float part[10];
#pragma unroll
    for (int q = 0; q < 10; ++q) part[q] = 0.0f;
    for (int j = 0; j < CHUNK; ++j) {
      const xdd::dd dx = xdd::sub(xd, {sh[XSH][j], sh[XSL][j]});
      const xdd::dd dy = xdd::sub(yd, {sh[YSH][j], sh[YSL][j]});
      const xdd::dd dz = xdd::sub(zd, {sh[ZSH][j], sh[ZSL][j]});
      const float kp0 = sh[KP0][j], kp1 = sh[KP1][j];
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
        rinv = 1.0f / s0;
        const xdd::dd qq = xdd::two_prod(s0, s0);
        const float corr = ((s2.h - qq.h) + (lo - qq.l)) * (0.5f * rinv);
        const xdd::dd mm = xdd::two_prod(kp0, s0);
        const float ml = mm.l + kp0 * corr + kp1 * s0;
        const float cyc = xdd::frac_cycles(mm.h, ml);
        xdd::sincos_cycles(cyc, sph, cph);
      } else {
        // _phase_dd: kp = k as dd; radian phase, IEEE cos / sin
        const xdd::dd r2 =
            xdd::add(xdd::add(xdd::sqr(dx), xdd::sqr(dy)), xdd::sqr(dz));
        const xdd::dd r = xdd::sqrt(r2);
        const xdd::dd ka = xdd::mul({kp0, kp1}, xdd::inv_two_pi());
        const xdd::dd mm = xdd::mul(ka, r);
        const float phase = xdd::frac_two_pi(mm.h, mm.l);
        rinv = 1.0f / r.h;
        cph = cosf(phase);
        sph = sinf(phase);
      }
      const float a = dx.h, b = dy.h, c = dz.h;
      const float nsk = (a * sh[N0][j] + b * sh[N1][j] + c * sh[N2][j]) *
                        (rinv * sh[KW][j]);
      const float pre = (sh[KWNL][j] + nsk) * rinv;
      const float U_r = -pre * sph;
      const float U_i = pre * cph;
      const float f = sh[K2][j] * rinv;
      const float ser = sh[SER][j], sei = sh[SEI][j];
      const float g_r = f * (ser * U_r - sei * U_i);
      const float g_i = f * (ser * U_i + sei * U_r);
      const float esr = sh[ESR][j], esi = sh[ESI][j];
      const float epr = sh[EPR][j], epi = sh[EPI][j];
      part[0] += esr * U_r - esi * U_i;
      part[1] += esr * U_i + esi * U_r;
      part[2] += epr * U_r - epi * U_i;
      part[3] += epr * U_i + epi * U_r;
      part[4] += g_r * a;
      part[5] += g_i * a;
      part[6] += g_r * b;
      part[7] += g_i * b;
      part[8] += g_r * c;
      part[9] += g_i * c;
    }
#pragma unroll
    for (int q = 0; q < 10; ++q) acc[q] += part[q];
  }
  if (live) {
#pragma unroll
    for (int q = 0; q < 10; ++q) out[q * nd + i] = acc[q];
  }
}

}  // namespace

// dst: (6, nd) f32 (x, y, z as hi/lo rows); src: (20, ns_pad) f32 with
// ns_pad a multiple of CHUNK; out: (10, nd) f32.  variant 0 'fast',
// 1 'exact'.  Returns cudaGetLastError() after launch.
extern "C" int kirchhoff_ddphase_launch(int variant, const float* dst,
                                        int nd, const float* src,
                                        int ns_pad, float* out,
                                        void* stream) {
  if (nd <= 0) return 0;
  if (ns_pad % CHUNK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nd + BLOCK - 1) / BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      kirchhoff_ddphase_kernel<0><<<grid, BLOCK, 0, s>>>(dst, nd, src,
                                                         ns_pad, out);
      break;
    case 1:
      kirchhoff_ddphase_kernel<1><<<grid, BLOCK, 0, s>>>(dst, nd, src,
                                                         ns_pad, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
