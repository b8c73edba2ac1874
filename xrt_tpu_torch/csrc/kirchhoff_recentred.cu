// Kernel B1: the recentred-phase Kirchhoff double sum, float32.
//
// Replaces the TPU kernel xrt_tpu/ops/kirchhoff.py:565
// _kirchhoff_pallas_recentred (pallas_call at :802), reached from
// kirchhoff_integral_pallas (:823).  Plain version beside it:
// xrt_tpu_torch/ops/kirchhoff.py kirchhoff_integral_recentred.
//
// What it computes: for every destination d and source s the propagator
// U = pre * e^{2 pi i c} of _recentred_core, from per-point double-float
// precomputations (recentre_kirchhoff_inputs, done in plain PyTorch on the
// card), and the ten f32 sums over s: Es and Ep (re/im) and the a/b/c
// direction integrals (re/im).  Variants: 0 mono, 1 narrowband, 2 poly.
//
// What bounds it: f32 ALU work per pair (~116 operations, one reciprocal,
// no transcendental: the phase uses the sincos_cycles polynomials;
// chip_smoke.py counts them term by term); the bytes are O(Nd + Ns).
// Every 'accumulate' mode of the TPU kernel ('mxu', 'mxu2', 'mxu-fast',
// 'mxu32', 'vpu') runs here as the exact per-pair f32 contraction
// ('vpu'); the bf16 split rode the TPU's matrix unit, and a tensor-core
// contraction is later work.
//
// Design: one thread per destination point, blocks of BLOCK threads; each
// thread keeps its destination keys and the ten accumulators in registers.
// The block walks the sources in chunks of CHUNK, staging the chunk's
// per-source keys (structure of arrays) in shared memory; that loop takes
// the place of the TPU's sequential fori_loop over source chunks.  Each
// chunk's sums are taken apart and then added to the accumulators: a
// single running f32 sum over 2e5 sources drifts by ~1e-4 of the field.
// Sources are zero-padded to a multiple of CHUNK by the wrapper (zero
// weight and field: no contribution); the ragged destination edge is
// masked.
//
// Build: nvcc --fmad=false (see dd.cuh): the per-pair error terms of the
// poly variant are exact two-product residuals.
#include <cuda_runtime.h>

#include "dd.cuh"

// by-value scalars (ops/kirchhoff.py _PARAM_KEYS); the TPU kernel kept
// them in SMEM
struct KirchhoffRecentredParams {
  float Cx, Cy, Cz, Lx, Ly, Lz, rho, invR0, kappa_h, kappa_l;
};

namespace {

constexpr int BLOCK = 128;
constexpr int CHUNK = 256;
using Params = KirchhoffRecentredParams;

// source key rows (ops/kirchhoff.py _SRC_KEYS_COMMON + variant keys)
enum Src {
  TSX, TSY, TSZ, AS_, LVH, PHIS, KW, KWNL, K2, LNS, CNS, N0, N1, N2,
  ESR, ESI, EPR, EPI, SER, SEI, KAH, KAL, DKS = 22, KA1 = 22, KA2 = 23
};
// destination key rows: mono/narrowband, and poly
enum Dst { TDX, TDY, TDZ, AD, PDH, PHID = 5, PDL = 5, PD1 = 6, PD2 = 7 };

template <int V>
struct Keys {
  static constexpr int nd = V == 2 ? 8 : 6;
  static constexpr int ns = V == 0 ? 20 : (V == 1 ? 23 : 24);
};

template <int V>
__global__ void __launch_bounds__(BLOCK)
kirchhoff_recentred_kernel(const float* __restrict__ dst, int nd,
                           const float* __restrict__ src, int ns_pad,
                           Params p, float* __restrict__ out) {
  constexpr int NDK = Keys<V>::nd;
  constexpr int NSK = Keys<V>::ns;
  __shared__ float sh[NSK][CHUNK];

  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < nd;
  const int ii = live ? i : nd - 1;
  float d[NDK];
#pragma unroll
  for (int q = 0; q < NDK; ++q) d[q] = dst[q * nd + ii];

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
#pragma unroll 2
    for (int j = 0; j < CHUNK; ++j) {
      const float tx = d[TDX] - sh[TSX][j];
      const float ty = d[TDY] - sh[TSY][j];
      const float tz = d[TDZ] - sh[TSZ][j];
      const float wp2 = tx * tx + ty * ty + tz * tz + p.rho;
      const float A = d[AD] + sh[AS_][j];
      const float rinv = 1.0f / A;
      const float x = wp2 * rinv * rinv;
      const float poly =
          0.5f - x * (0.125f - x * (0.0625f - 0.0390625f * x));
      const float delta = wp2 * rinv * poly;
      float m;
      if constexpr (V == 0) {
        const float phic = p.kappa_h * delta;
        const float lo2 = d[PHID] + sh[PHIS][j] + p.kappa_l * delta;
        m = lo2 - rintf(lo2) + (phic - rintf(phic));
      } else if constexpr (V == 1) {
        const float phic = sh[KAH][j] * delta;
        const float u = sh[DKS][j] * d[PDH];
        const float lo2 = d[PHID] + sh[PHIS][j] + (u - rintf(u)) +
                          sh[KAL][j] * delta;
        m = lo2 - rintf(lo2) + (phic - rintf(phic));
      } else {
        // exact kappa_s * (L.u)_d via the pre-split two-product
        const float kah = sh[KAH][j], kal = sh[KAL][j];
        const float ka1 = sh[KA1][j], ka2 = sh[KA2][j];
        const float pp = kah * d[PDH];
        const float e = ((ka1 * d[PD1] - pp) + ka1 * d[PD2] + ka2 * d[PD1]) +
                        ka2 * d[PD2];
        const float phic = kah * delta;
        const float lo2 = e + kal * d[PDH] + kah * d[PDL] + sh[PHIS][j] +
                          kal * delta;
        const float c0 = xdd::frac_cycles(pp, lo2);
        m = c0 + (phic - rintf(phic));
      }
      const float c = m - rintf(m);
      float sph, cph;
      xdd::sincos_cycles(c, sph, cph);

      const float lw = d[PDH] - sh[LVH][j];
      const float num = sh[CNS][j] + tx * sh[N0][j] + ty * sh[N1][j] +
                        tz * sh[N2][j] + lw * sh[LNS][j];
      const float pre = (sh[KWNL][j] + num * rinv * sh[KW][j]) * rinv;
      const float U_r = -pre * sph;
      const float U_i = pre * cph;
      const float ax = p.Cx + tx + lw * p.Lx;
      const float ay = p.Cy + ty + lw * p.Ly;
      const float az = p.Cz + tz + lw * p.Lz;
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
      part[4] += g_r * ax;
      part[5] += g_i * ax;
      part[6] += g_r * ay;
      part[7] += g_i * ay;
      part[8] += g_r * az;
      part[9] += g_i * az;
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

// dst: (ndkeys, nd) f32; src: (nskeys, ns_pad) f32 with ns_pad a multiple
// of CHUNK; out: (10, nd) f32.  Returns cudaGetLastError() after launch.
extern "C" int kirchhoff_recentred_launch(int variant, const float* dst,
                                          int nd, const float* src,
                                          int ns_pad,
                                          KirchhoffRecentredParams p,
                                          float* out,
                                          void* stream) {
  if (nd <= 0) return 0;
  if (ns_pad % CHUNK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nd + BLOCK - 1) / BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      kirchhoff_recentred_kernel<0><<<grid, BLOCK, 0, s>>>(dst, nd, src,
                                                           ns_pad, p, out);
      break;
    case 1:
      kirchhoff_recentred_kernel<1><<<grid, BLOCK, 0, s>>>(dst, nd, src,
                                                           ns_pad, p, out);
      break;
    case 2:
      kirchhoff_recentred_kernel<2><<<grid, BLOCK, 0, s>>>(dst, nd, src,
                                                           ns_pad, p, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
