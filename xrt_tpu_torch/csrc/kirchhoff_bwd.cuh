// The one-pass skeleton of the Kirchhoff adjoint kernels (B3), shared by
// csrc/kirchhoff_recentred_bwd.cu and csrc/kirchhoff_ddphase_bwd.cu, which
// give it their pair function as a policy class PF:
//
//   NDK, NSK   key rows of a destination and of a source;
//   RD, RS     distinct cotangent rows of a destination and of a source
//              (hi/lo halves of a key share one row);
//   NPA        scalar cotangents summed over all pairs (0: none);
//   NP         scalars read from the (10,) device buffer (0: none);
//   eval(d, G, s, p, sp, dv)
//              one pair: adds its source and scalar cotangents to sp
//              (RS rows, then NPA), writes its destination cotangents to dv
//              (RD rows); d are the destination's keys, G its ten output
//              cotangents, s the source's keys, p the scalars;
//   dst_row(k), src_row(k)
//              the distinct row that key row k takes its cotangent from;
//   write_params(row, sums)
//              the NPA sums of a block as its row of the ten scalars
//              (needed only where NPA > 0).
//
// What bounds it: f32 instruction issue.  A pair is some 90 operations of
// the forward and ~140 of the reverse sweep whatever the design; the bytes
// are O(Nd + Ns).  The earlier design took two passes over the pairs (one
// owning destinations, one owning sources), so every pair was evaluated
// twice; here it is evaluated once.
//
// Design, one pass, no atomics:
//  * a thread owns a source (the side with more cotangent rows): its keys
//    in registers, its per-chunk cotangent sums in registers, their running
//    sums in shared memory.  A block owns a tile of BLOCK sources.
//  * destinations, with their ten G, are staged CHUNK at a time in shared
//    memory, one row of NDG floats each, read as 16-byte broadcast loads;
//  * a pair's RD destination cotangents are summed over the warp's 32
//    sources by a transpose-reduce (each shuffle step sends half of the
//    values a lane holds: 8 values in 9 shuffles and 9 adds a lane), then
//    over the block's warps in shared memory in a fixed order;
//  * the grid is (destination slabs) x (source groups).  Block (a, g) runs
//    the tiles g, g + ngroup, ... against the destinations of slab a.  Its
//    destination sums go into the private partial rows dpart[g] (written
//    by the first tile, added to by the later ones, in order); each tile's
//    source sums over the slab into spart[a].  The scalars' sums are reduced
//    per block in double into one row of ppart.  A second kernel
//    (reduce_kernel) adds the partials in a fixed order, in double, and
//    spreads the distinct rows over the key rows.  Nothing depends on the
//    order in which blocks run: the same inputs give the same bits.
// Every chunk's sums are taken apart and then added to the running sums: a
// single running f32 sum over 2e5 terms drifts by ~1e-4.  Padded sources
// have zero fields and weights, and destinations past a slab's end repeat
// its last destination with zero G, so both contribute exact zeros.
#pragma once
#include <cuda_runtime.h>

namespace xbwd {

constexpr int BLOCK = 128;  // sources per tile: one per thread
constexpr int WARPS = BLOCK / 32;
constexpr int CHUNK = 64;   // destinations staged per step
constexpr unsigned FULL = 0xffffffffu;

// The warp's sums of eight values: on return, lane l holds the sum over
// the 32 lanes of value (l >> 2) & 7.
__device__ __forceinline__ float transpose_reduce8(float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  bool up = lane & 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = up ? v[i] : v[i + 4];
    const float keep = up ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 16);
  }
  up = lane & 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up ? v[i] : v[i + 2];
    const float keep = up ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  up = lane & 4;
  {
    const float send = up ? v[0] : v[1];
    const float keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  v[0] += __shfl_xor_sync(FULL, v[0], 2);
  v[0] += __shfl_xor_sync(FULL, v[0], 1);
  return v[0];
}

// sum of v over the block's threads, in double; valid in thread 0
__device__ __forceinline__ double block_sum(double v, double* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(FULL, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += scratch[w];
  }
  return t;
}

template <class PF>
__global__ void __launch_bounds__(BLOCK)
adjoint_kernel(const float* __restrict__ dst, int nd,
               const float* __restrict__ src, int ns_pad,
               const float* __restrict__ params,
               const float* __restrict__ gout, int slab, int ngroup,
               float* __restrict__ dpart, float* __restrict__ spart,
               double* __restrict__ ppart) {
  constexpr int NDK = PF::NDK, NSK = PF::NSK, RD = PF::RD, RS = PF::RS;
  constexpr int NPA = PF::NPA, NP = PF::NP, NA = RS + NPA;
  constexpr int NDG = (NDK + 10 + 3) / 4 * 4;  // keys, G, padding
  // destinations per transpose-reduce, and the slots each takes
  constexpr int SLOTS = RD <= 4 ? 4 : 8, PER = 8 / SLOTS;
  static_assert(RD <= SLOTS && CHUNK % PER == 0, "reduction layout");
  __shared__ __align__(16) float sd[CHUNK][NDG];
  __shared__ float red[WARPS][CHUNK * SLOTS];
  __shared__ float acc[NA][BLOCK];
  __shared__ double scratch[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int a = blockIdx.x, g = blockIdx.y;
  const int d0 = a * slab, d1 = min(nd, d0 + slab);
  const int ntiles = ns_pad / BLOCK;
  float p[NP > 0 ? NP : 1];
#pragma unroll
  for (int q = 0; q < NP; ++q) p[q] = params[q];
#pragma unroll
  for (int q = 0; q < NA; ++q) acc[q][tid] = 0.0f;

  for (int t = g; t < ntiles; t += ngroup) {
    const int js = t * BLOCK + tid;
    float s[NSK];
#pragma unroll
    for (int q = 0; q < NSK; ++q) s[q] = src[q * ns_pad + js];
    for (int c0 = d0; c0 < d1; c0 += CHUNK) {
      __syncthreads();
      for (int e = tid; e < NDG * CHUNK; e += BLOCK) {
        const int key = e / CHUNK, j = e - key * CHUNK;
        const int i = c0 + j;
        const bool live = i < d1;
        float v = 0.0f;
        if (key < NDK)
          v = dst[key * nd + (live ? i : d1 - 1)];
        else if (key < NDK + 10 && live)
          v = gout[(key - NDK) * nd + i];
        sd[j][key] = v;
      }
      __syncthreads();
      float part[NA];
#pragma unroll
      for (int q = 0; q < NA; ++q) part[q] = 0.0f;
#pragma unroll 2
      for (int j = 0; j < CHUNK; j += PER) {
        float v[8];
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          float dg[NDG];
          const float4* row = reinterpret_cast<const float4*>(sd[j + u]);
#pragma unroll
          for (int q = 0; q < NDG / 4; ++q) {
            const float4 f = row[q];
            dg[4 * q] = f.x;
            dg[4 * q + 1] = f.y;
            dg[4 * q + 2] = f.z;
            dg[4 * q + 3] = f.w;
          }
          float dv[RD];
          PF::eval(dg, dg + NDK, s, p, part, dv);
#pragma unroll
          for (int r = 0; r < SLOTS; ++r)
            v[u * SLOTS + r] = r < RD ? dv[r] : 0.0f;
        }
        const float r = transpose_reduce8(v);
        if ((lane & 3) == 0) red[warp][j * SLOTS + ((lane >> 2) & 7)] = r;
      }
#pragma unroll
      for (int q = 0; q < NA; ++q) acc[q][tid] += part[q];
      __syncthreads();
      // the chunk's destination sums over the warps, in a fixed order,
      // into the group's partial rows
      const bool first = t == g;
      for (int e = tid; e < RD * CHUNK; e += BLOCK) {
        const int r = e / CHUNK, j = e - r * CHUNK;
        const int i = c0 + j;
        if (i >= d1) continue;
        float sum = red[0][j * SLOTS + r];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum += red[w][j * SLOTS + r];
        float* o = dpart + (static_cast<size_t>(g) * RD + r) * nd + i;
        *o = first ? sum : *o + sum;
      }
    }
    // the tile's source sums over the slab
#pragma unroll
    for (int q = 0; q < RS; ++q) {
      spart[(static_cast<size_t>(a) * RS + q) * ns_pad + js] = acc[q][tid];
      acc[q][tid] = 0.0f;
    }
  }
  if constexpr (NPA > 0) {
    double sums[NPA];
#pragma unroll
    for (int q = 0; q < NPA; ++q)
      sums[q] = block_sum(static_cast<double>(acc[RS + q][tid]), scratch);
    if (tid == 0)
      PF::write_params(
          ppart + (static_cast<size_t>(g) * gridDim.x + a) * 10, sums);
  }
}

// The partials summed in a fixed order, in double: ddst (NDK, nd) from
// dpart (ngroup, RD, nd), dsrc (NSK, ns_pad) from spart (nslab, RS, ns_pad).
template <class PF>
__global__ void reduce_kernel(const float* __restrict__ dpart, int ngroup,
                              int nd, float* __restrict__ ddst,
                              const float* __restrict__ spart, int nslab,
                              int ns_pad, float* __restrict__ dsrc) {
  const long long n1 = static_cast<long long>(PF::NDK) * nd;
  const long long n = n1 + static_cast<long long>(PF::NSK) * ns_pad;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    double sum = 0.0;
    if (e < n1) {
      const int k = static_cast<int>(e / nd), i = static_cast<int>(e % nd);
      const float* q = dpart + static_cast<size_t>(PF::dst_row(k)) * nd + i;
      for (int w = 0; w < ngroup; ++w)
        sum += q[static_cast<size_t>(w) * PF::RD * nd];
      ddst[e] = static_cast<float>(sum);
    } else {
      const long long f = e - n1;
      const int k = static_cast<int>(f / ns_pad);
      const int j = static_cast<int>(f % ns_pad);
      const float* q =
          spart + static_cast<size_t>(PF::src_row(k)) * ns_pad + j;
      for (int w = 0; w < nslab; ++w)
        sum += q[static_cast<size_t>(w) * PF::RS * ns_pad];
      dsrc[f] = static_cast<float>(sum);
    }
  }
}

// The pass: grid (nslab, ngroup), slab destinations per slab.  Returns
// cudaGetLastError() after the launch.
template <class PF>
int launch_pass(const float* dst, int nd, const float* src, int ns_pad,
                const float* params, const float* gout, int nslab, int slab,
                int ngroup, float* dpart, float* spart, double* ppart,
                cudaStream_t s) {
  if (nd <= 0 || ns_pad <= 0 || ns_pad % BLOCK != 0 || slab <= 0 ||
      nslab <= 0 || static_cast<long long>(nslab) * slab < nd ||
      static_cast<long long>(nslab - 1) * slab >= nd || ngroup <= 0 ||
      ngroup > ns_pad / BLOCK || ngroup > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  adjoint_kernel<PF><<<dim3(nslab, ngroup), BLOCK, 0, s>>>(
      dst, nd, src, ns_pad, params, gout, slab, ngroup, dpart, spart, ppart);
  return static_cast<int>(cudaGetLastError());
}

template <class PF>
int launch_reduce(const float* dpart, int ngroup, int nd, float* ddst,
                  const float* spart, int nslab, int ns_pad, float* dsrc,
                  cudaStream_t s) {
  if (nd <= 0 || ns_pad <= 0 || ngroup <= 0 || nslab <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(PF::NDK) * nd +
                      static_cast<long long>(PF::NSK) * ns_pad;
  long long blocks = (n + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  reduce_kernel<PF><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      dpart, ngroup, nd, ddst, spart, nslab, ns_pad, dsrc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xbwd
