// The forward skeleton of the Kirchhoff kernels B1 and B2, shared by
// csrc/kirchhoff_recentred.cu and csrc/kirchhoff_ddphase.cu, which give it
// their pair function as a policy class PF:
//
//   NDK, NSK   key rows of a destination and of a source;
//   NP         scalars read from the (10,) device buffer (0: none);
//   eval(d, s, p, acc)
//              one pair: adds its ten contributions (Es, Ep re/im, the
//              a/b/c direction integrals re/im) to acc; d are the
//              destination's keys, s the source's, p the scalars.
//
// What bounds it: the SMs' f32 instruction rate.  A pair is ~100 SASS
// instructions (B1 mono) to ~300 (B2 'exact', its sin and cos included)
// of arithmetic whatever the layout; the bytes are O(Nd + Ns).  So the
// skeleton adds as few instructions a pair as it can, and fills the card
// at both main-path hops.
//
// Design:
//  * a thread owns R = 2 destinations: their keys, per-chunk sums and
//    running sums stay in registers; a block owns a tile of R x BLOCK
//    destinations;
//  * the sources are rows of their keys padded to a multiple of 4 floats
//    (made by the wrapper in one copy per launch), staged CHUNK at a time
//    in shared memory and read as 16-byte broadcast loads: the 5 or 6
//    LDS.128 of a source serve R pairs;
//  * the next chunk is in flight (cp.async, 16 bytes a copy, into the
//    second of two buffers) while this one is summed; one barrier a chunk;
//  * the grid is (destination tiles) x (source groups), sized by the
//    wrapper (ops/kirchhoff.py forward_grid) to several full waves at both
//    hops.  Group g takes the chunks g, g + ngroup, ... and writes its sums
//    into its own partial rows part[g] (ngroup, 10, nd); a second kernel
//    (reduce_kernel) adds them in a fixed order in double.  No atomics:
//    the same inputs give the same bits.
// Every chunk's sums are taken apart and then added to the running sums: a
// single running f32 sum over 2e5 sources drifts by ~1e-4.  Padded sources
// have zero fields and weights, and destinations past the end repeat the
// last one and are not written, so both contribute nothing.
#pragma once
#include <cuda_runtime.h>

namespace xfwd {

constexpr int BLOCK = 128;  // threads a block
constexpr int R = 2;        // destinations a thread
constexpr int TILE = R * BLOCK;
constexpr int CHUNK = 128;  // sources staged a step

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <class PF>
__global__ void __launch_bounds__(BLOCK)
forward_kernel(const float* __restrict__ dst, int nd,
               const float4* __restrict__ src, int nchunk,
               const float* __restrict__ params, int ngroup,
               float* __restrict__ part) {
  constexpr int NDK = PF::NDK, NP = PF::NP;
  constexpr int Q = (PF::NSK + 3) / 4;  // float4 a source row
  __shared__ float4 sh[2][CHUNK * Q];
  const int tid = threadIdx.x, g = blockIdx.y;
  float p[NP > 0 ? NP : 1];
#pragma unroll
  for (int q = 0; q < NP; ++q) p[q] = params[q];
  float d[R][NDK], acc[R][10];
  int idx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    idx[r] = blockIdx.x * TILE + r * BLOCK + tid;
    const int i = min(idx[r], nd - 1);
#pragma unroll
    for (int q = 0; q < NDK; ++q) d[r][q] = dst[q * nd + i];
#pragma unroll
    for (int q = 0; q < 10; ++q) acc[r][q] = 0.0f;
  }

  auto stage = [&](int c, int buf) {
    const float4* from = src + static_cast<size_t>(c) * CHUNK * Q;
    for (int e = tid; e < CHUNK * Q; e += BLOCK)
      cp_async16(&sh[buf][e], from + e);
    cp_async_commit();
  };
  int buf = 0;
  if (g < nchunk) stage(g, 0);
  for (int c = g; c < nchunk; c += ngroup, buf ^= 1) {
    // chunk c has landed, and every thread is done with the other buffer
    cp_async_wait_all();
    __syncthreads();
    if (c + ngroup < nchunk) stage(c + ngroup, buf ^ 1);
    float sum[R][10];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 10; ++q) sum[r][q] = 0.0f;
#pragma unroll 1
    for (int j = 0; j < CHUNK; ++j) {
      float s[4 * Q];
      const float4* row = &sh[buf][j * Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 f = row[q];
        s[4 * q] = f.x;
        s[4 * q + 1] = f.y;
        s[4 * q + 2] = f.z;
        s[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) PF::eval(d[r], s, p, sum[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 10; ++q) acc[r][q] += sum[r][q];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (idx[r] >= nd) continue;
#pragma unroll
    for (int q = 0; q < 10; ++q)
      part[(static_cast<size_t>(g) * 10 + q) * nd + idx[r]] = acc[r][q];
  }
}

// out (10, nd) = the sum over g of part (ngroup, 10, nd), in a fixed order,
// in double.
__global__ void reduce_kernel(const float* __restrict__ part, int ngroup,
                              int nd, float* __restrict__ out) {
  const long long n = 10LL * nd;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    double sum = 0.0;
    for (int w = 0; w < ngroup; ++w) sum += part[w * n + e];
    out[e] = static_cast<float>(sum);
  }
}

// The pass: grid (ceil(nd / TILE), ngroup) over the source rows src
// (ns_pad, 4 * ceil(NSK / 4)) floats, ns_pad a multiple of CHUNK.  Returns
// cudaGetLastError() after the launch.
template <class PF>
int launch(const float* dst, int nd, const float* src, int ns_pad,
           const float* params, int ngroup, float* part, cudaStream_t s) {
  if (nd <= 0 || ns_pad <= 0 || ns_pad % CHUNK != 0 || ngroup <= 0 ||
      ngroup > ns_pad / CHUNK || ngroup > 65535 || (PF::NP > 0 && !params))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nd + TILE - 1) / TILE, ngroup);
  forward_kernel<PF><<<grid, BLOCK, 0, s>>>(
      dst, nd, reinterpret_cast<const float4*>(src), ns_pad / CHUNK, params,
      ngroup, part);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_reduce(const float* part, int ngroup, int nd, float* out,
                         cudaStream_t s) {
  if (nd <= 0 || ngroup <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (10LL * nd + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(part, ngroup,
                                                              nd, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xfwd
