// Accumulation shared by the histogram kernels (csrc/hist2d.cu, the weighted
// histogram B4; csrc/hist_plot.cu, a plot's eight histograms): fixed-point
// integer sums whose bits do not depend on the order of the adds, and the
// two places a table can live.
//
// What the card offers, measured on an H100 (sm_90a,
// tools/torch_hist_compare.py): a 64-bit add on shared memory, and a float
// add too, compile to a compare-and-swap loop (ATOMS.CAST.SPIN); a 32-bit
// integer add is one native ATOMS.ADD; a 64-bit add to device memory is
// one native RED.E.ADD.64, carried out in the L2.  So:
//
// * A weight w enters as the integer q = w * 2^e rounded to nearest
//   (hist_ray.cuh: to_fixed, fixed_exp): integer adds are exact, so any
//   order gives the same sum.  e comes from m, the largest finite |w| of
//   the launch, found by a first pass on the device (no host read).
// * A table that fits a CTA's shared memory gets a private copy of its low
//   words in every CTA (route kShared), 4 bytes a sum, added with native
//   32-bit atomics (hist_ray.cuh: add_low).  An add returns the old low
//   word, which tells whether it carried; the high half of q plus the
//   carry goes to the sum in device memory as a multiple of 2^32, and at
//   the end every CTA adds its low words there.  That is the exact sum
//   modulo 2^64, and the true sum never leaves +-2^63.  A float32 weight is
//   scaled to 28 bits (scale_count), so at most one add in 16 carries.
// * A larger table lives in device memory (kGlobal), with native 64-bit
//   adds.  There the lanes of a warp whose rays fall into one bin first
//   add their values by shuffles (__match_any_sync) and one lane adds the
//   sum: a focused beam would otherwise queue 32 adds to one word in the
//   L2.  A bin's columns share one 32-byte sector (4 columns; 3 are
//   padded to 4), and the lanes of a warp add one ray's columns together.
//   A table split over the shared memory of a cluster of 4 CTAs (adds to
//   another CTA's part through distributed shared memory) measured slower
//   than device memory at the main path's shapes, and is not used.
// * Non-finite weights cannot be held as integers.  They set flag bits of
//   their bin in device memory instead (rare: an atomicOr off the main
//   path), and the conversion pass turns a flagged bin into the NaN or
//   infinity a float sum would give.
#pragma once
#include <cuda_runtime.h>

#include "hist_ray.cuh"

namespace xhist {

typedef unsigned long long u64;

constexpr int THREADS = 1024;
// the most dynamic shared memory a block may use on sm_90
constexpr int MAX_SHARED_BYTES = 232448;
// consecutive rays a thread loads per step (16 bytes of float32)
constexpr int RAYS = 4;

// where a table lives: a private copy in each CTA's shared memory, or
// device memory
enum Route : int { kShared = 0, kGlobal = 1 };

// The sums of v over the lanes of the warp that hold the same key; true in
// the one lane (the lowest) that is to add them, with v holding the sums,
// unless the key is negative (outside).  All 32 lanes must call it.  A
// tree over each group's lanes (log2 of its size steps; none when every
// key differs).
template <int NC>
__device__ __forceinline__ bool warp_sum(int key, long long (&v)[NC]) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned peers = __match_any_sync(0xffffffffu, key);
  const int first = __ffs(peers) - 1;
  int rel = __popc(peers & ((1u << lane) - 1u));  // rank in the group
  peers &= lane == 31u ? 0u : 0xfffffffeu << lane;  // the higher peers
  while (__any_sync(0xffffffffu, peers != 0u)) {
    const int next = __ffs(peers);  // 1 + the next higher peer, 0 if none
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const long long t = __shfl_sync(0xffffffffu, v[c], next ? next - 1 : 0);
      if (next) v[c] += t;
    }
    // every other remaining lane has been added into a lower one
    peers &= ~__ballot_sync(0xffffffffu, rel & 1);
    rel >>= 1;
  }
  return key >= 0 && static_cast<int>(lane) == first;
}

// The low words of a table of `bins` bins and NC columns in shared memory,
// one plane a column (word c bins + b: column c of bin b), so the lanes of
// a warp that add one column to random bins hit random banks.  Every lane
// adds its own values: the card serialises adds to one word in one
// instruction, and warp sums before them cost more than they save
// (measured: 0.095 against 0.150 ms for 1e7 rays into 128 x 128, 0.095
// against 0.132 ms with 95% of them in four bins).  The high parts go to
// dst, the bin's NC columns in device memory.  Zeros are not added.
template <int NC>
__device__ __forceinline__ void smem_add(unsigned* tab, int bins, int key,
                                         const long long (&v)[NC],
                                         long long* dst) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (v[c] == 0) continue;
    const long long h = add_low(tab + c * bins + key, v[c]);
    if (h != 0)
      atomicAdd(reinterpret_cast<u64*>(dst + c), static_cast<u64>(h) << 32);
  }
}

// The sums v of bin `key` (-1: nothing) into a device-memory table: NC = 1
// one column a bin, else four (NC <= 4).  All 32 lanes must call it: lane
// L adds column L % 4 of lane 8 s + L / 4's bin in step s, so one request
// covers 8 bins' sectors, not 32.
template <int NC>
__device__ __forceinline__ void global_add(long long* tab, int key,
                                           const long long (&v)[NC]) {
  if constexpr (NC == 1) {
    if (key >= 0 && v[0] != 0)
      atomicAdd(reinterpret_cast<u64*>(tab + key), static_cast<u64>(v[0]));
  } else {
    const int lane = threadIdx.x & 31, col = lane & 3;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int src = 8 * s + (lane >> 2);
      const int k = __shfl_sync(0xffffffffu, key, src);
      long long q = 0;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const long long t = __shfl_sync(0xffffffffu, v[c], src);
        if (c == col) q = t;
      }
      if (k >= 0 && q != 0)
        atomicAdd(reinterpret_cast<u64*>(tab + 4 * k + col),
                  static_cast<u64>(q));
    }
  }
}

// The fine words v of bin `key` (-1: nothing) into a device-memory table
// laid out as global_add's.  When many lanes of the warp hold fine words
// (`many`, the same in every lane; all 32 lanes must then call it) they
// are summed over the warp first, else each lane adds its own: a main-path
// beam has a few faint colour weights in most warps, a powder's are
// nearly all faint.  Integer adds: the same sums either way.
template <int NC>
__device__ __forceinline__ void fine_add(long long* tab, int key,
                                         long long (&v)[NC], bool many) {
  if (many) {
    const bool lead = warp_sum<NC>(key, v);
    global_add<NC>(tab, lead ? key : -1, v);
    return;
  }
  if (key < 0) return;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (v[c] != 0)
      atomicAdd(reinterpret_cast<u64*>(tab + (NC == 1 ? key : 4 * key + c)),
                static_cast<u64>(v[c]));
}

// lanes of a warp with fine words above which fine_add sums over the warp
constexpr int FINE_WARP_LANES = 8;

// Adds the low words of a shared-memory table of `bins` bins and NC
// columns to dst, whose bin b column c is dst[KP b + c]; the non-zero ones.
template <int NC, int KP>
__device__ __forceinline__ void merge_table(const unsigned* tab, int bins,
                                            long long* dst) {
  for (long long j = threadIdx.x; j < static_cast<long long>(bins) * NC;
       j += blockDim.x) {
    const long long b = j / NC;
    const int c = static_cast<int>(j - b * NC);
    const unsigned w = tab[c * bins + b];
    if (w != 0u)
      atomicAdd(reinterpret_cast<u64*>(dst + KP * b + c), static_cast<u64>(w));
  }
}

// 16 bytes of a one-touch stream, evict-first
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 t = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = t.x;
  v[1] = t.y;
}

// m values of a stream from p[i]: 16-byte loads when `vec` (p 16-byte
// aligned, i a multiple of 16 bytes) and all m lie before n, else one by
// one, zeros past n
template <typename T, int M>
__device__ __forceinline__ void load_run(const T* p, long long i, long long n,
                                         bool vec, T* v) {
  constexpr int E = 16 / sizeof(T);
  if (vec && i + M <= n) {
#pragma unroll
    for (int e = 0; e < M; e += E) load16(p + i + e, v + e);
  } else {
#pragma unroll
    for (int e = 0; e < M; ++e) v[e] = i + e < n ? __ldcs(p + i + e) : T(0);
  }
}

// RAYS mask bytes from m[i] (one 4-byte load when `vec`), false past n
__device__ __forceinline__ void load_mask(const bool* m, long long i,
                                          long long n, bool vec, bool* v) {
  if (vec && i + RAYS <= n) {
    const unsigned u = __ldcs(reinterpret_cast<const unsigned*>(m + i));
#pragma unroll
    for (int r = 0; r < RAYS; ++r) v[r] = (u >> (8 * r)) & 0xffu;
  } else {
#pragma unroll
    for (int r = 0; r < RAYS; ++r) v[r] = i + r < n && m[i + r];
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<u64>(p) % 16 == 0;
}

// the largest of v over the block's threads into *out (a double's bits;
// non-negative doubles order as their bits do)
__device__ __forceinline__ void block_max_into(double v, u64* out) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0 && v > 0.0)
    atomicMax(out, static_cast<u64>(__double_as_longlong(v)));
}

// the sum of v over the block's threads added to *out
__device__ __forceinline__ void block_sum_into(long long v, long long* out) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0 && v != 0)
    atomicAdd(reinterpret_cast<u64*>(out), static_cast<u64>(v));
}

__device__ __forceinline__ double max_of(const u64* bits) {
  return __longlong_as_double(static_cast<long long>(*bits));
}

// Faint float32 weights (hist_ray.cuh: residual): |w| of a weight w below
// 2^17 units of scale 2^e that has a rounding residual, else 0
__device__ __forceinline__ float faint_of(float w, double scale) {
  if (!isfinite(w)) return 0.0f;
  return residual(w, to_fixed(w, scale), scale) != 0.0 ? fabsf(w) : 0.0f;
}

// a bin's largest faint |w| into *slot, kept as a float's bits
// (non-negative floats order as their bits do)
__device__ __forceinline__ void faint_max(unsigned* slot, float v) {
  if (v > 0.0f) atomicMax(slot, __float_as_uint(v));
}

// the fine exponent of a sum whose largest faint |w| is *slot (0: none),
// for n weights: 28 bits a weight, as the coarse word's (scale_count), so
// that a fine word too fits a shared low word but for one add in 16
__device__ __forceinline__ int faint_exp(const unsigned* slot, long long n) {
  return fixed_exp(static_cast<double>(__uint_as_float(*slot)),
                   scale_count<float>(n));
}

// the fine word of residual r (0: none) at the fine exponent of *slot
__device__ __forceinline__ long long fine_at(double r, const unsigned* slot,
                                             int e, long long n) {
  return r == 0.0 ? 0 : fine_fixed(r, faint_exp(slot, n), e);
}

// the largest of v over the block's threads into *slot (faint_max)
__device__ __forceinline__ void block_faint_max(float v, unsigned* slot) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) faint_max(slot, v);
}

// Blocks for a grid-stride kernel of `threads` threads a block over
// `groups` work items: as many as the card holds at once (`per_sm`), no
// more than the items need.
inline int grid_blocks(long long groups, int threads, int per_sm, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long b = (groups + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(b < 1 ? 1 : (b > cap ? cap : b));
  return 0;
}

// Launches `kernel` over `groups` items with `smem` bytes of dynamic
// shared memory a block, as many blocks as fit at once.  Returns the
// launch's error.
template <typename K, typename A>
int launch_kernel(K kernel, long long groups, int smem, cudaStream_t s,
                  const A& args) {
  if (smem > MAX_SHARED_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0, blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int e = grid_blocks(groups, THREADS, per_sm, &blocks);
  if (e) return e;
  kernel<<<blocks, THREADS, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xhist
