// Atomic adds on an H100, by themselves: 1e7 keys (uniform over 128 x 128
// bins, or 95% in four bins) of 4 64-bit values each, added
//   * to device memory (RED.E.ADD.64 in the L2),
//   * to a 128 x 128 table split over the shared memory of a cluster of 4
//     CTAs (distributed shared memory),
//   * to a CTA's own 32 x 128 table of 64-bit words in shared memory,
//   * as floats to a CTA's own 32 x 128 table (as the float-atomics
//     histogram kernel did),
// each with and without warp sums first (__match_any_sync).  Keys and
// values come from a hash of the index: no loads, only the adds.  Build
// and run on the card, and read which adds are native in the SASS:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -o build/atomics_probe tools/torch_atomics_probe.cu
//   build/atomics_probe
//   cuobjdump -sass build/atomics_probe | grep -oE '(ATOMS|ATOM|RED)[A-Z0-9._]*' | sort | uniq -c
#include <cstdio>
#include <cstdint>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
typedef unsigned long long u64;
constexpr int NC = 4;
__device__ __forceinline__ uint32_t hsh(uint32_t a) {
  a ^= a >> 16; a *= 0x7feb352d; a ^= a >> 15; a *= 0x846ca68b; a ^= a >> 16; return a;
}
// key in [0, 128*128) ; focused: 95% into 4 bins
__device__ __forceinline__ int key_of(long long i, int focused) {
  uint32_t h = hsh((uint32_t)i * 2654435761u + 12345u);
  if (focused && (h % 100) < 95) return (h >> 8) & 3;
  return (h >> 8) & (128 * 128 - 1);
}
__device__ __forceinline__ void vals(long long i, u64* v) {
  uint32_t h = hsh((uint32_t)i ^ 0x9e3779b9u);
  for (int c = 0; c < NC; ++c) v[c] = ((u64)(h + c * 77) << 8) + 1;
}
template <class F>
__device__ __forceinline__ void agg(int key, u64* v, F sink) {
  const unsigned lane = threadIdx.x & 31;
  unsigned peers = __match_any_sync(0xffffffffu, key);
  const int first = __ffs(peers) - 1;
  int rel = __popc(peers & ((1u << lane) - 1));
  peers &= (lane == 31) ? 0u : (0xfffffffeu << lane);
  while (__any_sync(0xffffffffu, peers)) {
    const int next = __ffs(peers);
    u64 t[NC];
    for (int c = 0; c < NC; ++c) t[c] = __shfl_sync(0xffffffffu, v[c], next ? next - 1 : 0);
    if (next) for (int c = 0; c < NC; ++c) v[c] += t[c];
    const int done = rel & 1;
    peers &= ~__ballot_sync(0xffffffffu, done);
    rel >>= 1;
  }
  if ((int)lane == first && key >= 0) sink(key, v);
}
__global__ void k_global(u64* tab, long long n, int focused, int ag) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i - threadIdx.x < n; i += (long long)gridDim.x * blockDim.x) {
    int key = i < n ? key_of(i, focused) : -1; u64 v[NC]; vals(i, v);
    auto sink = [&](int k, u64* w) { for (int c = 0; c < NC; ++c) atomicAdd(tab + k * NC + c, w[c]); };
    if (ag) agg(key, v, sink); else if (key >= 0) sink(key, v);
  }
}
__global__ void __cluster_dims__(4, 1, 1) k_cluster(u64* tab, long long n, int focused, int ag) {
  extern __shared__ u64 sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rows = 32, per = rows * 128 * NC;
  for (int j = threadIdx.x; j < per; j += blockDim.x) sm[j] = 0;
  cl.sync();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i - threadIdx.x < n; i += (long long)gridDim.x * blockDim.x) {
    int key = i < n ? key_of(i, focused) : -1; u64 v[NC]; vals(i, v);
    auto sink = [&](int k, u64* w) {
      const int r = (k >> 7) / rows; u64* d = cl.map_shared_rank(sm, r) + (k - r * rows * 128) * NC;
      for (int c = 0; c < NC; ++c) atomicAdd(d + c, w[c]); };
    if (ag) agg(key, v, sink); else if (key >= 0) sink(key, v);
  }
  cl.sync();
  const int r = cl.block_rank();
  for (int j = threadIdx.x; j < per; j += blockDim.x) if (sm[j]) atomicAdd(tab + r * per + j, sm[j]);
}
__global__ void k_shared64(u64* tab, long long n, int focused, int ag) {  // 32x128 table, one CTA
  extern __shared__ u64 sm[];
  const int per = 32 * 128 * NC;
  for (int j = threadIdx.x; j < per; j += blockDim.x) sm[j] = 0;
  __syncthreads();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i - threadIdx.x < n; i += (long long)gridDim.x * blockDim.x) {
    int key = i < n ? (key_of(i, focused) & (32 * 128 - 1)) : -1; u64 v[NC]; vals(i, v);
    auto sink = [&](int k, u64* w) { for (int c = 0; c < NC; ++c) atomicAdd(sm + k * NC + c, w[c]); };
    if (ag) agg(key, v, sink); else if (key >= 0) sink(key, v);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < per; j += blockDim.x) if (sm[j]) atomicAdd(tab + j, sm[j]);
}
__global__ void k_sharedf(float* tab, long long n, int focused) {  // float atomics, 32x128x4 floats
  extern __shared__ float smf[];
  const int per = 32 * 128 * NC;
  for (int j = threadIdx.x; j < per; j += blockDim.x) smf[j] = 0;
  __syncthreads();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    int key = key_of(i, focused) & (32 * 128 - 1); u64 v[NC]; vals(i, v);
    for (int c = 0; c < NC; ++c) atomicAdd(smf + key * NC + c, (float)v[c]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < per; j += blockDim.x) if (smf[j] != 0.f) atomicAdd(tab + j, smf[j]);
}
int main() {
  const long long n = 10000000; int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  u64* tab; cudaMalloc(&tab, 128 * 128 * NC * 8);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  int cl_smem = 32 * 128 * NC * 8, sh_smem = 32 * 128 * NC * 8;
  printf("set attr %d\n", (int)cudaFuncSetAttribute(k_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, cl_smem));
  cudaFuncSetAttribute(k_shared64, cudaFuncAttributeMaxDynamicSharedMemorySize, sh_smem);
  cudaFuncSetAttribute(k_sharedf, cudaFuncAttributeMaxDynamicSharedMemorySize, sh_smem / 2);
  for (int focused = 0; focused < 2; ++focused) for (int ag = 0; ag < 2; ++ag) {
    for (int which = 0; which < 4; ++which) {
      if (which == 3 && ag) continue;
      float best = 1e9;
      for (int rep = 0; rep < 6; ++rep) {
        cudaMemset(tab, 0, 128 * 128 * NC * 8);
        cudaEventRecord(a);
        if (which == 0) k_global<<<sms * 2, 1024>>>(tab, n, focused, ag);
        if (which == 1) k_cluster<<<(sms / 4) * 4, 1024, cl_smem>>>(tab, n, focused, ag);
        if (which == 2) k_shared64<<<sms, 1024, sh_smem>>>(tab, n, focused, ag);
        if (which == 3) k_sharedf<<<sms, 1024, sh_smem / 2>>>((float*)tab, n, focused);
        cudaEventRecord(b); cudaEventSynchronize(b);
        float ms; cudaEventElapsedTime(&ms, a, b); if (rep) best = ms < best ? ms : best;
      }
      const char* nm[] = {"global-L2 128x128", "cluster4 DSMEM 128x128", "shared64 one CTA 32x128", "sharedf32 32x128"};
      printf("focused=%d agg=%d %-34s %.4f ms err=%s\n", focused, ag, nm[which], best, cudaGetErrorString(cudaGetLastError()));
    }
  }
  return 0;
}
