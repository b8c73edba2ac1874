// Self-test of the double-float device helpers of dd.cuh: applies
// two_sum, two_prod, frac_cycles and sincos_cycles elementwise so that a
// caller can hold them bit for bit against xrt_tpu_torch/ops/dd.py on the
// same inputs.  Not a port of a TPU kernel; it guards the exactness that
// kernels B1 and B2 rest on (an FMA contraction or a roundf would show
// here as a mismatch).  A second entry holds sincosf against sinf / cosf
// on the card.
#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

__global__ void dd_selftest_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   const float* __restrict__ c, int n,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const xdd::dd s = xdd::two_sum(a[i], b[i]);
  const xdd::dd p = xdd::two_prod(a[i], b[i]);
  float sn, cs;
  xdd::sincos_cycles(c[i], sn, cs);
  out[0 * n + i] = s.h;
  out[1 * n + i] = s.l;
  out[2 * n + i] = p.h;
  out[3 * n + i] = p.l;
  out[4 * n + i] = xdd::frac_cycles(a[i], b[i]);
  out[5 * n + i] = sn;
  out[6 * n + i] = cs;
}

// sinf and cosf of x, and the sin and cos that one sincosf gives: kernel
// B2 'exact' takes sincosf only because the two pairs are the same bits
__global__ void sincosf_selftest_kernel(const float* __restrict__ x, int n,
                                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s, c;
  sincosf(x[i], &s, &c);
  out[0 * n + i] = sinf(x[i]);
  out[1 * n + i] = cosf(x[i]);
  out[2 * n + i] = s;
  out[3 * n + i] = c;
}

}  // namespace

// x: (n,) f32; out: (4, n) f32 rows sinf(x), cosf(x), and sincosf(x)'s
// sin and cos.
extern "C" int sincosf_selftest_launch(const float* x, int n, float* out,
                                       void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  sincosf_selftest_kernel<<<(n + block - 1) / block, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(x, n, out);
  return static_cast<int>(cudaGetLastError());
}

// a, b, c: (n,) f32; out: (7, n) f32 rows two_sum(a, b) (2),
// two_prod(a, b) (2), frac_cycles(a, b), sincos_cycles(c) (2).
extern "C" int dd_selftest_launch(const float* a, const float* b,
                                  const float* c, int n, float* out,
                                  void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  dd_selftest_kernel<<<(n + block - 1) / block, block, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, b, c, n, out);
  return static_cast<int>(cudaGetLastError());
}
