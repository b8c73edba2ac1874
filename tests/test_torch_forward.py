"""The forward Kirchhoff kernels (B1, B2) on the CPU: their grid and source
rows, their pair functions, and the double-float product they rest on.

* The wrapper sizes the forward kernels' grid with plain Python
  (``ops.kirchhoff.forward_grid``) and lays the sources out as padded rows
  (``forward_sources``).  Pinned here: the sizes at the main-path shapes
  (2e5 x 2e5, 65536 x 2e5), at the kernels' check size and at the edges
  (one destination, one chunk of sources).
* The pair functions of ``csrc/kirchhoff_recentred.cu`` (mono, narrowband,
  poly) and ``csrc/kirchhoff_ddphase.cu`` ('fast', 'exact') are compiled
  for the host with ``g++ -ffp-contract=off`` against a stub of the CUDA
  runtime (``__fmaf_rn`` as ``fmaf``), summed over all pairs of the
  wrapper's source rows (per 128-source chunk in float32, the chunks in
  double, as the kernel sums them), and held against the plain versions to
  2e-5 of each output's largest magnitude, the limit of the card tests.
  The skeleton around them (tiling, the staging, the partial sums) runs
  only on the card (``tests/test_torch_cuda.py``).
* ``dd.cuh``'s ``two_prod`` takes its error term from one FMA; on the host
  it is held bit for bit against the Dekker product of ``ops/dd.py`` over
  float32 inputs spanning the exponents the kernels see: positions from
  1e-6 to 1e5 mm, their squares, and kappa x r up to ~1e13.
"""
import torch_harness

import ctypes

import numpy as np
import pytest
import torch

from xrt_tpu_torch.ops import dd, kirchhoff as tk
from test_torch_cuda import _args  # the card tests' beamline-like inputs

MODES = ['mono', 'narrowband', 'poly', 'fast', 'exact']


@pytest.mark.parametrize('nd,ns,grid', [
    (200_000, 200_000, (782, 6)),     # hop 1 of the main path
    (65536, 200_000, (256, 16)),      # hop 2
    (8192, 16384, (32, 64)),          # the kernels' check size
    (1, 128, (1, 1)),                 # one destination, one chunk
    (300, 1, (2, 1)),                 # one source: one chunk
    (257, 257, (2, 3)),               # ragged both ways
])
def test_forward_grid(nd, ns, grid):
    rows = tk.forward_sources(torch.zeros((20, ns)))
    ns_pad = rows.shape[0]
    assert ns_pad % tk.FWD_CHUNK == 0 and ns <= ns_pad < ns + tk.FWD_CHUNK
    ntile, ngroup = tk.forward_grid(nd, ns_pad)
    assert (ntile, ngroup) == grid
    # every destination in a tile, every group with a chunk, bounded scratch
    assert (ntile - 1) * tk.FWD_TILE < nd <= ntile * tk.FWD_TILE
    assert 1 <= ngroup <= min(ns_pad // tk.FWD_CHUNK, tk.FWD_MAX_GROUPS)
    assert ngroup * 10 * nd * 4 <= 64 * 2 ** 20


@pytest.mark.parametrize('nk,width', [(20, 20), (23, 24), (24, 24)])
def test_forward_sources_are_padded_rows(nk, width):
    S = torch.randn((nk, 300), generator=torch.Generator().manual_seed(nk))
    rows = tk.forward_sources(S)
    assert rows.shape == (384, width) and rows.is_contiguous()
    assert torch.equal(rows[:300, :nk], S.t())
    assert not rows[300:].any() and not rows[:, nk:].any()


STUB_FORWARD = r"""
#pragma once
namespace xfwd {
template <class PF, class... A> int launch(A...) { return 0; }
template <class... A> int launch_reduce(A...) { return 0; }
}
"""
# every pair of D (NDK, nd) and the source rows (ns_pad, width) through
# PF::eval: a float32 sum per 128-source chunk, the chunks added in double
HARNESS = r"""
#include SRC
template <class PF>
void sums(int nd, int ns_pad, int width, const float* D, const float* rows,
          const float* P, double* out) {
  for (int i = 0; i < nd; ++i) {
    float d[8];
    for (int q = 0; q < PF::NDK; ++q) d[q] = D[q * nd + i];
    double acc[10] = {0};
    for (int c = 0; c < ns_pad; c += 128) {
      float part[10] = {0};
      for (int j = c; j < c + 128; ++j)
        PF::eval(d, rows + static_cast<long>(j) * width, P, part);
      for (int q = 0; q < 10; ++q) acc[q] += part[q];
    }
    for (int q = 0; q < 10; ++q) out[q * nd + i] = acc[q];
  }
}
extern "C" void pair_sums(int v, int nd, int ns_pad, int width,
                          const float* D, const float* rows, const float* P,
                          double* out) {
  if (v == 0) sums<PAIR<0>>(nd, ns_pad, width, D, rows, P, out);
  if (v == 1) sums<PAIR<1>>(nd, ns_pad, width, D, rows, P, out);
#ifdef THIRD
  if (v == 2) sums<PAIR<2>>(nd, ns_pad, width, D, rows, P, out);
#endif
}
"""
TWO_PROD = r"""
#include <cuda_runtime.h>
#include "dd.cuh"
extern "C" void two_prod_rows(const float* a, const float* b, int n,
                              float* p, float* e) {
  for (int i = 0; i < n; ++i) {
    const xdd::dd r = xdd::two_prod(a[i], b[i]);
    p[i] = r.h;
    e[i] = r.l;
  }
}
"""


@pytest.fixture(scope='module')
def host_libs(tmp_path_factory):
    """{name: ctypes library}: the two forward sources and dd.cuh's
    two_prod, built for the host."""
    libs = {scheme: torch_harness.host_build(
        tmp_path_factory, scheme,
        {'harness.cpp': HARNESS, 'kirchhoff_fwd.cuh': STUB_FORWARD},
        headers=('dd.cuh', f'kirchhoff_{scheme}.cu'),
        defines=(f'SRC="kirchhoff_{scheme}.cu"', f'PAIR={pair}') +
        (('THIRD',) if third else ()))
        for scheme, pair, third in (('recentred', 'RecentredPair', True),
                                    ('ddphase', 'DDPair', False))}
    libs['two_prod'] = torch_harness.host_build(
        tmp_path_factory, 'two_prod', {'two_prod.cpp': TWO_PROD},
        headers=('dd.cuh',))
    return libs


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize('mode', MODES)
def test_pair_functions_match_the_plain_version(host_libs, mode):
    Nd, Ns = 1000, 3000
    args = _args('cpu', poly=mode != 'mono', Ns=Ns, Nd=Nd)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    rows = tk.forward_sources(S)
    arrs = [np.ascontiguousarray(t.numpy(), np.float32)
            for t in (D, rows, torch.zeros(10) if P is None else P)]
    out = np.zeros((10, Nd))
    host_libs[scheme].pair_sums(ctypes.c_int(v), ctypes.c_int(Nd),
                                ctypes.c_int(rows.shape[0]),
                                ctypes.c_int(rows.shape[1]),
                                *[_ptr(a) for a in arrs + [out]])
    ref = tk._plain_rows(scheme, v, D, S, P).double().numpy()
    got = out[0::2] + 1j * out[1::2]
    want = ref[0::2] + 1j * ref[1::2]
    rel = max(float(np.abs(g - w).max() / np.abs(w).max())
              for g, w in zip(got, want))
    assert rel < 2e-5, rel


def _spanning_inputs(n=200_000, seed=0):
    """Float32 factors whose products span what the kernels form: position
    differences of 1e-6 to 1e5 mm against each other and themselves, and
    kappa (1e6 to 1e8 per mm) against r (1e2 to 1e5 mm)."""
    rng = np.random.RandomState(seed)

    def logu(lo, hi, m):
        sign = rng.choice([-1.0, 1.0], m)
        return (sign * 10.0 ** rng.uniform(lo, hi, m)).astype(np.float32)
    m = n // 4
    pos_a, pos_b = logu(-6, 5, m), logu(-6, 5, m)
    sq = logu(-6, 5, m)
    kap, r = np.abs(logu(6, 8, m)), np.abs(logu(2, 5, m))
    mid = (rng.uniform(-1e4, 1e4, m).astype(np.float32),
           rng.uniform(-1, 1, m).astype(np.float32))
    a = np.concatenate([pos_a, sq, kap, mid[0]])
    b = np.concatenate([pos_b, sq, r, mid[1]])
    return a, b


def test_fma_two_prod_is_the_dekker_product(host_libs):
    a, b = _spanning_inputs()
    n = a.size
    p, e = np.empty(n, np.float32), np.empty(n, np.float32)
    host_libs['two_prod'].two_prod_rows(_ptr(a), _ptr(b), ctypes.c_int(n),
                                        _ptr(p), _ptr(e))
    rp, re = dd.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(p.view(np.int32), rp.numpy().view(np.int32))
    assert np.array_equal(e.view(np.int32), re.numpy().view(np.int32))
    # and the pair is exact: p + e is the float64 product
    assert np.array_equal(p.astype(np.float64) + e.astype(np.float64),
                          a.astype(np.float64) * b.astype(np.float64))

