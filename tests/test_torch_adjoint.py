"""The one-pass adjoint kernels (B3) on the CPU: their grid and scratch,
and their pair functions.

* The wrapper sizes the kernels' grid and scratch with plain Python
  (``ops.kirchhoff.adjoint_grid`` / ``adjoint_scratch``).  Pinned here: the
  sizes at the main-path shape (2e5 x 2e5, scratch within 2 GiB) and at
  the edges (one destination, one tile of sources, a ragged slab).
* The pair functions of ``csrc/kirchhoff_recentred_bwd.cu`` and
  ``csrc/kirchhoff_ddphase_bwd.cu`` (the forward pair and its reverse
  sweep, ``eval``; the row maps; the scalars' row) are compiled for the
  host with ``g++ -ffp-contract=off`` against a stub of the CUDA runtime
  and summed over all pairs in double, then held against the plain blocked
  backward to 1e-4 of each row's largest magnitude, the limit of the card
  tests.  The skeleton around them (tiling, the transpose-reduce, the
  partial sums) runs only on the card (``tests/test_torch_cuda.py``).
"""
import torch_harness

import ctypes
import math

import numpy as np
import pytest
import torch

from xrt_tpu_torch.ops import kirchhoff as tk
from test_torch_cuda import _args  # the card tests' beamline-like inputs

VARIANTS = [('recentred', 0), ('recentred', 1), ('recentred', 2),
            ('ddphase', 0), ('ddphase', 1)]


def _padded(ns):
    return -(-ns // tk.KERNEL_SRC_CHUNK) * tk.KERNEL_SRC_CHUNK


def _bytes(shapes):
    d, s, p = shapes
    return 4 * (math.prod(d) + math.prod(s)) + (8 * math.prod(p) if p else 0)


@pytest.mark.parametrize('scheme,variant', VARIANTS)
def test_scratch_at_the_main_path_shape(scheme, variant):
    nd, ns_pad = 200_000, _padded(200_000)
    assert tk.adjoint_grid(nd, ns_pad) == (32, 6272, 128)
    shapes = tk.adjoint_scratch(scheme, variant, nd, ns_pad)
    rd, rs = tk._ADJ_ROWS[(scheme, variant)]
    assert shapes[0] == (128, rd, nd) and shapes[1] == (32, rs, ns_pad)
    assert shapes[2] == ((32 * 128, 10) if scheme == 'recentred' else None)
    assert _bytes(shapes) <= 2 * 2 ** 30


@pytest.mark.parametrize('nd,ns_pad,grid', [
    (1, 256, (1, 64, 2)),             # one destination
    (33, 128, (1, 64, 1)),            # a grid of one block
    (129, 512, (3, 64, 4)),           # ragged last slab
    (8192, 16384, (32, 256, 128)),    # the kernels' check size
    (65536, _padded(200_000), (32, 2048, 128)),
])
def test_grid_at_the_edges(nd, ns_pad, grid):
    nslab, slab, ngroup = tk.adjoint_grid(nd, ns_pad)
    assert (nslab, slab, ngroup) == grid
    # every destination in exactly one slab, every tile in a group
    assert slab % tk.ADJ_CHUNK == 0
    assert (nslab - 1) * slab < nd <= nslab * slab
    assert 1 <= ngroup <= ns_pad // tk.ADJ_TILE
    assert nslab * ngroup < tk.ADJ_TARGET_BLOCKS + ngroup


STUB_SKELETON = r"""
#pragma once
namespace xbwd {
template <class PF, class... A> int launch_pass(A...) { return 0; }
template <class PF, class... A> int launch_reduce(A...) { return 0; }
}
"""
# every pair of D (NDK, nd) and S (NSK, ns) through PF::eval, summed in
# double, spread over the key rows with the row maps
HARNESS = r"""
#include <vector>
#include SRC
template <class PF>
void sums(int nd, int ns, const float* D, const float* S, const float* P,
          const float* G, double* bD, double* bS, double* bP) {
  std::vector<double> dD(PF::RD * nd), dS(PF::RS * ns), pa(PF::NPA + 1);
  for (int i = 0; i < nd; ++i) {
    float d[8], g[10];
    for (int q = 0; q < PF::NDK; ++q) d[q] = D[q * nd + i];
    for (int q = 0; q < 10; ++q) g[q] = G[q * nd + i];
    for (int j = 0; j < ns; ++j) {
      float s[24], sp[40] = {0}, dv[8];
      for (int q = 0; q < PF::NSK; ++q) s[q] = S[q * ns + j];
      PF::eval(d, g, s, P, sp, dv);
      for (int r = 0; r < PF::RD; ++r) dD[r * nd + i] += dv[r];
      for (int r = 0; r < PF::RS; ++r) dS[r * ns + j] += sp[r];
      for (int q = 0; q < PF::NPA; ++q) pa[q] += sp[PF::RS + q];
    }
  }
  for (int k = 0; k < PF::NDK; ++k)
    for (int i = 0; i < nd; ++i) bD[k * nd + i] = dD[PF::dst_row(k) * nd + i];
  for (int k = 0; k < PF::NSK; ++k)
    for (int j = 0; j < ns; ++j) bS[k * ns + j] = dS[PF::src_row(k) * ns + j];
  if constexpr (PF::NPA > 0) PF::write_params(bP, pa.data());
}
extern "C" void pair_sums(int v, int nd, int ns, const float* D,
                          const float* S, const float* P, const float* G,
                          double* bD, double* bS, double* bP) {
  if (v == 0) sums<PAIR<0>>(nd, ns, D, S, P, G, bD, bS, bP);
  if (v == 1) sums<PAIR<1>>(nd, ns, D, S, P, G, bD, bS, bP);
#ifdef THIRD
  if (v == 2) sums<PAIR<2>>(nd, ns, D, S, P, G, bD, bS, bP);
#endif
}
"""


@pytest.fixture(scope='module')
def pair_libs(tmp_path_factory):
    """{scheme: ctypes library} of the two adjoint sources, built for the
    host."""
    return {scheme: torch_harness.host_build(
        tmp_path_factory, f'{scheme}_bwd',
        {'harness.cpp': HARNESS, 'kirchhoff_bwd.cuh': STUB_SKELETON},
        headers=('dd.cuh', f'kirchhoff_{scheme}_bwd.cu'),
        defines=(f'SRC="kirchhoff_{scheme}_bwd.cu"', f'PAIR={pair}') +
        (('THIRD',) if third else ()))
        for scheme, pair, third in (('recentred', 'RecentredPair', True),
                                    ('ddphase', 'DDPair', False))}


def _row_rel(got, ref):
    return max(float(np.abs(got[i] - ref[i]).max()) /
               max(float(np.abs(ref[i]).max()), 1e-300)
               for i in range(ref.shape[0]))


@pytest.mark.parametrize('mode', ['mono', 'narrowband', 'poly', 'fast',
                                  'exact'])
def test_pair_functions_match_the_plain_backward(pair_libs, mode):
    Nd, Ns = 37, 53
    args = _args('cpu', poly=mode != 'mono', Ns=Ns, Nd=Nd)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    G = torch.randn((10, Nd), generator=torch.Generator().manual_seed(1))
    arrs = [np.ascontiguousarray(t.numpy(), np.float32)
            for t in (D, S, torch.zeros(10) if P is None else P, G)]
    bD, bS = np.zeros(D.shape), np.zeros(S.shape)
    bP = np.zeros(10)
    ptr = [a.ctypes.data_as(ctypes.c_void_p) for a in arrs + [bD, bS, bP]]
    pair_libs[scheme].pair_sums(ctypes.c_int(v), ctypes.c_int(Nd),
                                ctypes.c_int(Ns), *ptr)
    rD, rS, rP = tk.kirchhoff_bwd_blocked(scheme, v, D, S, P, G)
    assert _row_rel(bD, rD.double().numpy()) < 1e-4
    assert _row_rel(bS, rS.double().numpy()) < 1e-4
    if rP is not None:
        assert _row_rel(bP[:, None], rP.double().numpy()[:, None]) < 1e-4
