"""The blazed grating's groove arithmetic in float64 for float32 rays
(ROADMAP C8): the SoftiMAX grating (300 lines/mm, blaze 0.6 deg) has an
antiblaze facet ~1.1e-8 mm wide, below float32's rounding of y (a few 1e-6
mm at |y| ~ 40 mm).

* ``local_z``, ``local_n`` and ``analytic_intersect`` on float32 inputs
  give the float64 results on the same values, rounded to float32, bit for
  bit: the same period and facet for every sample, with samples 0-4 ulp
  from every groove edge and every antiblaze edge over the grating's
  length;
* the float32 PG hop of ``tools/torch_bench_softimax.deterministic_chain``
  against float64 on the same float32 samples: overlap at least 0.999, on
  xrt's own samples and with a tenth of the grating's samples moved to
  within 4 ulp of a groove edge.

Imports nothing of the JAX package.
"""
import torch_harness  # noqa: F401

import math
import os
import sys

import numpy as np
import pytest
import torch

from xrt_tpu_torch.oes import BlazedGrating

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
import torch_bench_softimax as tbs  # noqa: E402

GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'ref_softimax.npz')
F32, F64 = torch.float32, torch.float64
#: half the SoftiMAX grating's length (limPhysY), mm
HALF_LENGTH = 40.0


@pytest.fixture(scope='module')
def pg():
    return BlazedGrating.create(center=(0, 0, 0), rho=300.0,
                                blaze=math.radians(0.6),
                                limPhysX=(-2, 2),
                                limPhysY=(-HALF_LENGTH, HALF_LENGTH))


def ulp_steps(v, n):
    """float32 *v* moved by each of -n..n ulp (n + 1 + n values each)."""
    v = np.asarray(v, np.float32)
    out, up, down = [v], v.copy(), v.copy()
    for _ in range(n):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        out += [up, down]
    return np.concatenate(out)


def edge_samples(pg, seed=0):
    """float32 y: every groove edge and every antiblaze edge of the grating
    and 1-4 ulp to either side of each, and uniform samples."""
    rho_1 = 1.0 / pg.rho
    tanA, tanB = math.tan(pg.antiblaze), math.tan(pg.blaze)
    yC = rho_1 / (1 + tanA / tanB)
    k = np.arange(-round(HALF_LENGTH * pg.rho), round(HALF_LENGTH * pg.rho))
    edges = np.concatenate([k * rho_1, k * rho_1 + yC])
    rng = np.random.RandomState(seed)
    uniform = rng.uniform(-HALF_LENGTH, HALF_LENGTH, 20000)
    y = np.concatenate([ulp_steps(edges, 4), uniform.astype(np.float32)])
    return torch.from_numpy(y)


def test_samples_reach_the_float32_fault(pg):
    """The samples include ones where groove arithmetic in float32 picks
    another period or facet than float64: the test below can fail."""
    y = edge_samples(pg)
    rho_1 = torch.tensor(1.0, dtype=F32) / torch.tensor(pg.rho, dtype=F32)
    tanA = torch.tan(torch.tensor(pg.antiblaze, dtype=F32))
    tanB = torch.tan(torch.tensor(pg.blaze, dtype=F32))
    y0 = torch.floor(y / rho_1) * rho_1
    on_blaze32 = (y - y0) > rho_1 / (1 + tanA / tanB)
    on_blaze64 = pg.local_n(y.double(), y.double())[1] < 0
    assert int((on_blaze32 != on_blaze64).sum()) > 1000


def test_surface_picks_the_float64_period_and_facet(pg):
    y = edge_samples(pg)
    x = torch.zeros_like(y)
    z32, z64 = pg.local_z(x, y), pg.local_z(x.double(), y.double())
    assert z32.dtype == F32
    assert torch.equal(z32, z64.to(F32))
    n32, n64 = pg.local_n(x, y), pg.local_n(x.double(), y.double())
    for a, b in zip(n32, n64):
        assert a.dtype == F32 and torch.equal(a, b.to(F32))
    # both facets are hit: the antiblaze one (normal along +y) at edges
    assert bool((n32[1] > 0).any()) and bool((n32[1] < 0).any())


def test_analytic_intersect_picks_the_float64_period(pg):
    """Rays at grazing angles from 10-100 mm away whose z = 0 crossing
    lies within a few ulp (float32 rounding of the start point) of a
    groove or antiblaze edge."""
    y = edge_samples(pg)
    n = y.shape[0]
    rng = np.random.RandomState(1)
    ang = torch.from_numpy(rng.uniform(0.01, 0.1, n).astype(np.float32))
    d = torch.from_numpy(rng.uniform(10, 100, n).astype(np.float32))
    b, c = torch.cos(ang), -torch.sin(ang)
    a = torch.from_numpy(rng.uniform(-1e-3, 1e-3, n).astype(np.float32))
    ray = (torch.zeros_like(y), y - b * d, -c * d, a, b, c)
    out32 = pg.analytic_intersect(None, None, *ray)
    out64 = pg.analytic_intersect(None, None, *(v.double() for v in ray))
    for u, v in zip(out32[:4], out64[:4]):
        assert u.dtype == F32 and torch.equal(u, v.to(F32))
    assert torch.isfinite(out32[0]).all() and not bool(out32[4].any())


def overlap(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return abs(np.vdot(a, b)) / math.sqrt(np.vdot(a, a).real *
                                          np.vdot(b, b).real)


def samples_at_groove_edges(ref, pg, share=10, seed=0):
    """xrt's samples with every *share*-th grating sample moved to 0-4 ulp
    (float32) from its nearest groove edge, its z on the surface there
    (float64)."""
    ref = dict(ref)
    y = ref['wpg_y'].astype(np.float64)
    rng = np.random.RandomState(seed)
    idx = rng.choice(y.size, y.size // share, replace=False)
    edge = (np.round(y[idx] * pg.rho) / pg.rho).astype(np.float32)
    ye = edge.copy()
    for i, s in enumerate(rng.randint(-4, 5, idx.size)):
        for _ in range(abs(s)):
            ye[i] = np.nextafter(ye[i], np.float32(math.copysign(np.inf, s)))
    yt = torch.from_numpy(ye.astype(np.float64))
    y[idx] = ye
    z = ref['wpg_z'].astype(np.float64).copy()
    z[idx] = pg.local_z(torch.zeros_like(yt), yt).numpy()
    ref.update(wpg_y=y, wpg_z=z)
    return ref


@pytest.mark.parametrize('edges', [False, True], ids=['xrt', 'edges'])
def test_float32_grating_hop_against_float64(pg, edges):
    ref = dict(np.load(GOLDEN))
    if edges:
        ref = samples_at_groove_edges(ref, pg)
    a = tbs.deterministic_chain(ref, F64, 'cpu', f32_samples=True)
    b = tbs.deterministic_chain(ref, F32, 'cpu', f32_samples=True)
    assert overlap(a['wpg'], b['wpg']) > 0.999
    assert overlap(a['pg'], b['pg']) > 0.999
    assert overlap(a['focus'], b['focus']) > 0.999
