"""The toroid crystals' search kernel (``csrc/toroid_search.cuh``) on the
CPU, and the dispatch that sends a search to it (``oes/toroid_search.py``).

* ``csrc/toroid_search.cuh``'s per-ray search is compiled for the host
  with ``g++ -ffp-contract=off`` against a stub of the CUDA runtime, behind
  the C entry point of ``csrc/toroid_search.cu`` (a loop over the rays in
  warps of 32 in place of the launch), and put in place of the launch:
  ``toroid_search.search`` then runs on CPU tensors as it runs on a card,
  dividing by a Python number as PyTorch does on the CPU.  It is held
  against ``find_intersection_dz`` with the search function that
  ``OE._reflect_local`` builds, for ``JohannToroid``, ``JohanssonToroid``,
  ``DicedJohannToroid`` and ``DicedJohanssonToroid``, float32 and float64,
  on two sets of rays: the analyzer of ``beambench/configs/analyzer.json``
  (its geometry, 1e4 rays from a seed across and beyond the crystal, a
  tenth of them starting below the surface, a tenth inactive, many in the
  facet gaps and at facet edges) and a grazing toroid as in
  ``test_torch_intersection.py``.  Limits: ``lost`` and the facet of the
  point identical, ``t`` within 4 ulp of t in float32 and 1e-9 mm in
  float64, and the Illinois counts equal: the call's largest per-ray count
  to the loop's iterations, their sum to its active rays.
* The dispatch predicate on the CPU (it takes the device): true for the
  five toroid crystal classes on 'cuda', false on the CPU, with a figure
  error, tensor radii, a replaced ``local_z``, ``isMulti``, a subclass
  that overrides ``local_z`` or a facet function, and a ``ToroidMirror``.
* With autograd recording, the kernel is asked for the bracket's result
  only and the Newton steps run on the tape: t and dt/dh as the generic
  search gives them.  ``reflect`` through the kernel path gives the generic
  path's beams.
"""
import torch_harness

import ctypes
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from xrt_tpu_torch import profiler
from xrt_tpu_torch.beam import Beam
from xrt_tpu_torch.figure_error import FigureError
from xrt_tpu_torch.oes import (DicedJohannToroid, DicedJohanssonToroid,
                               GeneralBraggToroid, JohannToroid,
                               JohanssonToroid, ToroidMirror)
from xrt_tpu_torch.oes import base as tbase
from xrt_tpu_torch.oes import toroid_search as ts


ROOT = Path(__file__).resolve().parent.parent
ANALYZER = json.loads((ROOT / 'beambench' / 'configs' /
                       'analyzer.json').read_text())
CLASSES = {'johann': JohannToroid, 'johansson': JohanssonToroid,
           'diced_johann': DicedJohannToroid,
           'diced_johansson': DicedJohanssonToroid}
DTYPES = {'f32': torch.float32, 'f64': torch.float64}

# the C entry point of csrc/toroid_search.cu for the host: the rays in
# warps of 32, counted as the kernel counts them
HARNESS = r"""
#include <cuda_runtime.h>
#include "toroid_search.cuh"
using namespace xts;

template <typename T>
static void run(const Params<T>& p, const void* const* in, const void* act,
                long long n, int newton, void* const* out, void* lost,
                void* good, void* counts) {
  const T* const* r = reinterpret_cast<const T* const*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
  unsigned long long* cnt = static_cast<unsigned long long*>(counts);
  for (long long w = 0; w < n; w += 32) {
    unsigned long long wmax = 0;
    for (long long i = w; i < w + 32 && i < n; ++i) {
      const Ray<T> ray{r[0][i], r[1][i], r[2][i], r[3][i], r[4][i], r[5][i]};
      const Result<T> res = search_ray(p, ray, r[6][i], r[7][i],
                                       static_cast<const bool*>(act)[i],
                                       newton != 0);
      o[0][i] = res.t;
      if (o[1] != nullptr) {
        o[1][i] = ray.x + ray.a * res.t;
        o[2][i] = ray.y + ray.b * res.t;
        o[3][i] = ray.z + ray.c * res.t;
      }
      static_cast<bool*>(lost)[i] = res.flag == LOST;
      if (good != nullptr) static_cast<bool*>(good)[i] = res.flag == GOOD;
      const unsigned long long it = res.iters;
      if (it > wmax) wmax = it;
      if (cnt != nullptr) cnt[1] += it;
    }
    if (cnt != nullptr) {
      if (wmax > cnt[0]) cnt[0] = wmax;
      cnt[2] += 32 * wmax;
    }
  }
}

extern "C" int toroid_search_launch(
    int is_double, int kind, int recip, int max_iter, double Rm, double Rs,
    double Rm2, double RmRs, double dx, double dxGap, double dy, double dyGap,
    double inv, double eps, double rel, const void* const* in,
    const void* active, long long n, int newton, void* const* out,
    void* lost, void* good, void* counts, void*) {
  if (is_double)
    run(make_params<double>(kind, recip, max_iter, Rm, Rs, Rm2, RmRs, dx,
                            dxGap, dy, dyGap, inv, eps, rel),
        in, active, n, newton, out, lost, good, counts);
  else
    run(make_params<float>(kind, recip, max_iter, Rm, Rs, Rm2, RmRs, dx,
                           dxGap, dy, dyGap, inv, eps, rel),
        in, active, n, newton, out, lost, good, counts);
  return 0;
}
"""


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    """csrc/toroid_search.cuh behind the kernel's C entry point, built for
    the host."""
    lib = torch_harness.host_build(tmp_path_factory, 'toroid_search',
                                   {'harness.cpp': HARNESS},
                                   headers=('toroid_search.cuh',))
    lib.toroid_search_launch.argtypes = ts._ARGTYPES
    lib.toroid_search_launch.restype = ctypes.c_int
    return lib


@pytest.fixture
def launches(host_lib, monkeypatch):
    """The host build in place of the kernel's launch; the list of the C
    arguments of every launch."""
    calls = []

    def launch(args, device):
        calls.append(args)
        assert host_lib.toroid_search_launch(*args, None) == 0
    monkeypatch.setattr(ts, '_launch', launch)
    return calls


# ---- elements and rays ------------------------------------------------------

def analyzer(cls):
    """The analyzer of speed test 1 (beambench/configs/analyzer.json) as
    class *cls*: R, theta, facets, size; no material."""
    R, theta = ANALYZER['R'], math.radians(ANALYZER['theta_deg'])
    fc, (dxc, dyc) = ANALYZER['facet'], ANALYZER['crystal_size']
    kw = dict(Rm=R, Rs=2.0 * R * math.sin(theta) ** 2, pitch=theta,
              center=(0, 2.0 * R * math.sin(theta), 0),
              limPhysX=(-dxc / 2, dxc / 2), limPhysY=(-dyc / 2, dyc / 2))
    if cls.__name__.startswith('Diced'):
        kw.update(dxFacet=fc['dx'], dyFacet=fc['dy'], dxGap=fc['dx_gap'],
                  dyGap=fc['dy_gap'])
    return cls.create(**kw)


def analyzer_rays(npdt, n=10000, seed=18):
    """Rays in the analyzer's local frame from a small source at its
    distance p and glancing angle theta, aimed across the crystal and 5 mm
    beyond its edges; the last tenth start 20 mm past the surface."""
    rng = np.random.RandomState(seed)
    theta = math.radians(ANALYZER['theta_deg'])
    p = 2.0 * ANALYZER['R'] * math.sin(theta)
    half = ANALYZER['crystal_size'][0] / 2 + 5
    src = np.stack([rng.uniform(-0.05, 0.05, n),
                    -p * math.cos(theta) + rng.uniform(-0.02, 0.02, n),
                    p * math.sin(theta) + rng.uniform(-0.02, 0.02, n)])
    hit = np.stack([rng.uniform(-half, half, n), rng.uniform(-half, half, n),
                    np.zeros(n)])
    d = hit - src
    d /= np.sqrt((d ** 2).sum(0))
    start = src.copy()
    k = n // 10
    start[:, -k:] = hit[:, -k:] + 20.0 * d[:, -k:]
    return tuple(v.astype(npdt) for v in (*start, *d))


P, Q, PITCH = 10000.0, 2000.0, 4e-3


def grazing(cls):
    """A toroid crystal under the grazing rays of
    test_torch_intersection.py: Rm and Rs of its toroid mirror."""
    kw = dict(Rm=2 * P * Q / (P + Q) / math.sin(PITCH),
              Rs=2 * P * Q / (P + Q) * math.sin(PITCH), pitch=PITCH,
              limPhysX=(-20, 20), limPhysY=(-300, 300))
    if cls.__name__.startswith('Diced'):
        kw.update(dxFacet=2.1, dyFacet=1.4, dxGap=0.05, dyGap=0.05)
    return cls.create(**kw)


def grazing_rays(npdt, n=2000, seed=0):
    """test_torch_intersection.local_rays: a grazing 4 mrad from ~10 m
    upstream; the last tenth start below the surface."""
    rng = np.random.RandomState(seed)
    yhit = rng.uniform(-280, 280, n)
    xhit = rng.uniform(-3, 3, n)
    a = rng.normal(0, 3e-5, n)
    c = -math.sin(PITCH) + rng.normal(0, 3e-5, n)
    b = np.sqrt(1 - a ** 2 - c ** 2)
    L = P + rng.uniform(-1, 1, n)
    x, y, z = xhit - a * L, yhit - b * L, 0.5 - c * L
    z[-n // 10:] = -5.0 - c[-n // 10:] * L[-n // 10:] - 40.0
    return tuple(v.astype(npdt) for v in (x, y, z, a, b, c))


SETS = {'analyzer': (analyzer, analyzer_rays),
        'grazing': (grazing, grazing_rays)}


def dz_fn_of(oe, inv=1):
    """The search function OE._reflect_local builds for *oe*."""
    def dz_fn(xx, yy, zz):
        surf = oe.local_z(xx, yy)
        surf = torch.where(torch.isnan(surf), torch.zeros_like(surf), surf)
        return (zz - surf) * inv
    return dz_fn


def inputs(rays_fn, dtype):
    npdt = np.float32 if dtype == torch.float32 else np.float64
    rays = tuple(torch.from_numpy(np.ascontiguousarray(v))
                 for v in rays_fn(npdt))
    n = rays[0].numel()
    active = torch.from_numpy(np.random.RandomState(7).rand(n) > 0.1)
    return rays, active


def traced(fn):
    """fn() under profiler.tracing(): (its result, the counters summed
    over the passes)."""
    profiler.reset()
    with profiler.tracing():
        out = fn()
    sums = {}
    for c in profiler.counters().values():
        for k, v in c.items():
            sums[k] = sums.get(k, 0) + v
    profiler.reset()
    return out, sums


def facet(oe, x, y):
    sx, sy = (getattr(oe, 'dxFacet', 2.1) + getattr(oe, 'dxGap', 0.05),
              getattr(oe, 'dyFacet', 1.4) + getattr(oe, 'dyGap', 0.05))
    xs = x.numpy().astype(np.float64)
    ys = y.numpy().astype(np.float64)
    with np.errstate(invalid='ignore'):
        return np.round(xs / sx), np.round(ys / sy)


# ---- the search against find_intersection_dz ------------------------------

@pytest.mark.parametrize('rayset', list(SETS))
@pytest.mark.parametrize('dt', list(DTYPES))
@pytest.mark.parametrize('kind', list(CLASSES))
def test_kernel_search_matches_the_pytorch_search(launches, kind, dt,
                                                  rayset):
    make, rays_fn = SETS[rayset]
    oe = make(CLASSES[kind])
    dtype = DTYPES[dt]
    rays, active = inputs(rays_fn, dtype)
    tMin, tMax = oe._bracket(*rays)
    dz_fn = dz_fn_of(oe)
    ref, rc = traced(lambda: tbase.find_intersection_dz(
        dz_fn, tMin, tMax, *rays, active=active))
    got, gc = traced(lambda: ts.search(oe, tMin, tMax, *rays, active, 1,
                                       dz_fn))
    assert len(launches) == 1 and launches[0][18] == 1   # Newton inside
    assert got[0].dtype == dtype
    lost = ref[4].numpy()
    np.testing.assert_array_equal(got[4].numpy(), lost)
    assert lost.sum() >= rays[0].numel() // 20
    tr, tg = ref[0].numpy().astype(np.float64), \
        got[0].numpy().astype(np.float64)
    assert np.array_equal(np.isnan(tr), np.isnan(tg))
    ok = ~np.isnan(tr)
    if dtype == torch.float32:
        ulp = np.spacing(np.abs(ref[0].numpy())).astype(np.float64)
        err = np.abs(tg - tr)[ok] / ulp[ok]
        assert err.max() <= 4, err.max()
    else:
        assert np.abs(tg - tr)[ok].max() <= 1e-9
    for r, g in zip(ref[1:4], got[1:4]):
        assert np.array_equal(np.isnan(r.numpy()), np.isnan(g.numpy()))
    for fr, fg in zip(facet(oe, *ref[1:3]), facet(oe, *got[1:3])):
        np.testing.assert_array_equal(fg, fr)
    # the searched rays hit the crystal in many facets
    hit = active.numpy() & ~lost & (tg < tMax.numpy())
    assert hit.sum() > rays[0].numel() // 3
    assert len(set(zip(*(f[hit] for f in facet(oe, *got[1:3]))))) > 100
    # the Illinois counts: the largest per-ray count is the loop's
    # iterations, their sum its active rays
    assert gc['search.fused'] == gc['search.calls'] == rc['search.calls']
    assert gc['search.iterations'] == rc['search.iterations'] > 2
    assert gc['search.active'] == rc['search.active']
    n = rays[0].numel()
    assert gc['search.active'] <= gc['search.ray_evals'] <= \
        32 * -(-n // 32) * gc['search.iterations']


def test_counts_read_only_while_tracing(launches):
    oe = analyzer(DicedJohanssonToroid)
    rays, active = inputs(analyzer_rays, torch.float32)
    tMin, tMax = oe._bracket(*rays)
    ts.search(oe, tMin, tMax, *rays, active, 1, dz_fn_of(oe))
    assert launches[-1][-1] is None                      # no buffer
    assert profiler.counters() == {}
    traced(lambda: ts.search(oe, tMin, tMax, *rays, active, 1,
                             dz_fn_of(oe)))
    assert launches[-1][-1] is not None


# ---- the dispatch predicate ---------------------------------------------

ALL = dict(CLASSES, general=GeneralBraggToroid)


@pytest.mark.parametrize('dt', list(DTYPES))
@pytest.mark.parametrize('kind', list(ALL))
def test_the_toroid_crystals_engage_on_a_card(kind, dt):
    oe = analyzer(ALL[kind])
    assert ts.engages(oe, torch.device('cuda'), DTYPES[dt])
    assert ts.engages(oe, 'cuda:0', DTYPES[dt], None, False, -1)


class _OwnZ(JohannToroid):
    def local_z(self, x, y):
        return JohannToroid.local_z(self, x, y) + 1e-3


class _OwnDelta(DicedJohanssonToroid):
    def facet_delta_z(self, u, v):
        return v ** 2 / self.Rm


def _figure_error():
    x = np.linspace(-60, 60, 13)
    return FigureError.from_map(np.zeros((13, 13)), x, x,
                                dtype=torch.float32, device='cpu')


FALSE_CASES = {
    'cpu': lambda: (analyzer(DicedJohanssonToroid), dict(device='cpu')),
    'half': lambda: (analyzer(JohannToroid), dict(dtype=torch.float16)),
    'figure_error': lambda: (analyzer(JohannToroid).replace(
        figure_error=_figure_error()), {}),
    'tensor_radii': lambda: (JohannToroid.create(
        Rm=torch.tensor(500.0, requires_grad=True), Rs=375.0), {}),
    'replaced_local_z': lambda: (analyzer(DicedJohanssonToroid),
                                 dict(local_z=lambda x, y: 0 * x)),
    'instance_local_z': lambda: (analyzer(JohannToroid).replace(
        local_z=lambda x, y: 0 * x), {}),
    'isMulti': lambda: (analyzer(JohanssonToroid), dict(isMulti=True)),
    'subclass_local_z': lambda: (_OwnZ.create(Rm=500.0, Rs=375.0), {}),
    'subclass_facet_delta_z': lambda: (analyzer(_OwnDelta), {}),
    'ToroidMirror': lambda: (ToroidMirror.create(R=1e5, r=50.0), {}),
}


@pytest.mark.parametrize('case', list(FALSE_CASES))
def test_everything_else_keeps_the_generic_search(case):
    oe, kw = FALSE_CASES[case]()
    kw = dict(dict(device=torch.device('cuda'), dtype=torch.float32), **kw)
    assert not ts.engages(oe, kw.pop('device'), kw.pop('dtype'), **kw)


# ---- gradients and reflect --------------------------------------------------

@pytest.mark.parametrize('kind', ['johann', 'diced_johansson'])
def test_the_gradient_case_polishes_on_the_tape(launches, kind):
    """With a ray tensor that requires grad the kernel returns t0 only;
    the Newton steps on the tape give the generic search's t and dt/dh
    (h a height offset of the rays)."""
    oe = analyzer(CLASSES[kind])
    rays, active = inputs(analyzer_rays, torch.float64)
    x, y, z0, a, b, c = rays
    dz_fn = dz_fn_of(oe)
    out = []
    for fused in (False, True):
        h = torch.zeros((), dtype=torch.float64, requires_grad=True)
        r = (x, y, z0 + h, a, b, c)
        tMin, tMax = oe._bracket(*r)
        if fused:
            got = ts.search(oe, tMin, tMax, *r, active, 1, dz_fn)
        else:
            got = tbase.find_intersection_dz(dz_fn, tMin, tMax, *r,
                                             active=active)
        hit = active & ~got[4] & (got[0] < tMax)
        g, = torch.autograd.grad(got[0][hit].sum(), h)
        out.append((got, hit, float(g)))
    (ref, hit_r, g_r), (got, hit_g, g_g) = out
    assert len(launches) == 1 and launches[0][18] == 0   # t0 only
    assert got[0].requires_grad
    assert torch.equal(hit_r, hit_g) and int(hit_g.sum()) > 1000
    assert float((got[0] - ref[0]).abs().max()) <= 1e-9
    assert g_g == pytest.approx(g_r, rel=1e-9)


def _beam(rays_fn, oe, dtype):
    """The analyzer rays as a global-frame beam that reaches *oe*."""
    from xrt_tpu_torch.transforms import rotate_xyz
    x, y, z, a, b, c = (torch.from_numpy(np.ascontiguousarray(v))
                        for v in rays_fn(np.float64))
    pitch = oe._placement()[0]
    x, y, z = rotate_xyz(x, y, z, rotationSequence='-' + oe.rotationSequence,
                         pitch=pitch)
    a, b, c = rotate_xyz(a, b, c, rotationSequence='-' + oe.rotationSequence,
                         pitch=pitch)
    n = x.numel()
    cx, cy, cz = oe.center
    one = torch.ones(n, dtype=dtype)
    return Beam(x=(x + cx).to(dtype), y=(y + cy).to(dtype),
                z=(z + cz).to(dtype), a=a.to(dtype), b=b.to(dtype),
                c=c.to(dtype), E=9000 * one,
                state=torch.ones(n, dtype=torch.int32), path=0 * one,
                Jss=one / 2, Jpp=one / 2, Jsp=torch.complex(0 * one, 0 * one))


@pytest.mark.parametrize('dt', list(DTYPES))
def test_reflect_through_the_kernel_path_equals_the_generic_path(
        launches, monkeypatch, dt):
    """OE.reflect with the dispatch made to engage on CPU tensors (the
    host build in place of the launch) against OE.reflect as the CPU runs
    it today: the same beams."""
    dtype = DTYPES[dt]
    oe = analyzer(DicedJohanssonToroid)
    beam = _beam(analyzer_rays, oe, dtype)
    ref = oe.reflect(beam)
    assert not launches
    real = ts.engages
    monkeypatch.setattr(ts, 'engages', lambda oe_, device, *a: real(
        oe_, torch.device('cuda'), *a))
    got = oe.reflect(beam)
    assert len(launches) == 1
    for r, g in zip(ref, got):
        assert torch.equal(r.state, g.state)
        assert int((g.state == 1).sum()) > beam.x.numel() // 2
        for k in ('x', 'y', 'z', 'a', 'b', 'c', 'Jss', 'Jpp'):
            rv, gv = getattr(r, k), getattr(g, k)
            tol = 1e-9 if dtype == torch.float64 else \
                4 * float(torch.finfo(dtype).eps) * float(rv.abs().max())
            assert float((gv - rv).abs().nan_to_num(0).max()) <= tol, k
