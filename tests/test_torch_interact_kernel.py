"""The toroid crystals' interaction kernel (``csrc/crystal_interact.cuh``) on
the CPU, and the dispatch that sends ``OE._interact`` to it
(``oes/crystal_interact.py``).

* ``csrc/crystal_interact.cuh``'s per-ray functions are compiled for the
  host with ``g++ -ffp-contract=off`` against a stub of the CUDA runtime,
  behind the C entry point of ``csrc/crystal_interact.cu`` (launch A's sum
  in ray order, then launch B ray by ray), and put in place of the launch:
  ``crystal_interact.interact`` then runs on CPU tensors as it runs on a
  card.  It is held to the float64 path of ``OE._interact`` on the same
  rays (``tests/torch_interact_cases.py``: 1e4 rays on the analyzer of
  ``beambench/configs/analyzer.json``, its Si(444), energies of the three
  sources and of the Darwin curves, a tenth dead, a fifth on facet edges
  and in the gaps) for the five toroid crystal classes, float32 and
  float64.  Limits: a, b, c, theta and rollAngle (every ray's: a ray
  on another facet would turn it by ~4e-3 rad) within 4 ulp in float32
  and 1e-12 in float64; Jss, Jpp and Jsp within 1e-6 of the float64 peak
  reflectivity; each ray's facet the PyTorch facet; the sign of launch A's
  sum the PyTorch ``mean < 0``, also with the beam turned back and with a
  NaN ray (the else branch, as ``torch.where`` takes it).
* The dispatch predicate on the CPU: true for the analyzer's classes with
  the benchmark's crystal, false on the CPU and for each excluded case.
* ``interact.calls`` and ``interact.fused`` while tracing; the crystal's
  constants read again after a replaced tensor; ``reflect`` through the
  kernel gives the plain path's beams (float32: with the float64 path's
  ``_interact`` rounded to float32 in the plain reflect).
"""
import torch_harness

import ctypes

import numpy as np
import pytest
import torch

import torch_interact_cases as tc
from xrt_tpu_torch import profiler
from xrt_tpu_torch.figure_error import FigureError
from xrt_tpu_torch.materials import CrystalFromCell
from xrt_tpu_torch.oes import (DicedJohanssonToroid, JohanssonToroid,
                               ToroidMirror)
from xrt_tpu_torch.oes import crystal_interact as ci
from xrt_tpu_torch.ops import _cuda

# the C entry point of csrc/crystal_interact.cu for the host: launch A's sum
# in ray order, then every ray; and the facet of every ray
HARNESS = r"""
#include <cuda_runtime.h>
#include "crystal_interact.cuh"
using namespace xci;
constexpr int SUM_BLOCKS = 1024;

template <typename T>
static void run(const double* num, const int* ints, const void* const* tab,
                long long n, const void* const* in, const void* good,
                void* const* out, double* scratch) {
  const Params<T> p = make_params<T>(num, ints, tab);
  const Rays<T> r = make_rays<T>(in, good, out, n);
  double sum = 0.0;
  for (long long i = 0; i < n; ++i) sum += incidence_at(p, r, i);
  scratch[SUM_BLOCKS] = sum;
  for (long long i = 0; i < n; ++i) interact_at(p, r, i, sum);
}

extern "C" int crystal_interact_launch(
    int is_double, const double* num, const int* ints, const void* const* tab,
    long long n, const void* const* in, const void* good, void* const* out,
    void* scratch, void*) {
  double* s = static_cast<double*>(scratch);
  if (is_double)
    run<double>(num, ints, tab, n, in, good, out, s);
  else
    run<float>(num, ints, tab, n, in, good, out, s);
  return 0;
}

template <typename T>
static void facets(const double* num, const int* ints, const T* x,
                   const T* y, long long n, T* cx, T* cy) {
  const Params<T> p = make_params<T>(num, ints, nullptr);
  for (long long i = 0; i < n; ++i) {
    cx[i] = xts::facet_centre(x[i], p.xStep);
    cy[i] = xts::facet_centre(y[i], p.yStep);
  }
}

extern "C" void crystal_interact_facets(int is_double, const double* num,
                                        const int* ints, const void* x,
                                        const void* y, long long n, void* cx,
                                        void* cy) {
  if (is_double)
    facets(num, ints, (const double*)x, (const double*)y, n, (double*)cx,
           (double*)cy);
  else
    facets(num, ints, (const float*)x, (const float*)y, n, (float*)cx,
           (float*)cy);
}
"""


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    """csrc/crystal_interact.cuh behind the kernel's C entry point, built
    for the host."""
    lib = torch_harness.host_build(
        tmp_path_factory, 'crystal_interact', {'harness.cpp': HARNESS},
        headers=('crystal_interact.cuh', 'toroid_search.cuh'))
    lib.crystal_interact_launch.argtypes = ci._ARGTYPES + [ctypes.c_void_p]
    lib.crystal_interact_launch.restype = ctypes.c_int
    return lib


@pytest.fixture
def launches(host_lib, monkeypatch):
    """The host build in place of the kernel's launch; the list of the C
    arguments of every launch."""
    calls = []

    def launch(args, device):
        calls.append(args)
        assert host_lib.crystal_interact_launch(*args, None) == 0
    monkeypatch.setattr(ci, '_launch', launch)
    return calls


def case(kind, dtype, **beam_kw):
    cr = tc.crystal(dtype)
    oe = tc.element(tc.CLASSES[kind], cr)
    lb, goodN = tc.beam(oe, dtype, **beam_kw)
    return oe, cr, lb, goodN


def kernel_sum():
    """Launch A's sum of the last host launch (the scratch on the CPU)."""
    return float(_cuda.scratch('crystal_interact', ci.SCRATCH,
                               torch.device('cpu'))[ci.SUM_BLOCKS])


def plain_sign(oe, lb):
    """``torch.where(torch.mean(beamInDotNormal) < 0, 1.0, -1.0)`` of the
    plain path."""
    n = oe.local_n(lb.x, lb.y)
    dot = torch.clamp(lb.a * n[0] + lb.b * n[1] + lb.c * n[2], -1.0, 1.0)
    return float(torch.where(torch.mean(dot) < 0, 1.0, -1.0))


# ---- the kernel against the float64 path ----------------------------------

@pytest.mark.parametrize('dt', list(tc.DTYPES))
@pytest.mark.parametrize('kind', list(tc.CLASSES))
def test_kernel_matches_the_float64_path(launches, kind, dt):
    dtype = tc.DTYPES[dt]
    oe, cr, lb, goodN = case(kind, dtype)
    roll = oe._placement()[1]
    got = ci.interact(oe, lb, goodN, roll, cr)
    assert len(launches) == 1 and launches[0][0] == int(
        dtype == torch.float64)
    for v in (got[0].a, got[0].theta, got[0].Jss, got[1]):
        assert v.dtype == dtype
    assert got[0].Jsp.dtype == lb.Jsp.dtype
    ref = tc.reference(oe, lb, goodN, cr)
    tc.compare(got, ref, goodN, dtype)
    # the rays that are not good keep their inputs
    bad = ~goodN
    for k in ('a', 'b', 'c', 'theta', 'Jss', 'Jpp', 'Jsp'):
        assert torch.equal(getattr(got[0], k)[bad], getattr(lb, k)[bad]), k
    # reflecting rays: the peak, the flanks, and the tails
    R = (ref[0].Jss / lb.Jss.double())[goodN]
    assert int((R > 0.5).sum()) > 200
    assert int(((R > 0.01) & (R < 0.5)).sum()) > 500
    assert int((R < 1e-4).sum()) > 2000
    assert plain_sign(oe, lb) == 1.0 and kernel_sum() < 0


@pytest.mark.parametrize('dt', list(tc.DTYPES))
@pytest.mark.parametrize('kind', ['diced_johann', 'diced_johansson'])
def test_every_ray_takes_the_pytorch_facet(host_lib, kind, dt):
    dtype = tc.DTYPES[dt]
    oe, cr, lb, goodN = case(kind, dtype)
    num = (ctypes.c_double * len(ci.NUMBERS))(*[
        dict(dx=oe.dxFacet, dxGap=oe.dxGap, dy=oe.dyFacet,
             dyGap=oe.dyGap).get(k, 0.0) for k in ci.NUMBERS])
    cx, cy = torch.empty_like(lb.x), torch.empty_like(lb.y)
    host_lib.crystal_interact_facets(
        int(dtype == torch.float64), num, (ctypes.c_int * 5)(0, 1, 0, 1, 1),
        ctypes.c_void_p(lb.x.data_ptr()), ctypes.c_void_p(lb.y.data_ptr()),
        ctypes.c_longlong(lb.x.numel()), ctypes.c_void_p(cx.data_ptr()),
        ctypes.c_void_p(cy.data_ptr()))
    rx, ry, _, _ = oe._facets(lb.x, lb.y)
    assert torch.equal(cx, rx) and torch.equal(cy, ry)
    assert len(set(zip(rx[goodN].tolist(), ry[goodN].tolist()))) > 500


SIGN_CASES = ('turned_back', 'nan_ray')


@pytest.mark.parametrize('dt', list(tc.DTYPES))
@pytest.mark.parametrize('sign_case', SIGN_CASES)
def test_launch_a_sign_is_the_pytorch_mean_sign(launches, sign_case, dt):
    """The beam turned back (every incidence positive: the grating vector's
    other sign) and a beam with one NaN ray (a NaN mean: the else branch,
    -1): the sum's sign and every output as the float64 path gives them."""
    dtype = tc.DTYPES[dt]
    oe, cr, lb, goodN = case('diced_johansson', dtype, n=3000)
    if sign_case == 'turned_back':
        lb = lb.replace(a=-lb.a, b=-lb.b, c=-lb.c)
    else:
        x = lb.x.clone()
        x[5] = float('nan')
        lb = lb.replace(x=x)
        goodN = goodN.clone()
        goodN[5] = False
    assert plain_sign(oe, lb) == -1.0
    roll = oe._placement()[1]
    got = ci.interact(oe, lb, goodN, roll, cr)
    s = kernel_sum()
    assert not s < 0
    assert np.isnan(s) == (sign_case == 'nan_ray')
    tc.compare(got, tc.reference(oe, lb, goodN, cr), goodN, dtype)


# ---- the dispatch predicate ---------------------------------------------

@pytest.mark.parametrize('kind', list(tc.CLASSES))
def test_the_analyzer_engages_on_a_card(kind):
    oe, cr, lb, goodN = case(kind, torch.float32, n=64)
    roll = oe._placement()[1]
    assert ci.handles(oe, lb, oe.local_n, cr, 'crystal', roll)
    assert ci.handles(oe, lb, None, cr, 'crystal', roll)
    # on the CPU the plain path runs
    assert not ci.engages(oe, lb, oe.local_n, cr, 'crystal', roll)


def _figure_error():
    x = np.linspace(-60, 60, 13)
    return FigureError.from_map(np.zeros((13, 13)), x, x,
                                dtype=torch.float32, device='cpu')


def _cell_crystal():
    return CrystalFromCell.create(hkl=(4, 4, 4), dtype=torch.float32,
                                  device='cpu')


class _OwnDeltaN(DicedJohanssonToroid):
    def facet_delta_n(self, u, v):
        return DicedJohanssonToroid.facet_delta_n(self, u, 2 * v)


def _excluded(name):
    """(oe, lb, local_n, material, kind) of an excluded case."""
    oe, cr, lb, goodN = case('diced_johansson', torch.float32, n=64)
    ln, kind = oe.local_n, 'crystal'
    if name in ('mosaic', 'tt', 'laue', 'transmitted', 'thickness'):
        cr = cr.replace(**{'mosaic': dict(mosaicity=torch.tensor(1e-3)),
                           'tt': dict(useTT=True),
                           'laue': dict(geom='Laue reflected'),
                           'transmitted': dict(geom='Bragg transmitted'),
                           'thickness': dict(t=0.1)}[name])
    elif name == 'CrystalFromCell':
        cr = _cell_crystal()
    elif name == 'figure_error':
        oe = oe.replace(figure_error=_figure_error())
    elif name == 'replaced_local_n':
        ln = lambda x, y: JohanssonToroid.local_n(oe, x, y)  # noqa: E731
    elif name == 'instance_local_n':
        own = oe
        oe = oe.replace(
            local_n=lambda x, y: JohanssonToroid.local_n(own, x, y))
        ln = oe.local_n
    elif name == 'subclass_facet_delta_n':
        oe = tc.element(_OwnDeltaN, cr)
        ln = oe.local_n
    elif name == 'grad':
        lb = lb.replace(a=lb.a.clone().requires_grad_())
    elif name == 'grad_crystal':
        cr = cr.replace(d=cr.d.clone().requires_grad_())
    elif name == 'Es':
        lb = lb.replace(Es=lb.Jsp.clone(), Ep=lb.Jsp.clone())
    elif name == 'tensor_roll':
        return oe, lb, ln, cr, kind, torch.tensor(0.0)
    elif name == 'alpha':
        oe = oe.replace(alpha=0.01)
    elif name == 'ToroidMirror':
        oe = ToroidMirror.create(R=1e5, r=50.0)
        ln, cr, kind = oe.local_n, None, 'mirror'
    elif name == 'half':
        lb = lb.replace(**{k: getattr(lb, k).half()
                           for k in ('x', 'y', 'a', 'b', 'c')})
    return oe, lb, ln, cr, kind, oe._placement()[1]


EXCLUDED = ('mosaic', 'tt', 'laue', 'transmitted', 'thickness',
            'CrystalFromCell', 'figure_error', 'replaced_local_n',
            'instance_local_n', 'subclass_facet_delta_n', 'grad',
            'grad_crystal', 'Es', 'tensor_roll', 'alpha', 'ToroidMirror',
            'half')


@pytest.mark.parametrize('name', EXCLUDED)
def test_everything_else_keeps_the_plain_path(name):
    args = _excluded(name)
    assert not ci.handles(*args)
    if name in ('grad', 'grad_crystal'):   # no autograd to record
        with torch.no_grad():
            assert ci.handles(*args)


# ---- counters, constants and reflect ---------------------------------------

def test_interact_counts_its_calls_and_the_fused_ones(launches, monkeypatch):
    oe, cr, lb, goodN = case('diced_johansson', torch.float32, n=256)
    roll = oe._placement()[1]

    def counted():
        profiler.reset()
        with profiler.tracing():
            oe._interact(lb, goodN, roll, True, None, cr, oe.local_n)
        out = {}
        for c in profiler.counters().values():
            out.update(c)
        profiler.reset()
        return out
    assert counted() == {'interact.calls': 1}
    monkeypatch.setattr(ci, 'engages', ci.handles)
    assert counted() == {'interact.calls': 1, 'interact.fused': 1}
    assert len(launches) == 1
    oe._interact(lb, goodN, roll, True, None, cr, oe.local_n)
    assert profiler.counters() == {} and len(launches) == 2


def test_constants_are_read_again_after_a_replaced_tensor(launches):
    oe, cr, lb, goodN = case('johansson', torch.float64, n=512)
    roll = oe._placement()[1]
    first = ci._constants(cr, lb.x.device)
    assert ci._constants(cr, lb.x.device) is first
    cr.d = cr.d * (1 + 1e-6)
    second = ci._constants(cr, lb.x.device)
    assert second is not first and second[0]['d'] == float(cr.d)
    got = ci.interact(oe, lb, goodN, roll, cr)
    tc.compare(got, tc.reference(oe, lb, goodN, cr), goodN, torch.float64)


@pytest.mark.parametrize('dt', list(tc.DTYPES))
def test_reflect_through_the_kernel_equals_the_plain_path(
        launches, monkeypatch, dt):
    """OE.reflect with the dispatch made to engage on CPU tensors against
    OE.reflect with the plain ``_interact`` (float32: the float64 path's
    ``_interact`` rounded to float32): the same beams."""
    dtype = tc.DTYPES[dt]
    cr = tc.crystal(dtype)
    oe = tc.element(DicedJohanssonToroid, cr)
    beam = tc.global_beam(oe, dtype)
    ref = tc.reflect_reference(oe, beam, cr)
    assert not launches
    monkeypatch.setattr(ci, 'engages', ci.handles)
    got = oe.reflect(beam)
    assert len(launches) == 1
    tc.compare_beams(ref, got, dtype)
