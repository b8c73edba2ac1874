"""The undulator's radiation-integral kernel (``csrc/undulator_integral.cuh``)
on the CPU, and the dispatch that sends ``Undulator.build_I_map`` to it
(``sources/undulator_integral.py``).

* ``csrc/undulator_integral.cuh``'s per-ray functions are compiled for the
  host with ``g++ -ffp-contract=off`` against a stub of the CUDA runtime,
  behind the C entry point of ``csrc/undulator_integral.cu`` (every ray,
  the node table read in the kernel's tiles), and put in place of the
  launch: ``build_I_map`` then runs on CPU tensors as it runs on a card.
  It is held to the plain ``Undulator._integrate`` on the same rays: far
  field (planar, and elliptic with Kx != 0 and a phase), tapered, near
  field, with an energy spread and with the harmonic mask, on 1200 rays
  drawn over each source's acceptance.  Limits: float64 within 1e-9 of
  each output's peak; float32 no farther from the float64 plain loop on
  the same numbers than twice the plain float32 loop is (in the near field
  |Es|, |Ep| and Es Ep*: the carrier phase w / wu R0n ~ 1e9 rad is a
  different number in float32, common to a ray's Es and Ep).
* ``ref_undulator.npz``'s far-field, elliptic, tapered and near-field maps
  through the kernel at the limits of ``tests/test_undulator.py``.
* The dispatch predicate: true for the three variants in float32 and
  float64, false on the CPU (``engages``) and for each excluded case;
  ``integral.calls`` and ``integral.fused`` while tracing; one launch a
  ray block; the table holds the nodes of nonzero weight only.
"""
import torch_harness

import ctypes
import os

import numpy as np
import pytest
import torch

from xrt_tpu_torch import profiler
from xrt_tpu_torch.sources import Undulator
from xrt_tpu_torch.sources import undulator, undulator_integral as ui

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
F32, F64 = torch.float32, torch.float64

# the C entry point of csrc/undulator_integral.cu for the host: every ray,
# the table in the kernel's tiles of 128 nodes
HARNESS = r"""
#include <cuda_runtime.h>
#include "undulator_integral.cuh"
using namespace xund;
constexpr int TILE = 128;

template <typename T>
static void run(const double* num, const int* ints, long long n,
                const void* const* in, const void* table, void* const* out) {
  const Params<T> p = make_params<T>(num, ints, table);
  const Rays<T> r = make_rays<T>(in, out, n);
  for (long long i = 0; i < n; ++i) {
    if (p.mode == TAPER)
      integrate_at<T, TAPER>(p, r, i, TILE);
    else if (p.mode == NEAR)
      integrate_at<T, NEAR>(p, r, i, TILE);
    else
      integrate_at<T, FAR>(p, r, i, TILE);
  }
}

extern "C" int undulator_integral_launch(
    int is_double, const double* num, const int* ints, long long n,
    const void* const* in, const void* table, void* const* out, void*) {
  if (is_double)
    run<double>(num, ints, n, in, table, out);
  else
    run<float>(num, ints, n, in, table, out);
  return 0;
}
"""

#: the source of tests/test_undulator.py
GOLDEN_UND = dict(nrays=1000, eE=6.0, eI=0.1, eEpsilonX=0.0, eEpsilonZ=0.0,
                  period=33.0, n=50, K=1.5, eMin=9000, eMax=9600,
                  xPrimeMax=0.02, zPrimeMax=0.02, gNodes=400, gIntervals=2)
#: the cases: the source's arguments over GOLDEN_UND
CASES = {
    'far': {},
    'elliptic': dict(K=None, Kx=1.0, Ky=1.2, phaseDeg=30.0, eMin=4000,
                     eMax=4500),
    'espread': dict(eEspread=1e-3),
    'harmonic': dict(eMin=6000),
    'taper': dict(n=10, gNodes=120, taper=(1.09, 11.0)),
    'near': dict(n=10, gNodes=120, R0=5000.0),
}
NRAYS = 1200


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    """csrc/undulator_integral.cuh behind the kernel's C entry point, built
    for the host."""
    lib = torch_harness.host_build(
        tmp_path_factory, 'undulator_integral', {'harness.cpp': HARNESS},
        headers=('undulator_integral.cuh',))
    lib.undulator_integral_launch.argtypes = ui._ARGTYPES + [ctypes.c_void_p]
    lib.undulator_integral_launch.restype = ctypes.c_int
    return lib


@pytest.fixture
def launches(host_lib, monkeypatch):
    """The host build in place of the kernel's launch, and the dispatch
    made to engage on CPU tensors; the list of the C arguments of every
    launch."""
    calls = []

    def launch(args, device):
        calls.append(args)
        assert host_lib.undulator_integral_launch(*args, None) == 0
    monkeypatch.setattr(ui, '_launch', launch)
    monkeypatch.setattr(ui, 'engages', ui.handles)
    return calls


def source(case, dtype=F64):
    return Undulator.create(**dict(GOLDEN_UND, **CASES[case]), dtype=dtype,
                            device='cpu')


def rays(und, n=NRAYS, seed=5):
    """(E, theta, psi, dgamma) float64 over the source's acceptance; dgamma
    a normal energy-spread shift where the source has a spread."""
    rng = np.random.RandomState(seed)
    E = rng.uniform(und.eMin, und.eMax, n)
    th = rng.uniform(und.Theta_min, und.Theta_max, n)
    ps = rng.uniform(und.Psi_min, und.Psi_max, n)
    dg = rng.normal(size=n) * und.gamma * und.eEspread \
        if und.eEspread > 0 else None
    return E, th, ps, dg


def i_map(und, case, dtype, E, th, ps, dg):
    """``build_I_map`` of the numpy rays in *dtype* (for 'harmonic' the
    mask of the 2nd harmonic, ww1 in [1.5, 2.5]: the rays below ~7300 eV
    fall outside it)."""
    def T(v):
        return None if v is None else torch.as_tensor(v, dtype=dtype)
    return und.build_I_map(None, T(E), T(th), T(ps),
                           dgamma=None if dg is None else T(dg),
                           harmonic=2 if case == 'harmonic' else None)


def outputs(case, got):
    """The outputs held: I, Es, Ep; in the near field I, |Es|, |Ep|, Es Ep*
    (float64 on the CPU)."""
    I, Es, Ep = (v.to(torch.complex128 if v.is_complex() else F64)
                 for v in got)
    if case == 'near':
        return [I, Es.abs(), Ep.abs(), Es * Ep.conj()]
    return [I, Es, Ep]


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# ---- the kernel against the plain loop ------------------------------------

@pytest.mark.parametrize('case', list(CASES))
def test_float64_kernel_matches_the_plain_loop(launches, case):
    und = source(case)
    r = rays(und)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ui, 'engages', lambda *a: False)
        want = i_map(und, case, F64, *r)
    assert not launches
    got = i_map(und, case, F64, *r)
    assert len(launches) == 1 and launches[0][0] == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    for g, w in zip(outputs(case, got), outputs(case, want)):
        assert rel(g, w) < 1e-9
    I = want[0]
    # the rays cover the harmonic's peak and its flanks
    assert int((I > 0.5 * I.max()).sum()) > 5
    assert int((I < 1e-2 * I.max()).sum()) > 100
    if case == 'harmonic':
        assert int((I == 0).sum()) > 100


@pytest.mark.parametrize('case', list(CASES))
def test_float32_kernel_no_farther_from_float64_than_the_plain_loop(
        launches, case):
    """On float32 rays, the kernel's outputs are no farther from the
    float64 plain loop on the same numbers than twice the plain float32
    loop's."""
    und32, und64 = source(case, F32), source(case)
    r = [None if v is None else np.asarray(
        torch.as_tensor(v, dtype=F32), np.float64) for v in rays(und64)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ui, 'engages', lambda *a: False)
        ref = outputs(case, i_map(und64, case, F64, *r))
        plain = outputs(case, i_map(und32, case, F32, *r))
    got32 = i_map(und32, case, F32, *r)
    assert len(launches) == 1 and launches[0][0] == 0
    assert got32[0].dtype == F32 and got32[1].dtype == torch.complex64
    for g, p, w in zip(outputs(case, got32), plain, ref):
        e_plain, e_kernel = rel(p, w), rel(g, w)
        assert e_plain > 0
        assert e_kernel <= 2 * e_plain, (e_kernel, e_plain)


@pytest.fixture(scope='module')
def und_ref():
    return np.load(os.path.join(GOLDEN, 'ref_undulator.npz'))


GOLDEN_CASES = {'und': {}, 'unde': CASES['elliptic'],
                'undt': CASES['taper'], 'undn': CASES['near']}


@pytest.mark.parametrize('tag', list(GOLDEN_CASES))
def test_golden_maps_through_the_kernel(launches, und_ref, tag):
    """``ref_undulator.npz``'s maps through the kernel, float64, at the
    limits of ``tests/test_undulator.py`` (the near-field amplitudes up to
    the per-energy global phase that test removes)."""
    und = Undulator.create(**dict(GOLDEN_UND, **GOLDEN_CASES[tag]),
                           dtype=F64, device='cpu')
    E = und_ref['und_E'] * (0.5 if tag == 'unde' else 1.0)
    th, ps = und_ref['und_theta'], und_ref['und_psi']
    I, Es, Ep = (v.numpy() for v in und.build_I_map(
        None, *(torch.from_numpy(v) for v in (E, th, ps))))
    assert len(launches) == 1
    if tag != 'undn':
        np.testing.assert_allclose(I, und_ref[tag + '_I'], rtol=1e-6,
                                   atol=1e-3)
        np.testing.assert_allclose(Es, und_ref[tag + '_Es'], rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(Ep, und_ref[tag + '_Ep'], rtol=1e-6,
                                   atol=1e-8)
        return
    np.testing.assert_allclose(I, und_ref['undn_I'], rtol=1e-5, atol=1e-3)
    phase = np.ones_like(Es)
    for e in np.unique(E):
        sel = E == e
        zr = und_ref['undn_Es'][sel][0] / Es[sel][0]
        phase[sel] = zr / np.abs(zr)
    np.testing.assert_allclose(Es * phase, und_ref['undn_Es'], rtol=1e-5,
                               atol=1e4)
    np.testing.assert_allclose(Ep * phase, und_ref['undn_Ep'], rtol=1e-5,
                               atol=1e4)


# ---- the dispatch predicate ---------------------------------------------

def _args(dtype=F32, n=16):
    """The six ray tensors ``build_I_map`` hands the integral."""
    v = torch.full((n,), 1.0, dtype=dtype)
    return (v * 5, v * 9300.0, v * 2.0, v * 1.2e4, v * 1e-5, v * 2e-5)


@pytest.mark.parametrize('dt', ['float32', 'float64'])
@pytest.mark.parametrize('case', ['far', 'elliptic', 'taper', 'near'])
def test_the_variants_are_handled_and_engage_only_on_a_card(case, dt):
    und = source(case)
    args = _args(getattr(torch, dt))
    assert ui.mode(und) == {'taper': ui.TAPER, 'near': ui.NEAR}.get(
        case, ui.FAR)
    assert ui.handles(und, *args)
    assert not ui.engages(und, *args)


def _excluded(name):
    """(source, six ray tensors) of an excluded case."""
    und = source('far')
    args = list(_args())
    if name == 'grad':
        args[4] = args[4].clone().requires_grad_()
    elif name == 'grad_K':
        und = und.replace(Ky=torch.tensor(1.5, dtype=F64,
                                          requires_grad=True))
    elif name == 'half':
        args = [a.half() for a in args]
    elif name == 'bfloat16':
        args = [a.bfloat16() for a in args]
    elif name == 'mixed_dtype':
        args[5] = args[5].double()
    elif name == 'shape':
        args[1] = args[1][:8]
    elif name == 'taper_and_near':
        und = source('taper').replace(R0=5000.0)
    elif name == 'tensor_R0':
        und = und.replace(R0=torch.tensor(5000.0))
    elif name == 'no_weights':
        und = und.replace(ag=np.zeros_like(und.ag))
    return und, args


EXCLUDED = ('grad', 'grad_K', 'half', 'bfloat16', 'mixed_dtype', 'shape',
            'taper_and_near', 'tensor_R0', 'no_weights')


@pytest.mark.parametrize('name', EXCLUDED)
def test_everything_else_keeps_the_plain_loop(name):
    und, args = _excluded(name)
    assert not ui.handles(und, *args)
    if name in ('grad', 'grad_K'):   # no autograd to record
        with torch.no_grad():
            assert ui.handles(und, *args)


def test_a_gradient_takes_the_plain_loop(launches):
    """Rays that require grad go through the plain loop, and the gradient
    flows to them."""
    und = source('far')
    E, th, ps, _ = (torch.as_tensor(v) if v is not None else None
                    for v in rays(und, n=50))
    th = th.clone().requires_grad_()
    I = und.build_I_map(None, E, th, ps)[0]
    assert not launches
    g, = torch.autograd.grad(I.sum(), [th])
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


# ---- counters, launches and the table ------------------------------------

def test_build_I_map_counts_its_calls_and_the_fused_ones(launches,
                                                         monkeypatch):
    und = source('far')
    E, th, ps, _ = (torch.as_tensor(v) if v is not None else None
                    for v in rays(und, n=64))

    def counted():
        profiler.reset()
        with profiler.tracing():
            und.build_I_map(None, E, th, ps)
        out = {}
        for c in profiler.counters().values():
            out.update(c)
        profiler.reset()
        return out
    got = counted()
    nodes = int(np.count_nonzero(und.ag))
    assert got == {'integral.calls': 1, 'integral.fused': 1,
                   'integral.node_evals': 64 * nodes}
    assert len(launches) == 1
    monkeypatch.setattr(ui, 'engages', lambda *a: False)
    assert counted() == {'integral.calls': 1,
                         'integral.node_evals': 64 * nodes}
    assert len(launches) == 1


def test_one_launch_a_ray_block_and_the_nonzero_nodes(launches,
                                                      monkeypatch):
    """A shine of 3000 candidates in blocks of 1000 is three launches, each
    of the nodes of nonzero weight (800 of the 832 of the padded grid) and
    one copy in the far field, Np copies in the near field; the launches
    are counted by variant and dtype."""
    monkeypatch.setattr(undulator, 'RAY_BLOCK', 1000)
    ui.LAUNCHES.clear()
    und = source('far', F32).replace(nrays=750)
    assert len(und.ag) == 832 and np.count_nonzero(und.ag) == 800
    beam = und.shine(torch.Generator().manual_seed(4))
    assert beam.x.shape == (750,)
    assert len(launches) == 3
    for args in launches:
        assert list(args[2]) == [ui.FAR, 1, 800]
    near = source('near')
    v = _args(F64)
    near.build_I_map(None, v[1], v[4], v[5])
    assert list(launches[-1][2]) == [ui.NEAR, 10, 240]
    assert dict(ui.LAUNCHES) == {
        'undulator_integral:far:torch.float32': 3,
        'undulator_integral:near:torch.float64': 1}
    ui.LAUNCHES.clear()


def test_the_table_is_kept_per_grid_phase_and_dtype():
    und = source('elliptic')
    t = ui.node_table(und, F64, torch.device('cpu'))
    assert ui.node_table(und, F64, torch.device('cpu')) is t
    assert t.shape == (8, np.count_nonzero(und.ag))
    x = und.tg[und.ag != 0]
    np.testing.assert_array_equal(t[0].numpy(), x)
    np.testing.assert_allclose(t[4].numpy(), np.sin(x + und.phase),
                               rtol=0, atol=1e-15)
    assert ui.node_table(und.replace(phase=0.0), F64,
                         torch.device('cpu')) is not t
    assert ui.node_table(und, F32, torch.device('cpu')).dtype == F32


@pytest.mark.parametrize('engaged', [True, False])
def test_the_benchmark_reads_the_fused_share(launches, monkeypatch,
                                             engaged):
    """The benchmark's reader ``und.integral_fused`` over two traced
    passes of the cell's source, screen and plot (``beambench/configs/
    undulator.py`` at 500 rays and 16 x 2 nodes): 100 where the kernel
    served every call, None where the program counted no
    ``integral.fused``."""
    import sys
    from xrt_tpu_torch.runner import run_ray_tracing
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'beambench'))
    import harness
    cfg = harness.load_json('configs', 'undulator.json')
    cfg = dict(cfg, nrays=500, dtype='float32',
               undulator=dict(cfg['undulator'], gNodes=16))
    drv = harness.load_module('configs', 'undulator')
    src, screen = drv.build(cfg, 'cpu')
    plot = drv.make_plot(cfg)
    if not engaged:
        monkeypatch.setattr(ui, 'engages', lambda *a: False)
    profiler.reset()
    try:
        with profiler.tracing():
            run_ray_tracing([plot], repeats=2, run_process=lambda bl, g: {
                cfg['plot']['beam']: screen.expose(src.shine(g))},
                rng=torch.Generator().manual_seed(0))
        got = harness.load_module('metrics', 'und.integral_fused').read({})
    finally:
        profiler.reset()
    assert len(launches) == (2 if engaged else 0)
    assert got == (100.0 if engaged else None)
