"""The port's bent-crystal analyzers and xrt's speed test 1 against the JAX
package, float64, on the same numpy rays.

* Every class of ``oes/bragg.py`` (Johann and Johansson cylinders, the
  parabolic cross-section, Johann and Johansson toroids with and without
  an asymmetry angle, the general Bragg toroid, the flat diced OE and the
  diced Johann and Johansson toroids): ``local_z``, ``local_n`` and
  ``rays_good`` on a grid of points that holds the facet edges of the
  diced elements (points at half steps, where the facet index rounds half
  to even, and at the gap edges), to 1e-12 of each quantity's largest
  magnitude with states equal; and ``reflect`` of 1500 rays from a point
  near the Rowland circle (Si(444) at 60 deg, the search included) with
  the JAX package under ``jax.jit``: directions, coherency and energies to
  1e-9, positions to 1e-9 of the crystal's size, states equal.
* Speed test 1 (``tools/torch_bench_analyzer.py``) at 2000 rays x 2
  iterations x 3 sources: the rays of the JAX package's sources, traced
  by both packages, and the three histograms (400 x 400, 128 x 128,
  128 x 128) to 1e-9 of their largest bin, the non-empty bins identical.
"""
import importlib.util
import math
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
import xrt_tpu.oes as joes
from xrt_tpu import beam as jbeam
from xrt_tpu.histogram import hist2d as jhist2d
from xrt_tpu_torch import interop
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch import oes as toes

F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D111, R, THETA = 3.1354161, 500.0, math.radians(60.0)
P = 2 * R * math.sin(THETA)
FACETS = dict(dxFacet=2.1, dyFacet=1.4, dxGap=0.05, dyGap=0.05)
LIMS = dict(limPhysX=(-50.0, 50.0), limPhysY=(-50.0, 50.0))
RS = 2 * R * math.sin(THETA) ** 2
CLASSES = {
    'JohannCylinder': dict(Rm=R),
    'JohannCylinder_parabolic': dict(Rm=R, crossSection='parabolic'),
    'JohannCylinder_alpha': dict(Rm=R, alpha=0.05),
    'JohanssonCylinder': dict(Rm=R),
    'JohanssonCylinder_alpha': dict(Rm=R, alpha=-0.03),
    'JohannToroid': dict(Rm=R, Rs=RS),
    'JohannToroid_alpha': dict(Rm=R, Rs=RS, alpha=0.04),
    'JohanssonToroid': dict(Rm=R, Rs=RS),
    'JohanssonToroid_alpha': dict(Rm=R, Rs=RS, alpha=0.02),
    'GeneralBraggToroid': dict(Rm=R, Rs=RS, RmBragg=2 * R, RsBragg=RS * 2),
    'DicedOE': dict(**FACETS),
    'DicedJohannToroid': dict(Rm=R, Rs=RS, **FACETS),
    'DicedJohanssonToroid': dict(Rm=R, Rs=RS, **FACETS),
}
REFLECTED = ('JohannCylinder_alpha', 'JohanssonCylinder', 'JohannToroid',
             'JohanssonToroid_alpha', 'GeneralBraggToroid', 'DicedOE',
             'DicedJohanssonToroid')


def crystals():
    kw = dict(hkl=(4, 4, 4), d=D111 / 4, elements='Si', rho=2.33)
    return (jm.CrystalDiamond.create(**kw),
            tm.CrystalDiamond.create(dtype=F64, device='cpu', **kw))


def pair(case, **extra):
    cls = case.split('_')[0]
    kw = dict(CLASSES[case], **LIMS, **extra)
    return getattr(joes, cls).create(**kw), getattr(toes, cls).create(**kw)


def grid():
    """Points over the crystal with the facet centres, half steps (facet
    index ties) and the gap edges of the diced elements among them."""
    sx, sy = 2.1 + 0.05, 1.4 + 0.05
    xs = np.concatenate([np.arange(-20, 21) * sx / 2,
                         np.arange(-10, 11) * sx + 1.05,
                         np.linspace(-49, 49, 37)])
    ys = np.concatenate([np.arange(-30, 31) * sy / 2,
                         np.arange(-15, 16) * sy - 0.7,
                         np.linspace(-49, 49, 29)])
    X, Y = np.meshgrid(xs, ys)
    return X.ravel(), Y.ravel()


def close(t, j, tol, scale=None):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if scale is None:
        scale = max(float(np.abs(j).max()), 1e-300)
    assert np.abs(t - j).max() / scale < tol


@pytest.mark.parametrize('case', sorted(CLASSES))
def test_surface_normal_and_facets_match_jax(case):
    jel, tel = pair(case)
    x, y = grid()
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    close(tel.local_z(tx, ty), jel.local_z(jx, jy), 1e-12, scale=R)
    jn, tn = jel.local_n(jx, jy), tel.local_n(tx, ty)
    assert len(jn) == len(tn)
    for a, b in zip(tn, jn):
        close(a * torch.ones_like(tx), jnp.asarray(b) * jnp.ones_like(jx),
              1e-12, scale=1.0)
    state = np.ones(x.shape, np.int32)
    js = np.asarray(jel.rays_good(jx, jy, jnp.asarray(state)))
    ts = tel.rays_good(tx, ty, torch.from_numpy(state)).numpy()
    np.testing.assert_array_equal(ts, js)
    if 'Diced' in case:
        # the gaps take rays: some points of the grid lie in them
        assert (ts == -1).sum() > 100 and (ts == 1).sum() > 100


def analyzer_rays(n=1500, seed=2):
    """Rays from near the Rowland circle onto the analyzer, float64."""
    rng = np.random.RandomState(seed)
    a = np.tan(rng.uniform(-0.05, 0.05, n))
    c = np.tan(rng.uniform(-0.04, 0.04, n))
    norm = np.sqrt(1 + a ** 2 + c ** 2)
    E0 = 9132.0
    return dict(x=rng.normal(0, 0.085, n), y=np.zeros(n),
                z=rng.normal(0, 0.03, n), a=a / norm, b=1 / norm,
                c=c / norm, E=rng.uniform(E0 - 7, E0 + 7, n),
                state=np.ones(n, np.int32), path=np.zeros(n),
                Jss=np.full(n, 0.5), Jpp=np.full(n, 0.5),
                Jsp=np.zeros(n, complex))


def compare_beams(t, j, tol=1e-9):
    for f in ('x', 'y', 'z'):
        close(getattr(t, f), getattr(j, f), tol, scale=50.0)
    for f in ('a', 'b', 'c'):
        close(getattr(t, f), getattr(j, f), tol, scale=1.0)
    jJ = max(float(np.abs(np.asarray(getattr(j, f))).max())
             for f in ('Jss', 'Jpp', 'Jsp'))
    for f in ('Jss', 'Jpp', 'Jsp'):
        close(getattr(t, f), getattr(j, f), tol, scale=jJ)
    close(t.E, j.E, tol)
    np.testing.assert_array_equal(t.state.numpy(), np.asarray(j.state))


@pytest.fixture(scope='module')
def mats():
    return crystals()


@pytest.mark.parametrize('case', REFLECTED)
def test_reflect_matches_jax(mats, case):
    jcr, tcr = mats
    place = dict(center=(0, P, 0), pitch=THETA)
    jel, _ = pair(case, material=jcr, **place)
    _, tel = pair(case, material=tcr, **place)
    d = analyzer_rays()
    jb = jbeam.Beam(**{k: jnp.asarray(v) for k, v in d.items()})
    jglo, jloc = jax.jit(lambda b: jel.reflect(b))(jb)
    tglo, tloc = tel.reflect(interop.beam_from_numpy(d, device='cpu',
                                                     dtype=F64))
    compare_beams(tglo, jglo)
    compare_beams(tloc, jloc)
    good = tloc.state.numpy() == 1
    assert good.mean() > 0.3
    assert np.isfinite((tloc.Jss + tloc.Jpp).numpy()).all()


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'tools', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_speed_test_1_histograms_match_jax():
    """Two iterations of 2000 rays from each of the three sources: the JAX
    package's rays, both packages' traces and histograms."""
    jtool, ttool = _load_tool('bench_analyzer'), \
        _load_tool('torch_bench_analyzer')
    jsrc, jan, jdet, jlim = jtool.build(2000)
    tsrc, tan, tdet, tlim = ttool.build(2000, F64, 'cpu')
    np.testing.assert_allclose(tlim, jlim, rtol=1e-15)
    assert float(tan.pitch) == float(jan.pitch)

    @jax.jit
    def jstep(b):
        glo, loc = jan.reflect(b)
        det = jdet.expose(glo)
        out = []
        for name, xf, yf, bins, xl, yl in ttool.HISTS:
            bb = loc if name == 'local' else det
            w = jnp.where(bb.state == 1, bb.Jss + bb.Jpp, 0.0)
            out.append(jhist2d(getattr(bb, xf), getattr(bb, yf), w, bins,
                               bins, xl, yl))
        return out

    fields = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'state', 'path', 'Jss',
              'Jpp', 'Jsp')
    for i, src in enumerate(jsrc):
        jacc = tacc = None
        for it in range(2):
            with jax.disable_jit():
                beam = src.shine(jax.random.PRNGKey(10 * i + it))
            d = {f: np.asarray(getattr(beam, f)) for f in fields}
            jh = jstep(beam)
            th = ttool.histograms(*ttool.trace(
                tan, tdet, interop.beam_from_numpy(d, device='cpu',
                                                   dtype=F64)))
            jacc = jh if jacc is None else [a + h for a, h in zip(jacc, jh)]
            tacc = th if tacc is None else [a + h for a, h in zip(tacc, th)]
        for t, j in zip(tacc, jacc):
            j = np.asarray(j)
            assert j.sum() > 0
            np.testing.assert_array_equal(t.numpy() != 0, j != 0)
            close(t, j, 1e-9)
