"""The port's Laguerre- and Hermite-Gaussian beams and mesh sources
against the JAX package.

* ``LaguerreGaussianBeam`` and ``HermiteGaussianBeam`` of a few orders:
  the field on a screen's grid 5 m on (``prepare_wave_on_screen``), Es,
  Ep and the coherency matrix to 1e-9 of their largest, float64.
* ``MeshSource``, ``NESWSource`` and ``CollimatedMeshSource``: every ray
  equal to the JAX package's to 1e-15; ``shrink_source`` gives the JAX
  package's divergence window.
* ``tests/test_gaussian_beams.py``'s eight checks on the port.
"""
import math

import numpy as np
import pytest
import torch
import jax
from scipy import special

import xrt_tpu.sources as js
from xrt_tpu.oes import FlatMirror as JFlat
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu.waves import prepare_wave_on_screen as jprep
from xrt_tpu_torch import sources as ts
from xrt_tpu_torch.oes import FlatMirror
from xrt_tpu_torch.physconsts import CHBAR
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.waves import prepare_wave_on_screen

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
E0 = 9000.0


def _field(src, prep, screen, L=5000.0, lim=0.3, n=41, **kw):
    xs = np.linspace(-lim, lim, n)
    wave = prep(screen, src, xs, xs, **kw)
    return src.shine(jax.random.PRNGKey(0) if not kw else None, wave,
                     toGlobal=False)


@pytest.mark.parametrize('kind,order', [('Laguerre', (1, 0)),
                                        ('Laguerre', (2, 1)),
                                        ('Hermite', (1, 0)),
                                        ('Hermite', (2, 1))])
def test_higher_order_gaussian_fields_match_jax(kind, order):
    arg = dict(vortex=order) if kind == 'Laguerre' else dict(TEM=order)
    common = dict(center=(0, 0, 0), w0=0.01, energies=(E0,))
    jsrc = getattr(js, kind + 'GaussianBeam')(**common, **arg)
    tsrc = getattr(ts, kind + 'GaussianBeam')(**common, **arg)
    jo = _field(jsrc, jprep, JScreen.create(center=(0, 5000.0, 0)))
    to = _field(tsrc, prepare_wave_on_screen,
                Screen.create(center=(0, 5000.0, 0)), **KW)
    for f in ('Es', 'Ep', 'Jss', 'Jpp', 'Jsp'):
        r = np.asarray(getattr(jo, f))
        scale = np.abs(r).max()
        if f in ('Es', 'Jss'):
            assert scale > 0
        np.testing.assert_allclose(getattr(to, f).numpy(), r, rtol=0,
                                   atol=1e-9 * max(scale, 1e-300))


MESHES = {
    'mesh': ('MeshSource', dict(minxprime=-1e-4, maxxprime=2e-4,
                                minzprime=-2e-4, maxzprime=1e-4, nx=5,
                                nz=7, center=(1, 2, 3))),
    'mesh_nocentral': ('MeshSource', dict(nx=3, nz=4,
                                          withCentralRay=False)),
    'nesw': ('NESWSource', dict(dxprime=2e-4, dzprime=1e-4)),
    'collimated': ('CollimatedMeshSource', dict(dx=2.0, dz=1.0, nx=9, nz=5,
                                                center=(0, 10, 0))),
}


@pytest.mark.parametrize('case', sorted(MESHES))
def test_mesh_sources_match_jax(case):
    name, kw = MESHES[case]
    if name == 'NESWSource':
        jb = getattr(js, name)(**kw).shine(jax.random.PRNGKey(0))
        tb = getattr(ts, name)(**kw, **KW).shine()
    else:
        kw = dict(kw, energies=(E0,))
        jb = getattr(js, name).create(**kw).shine(jax.random.PRNGKey(0))
        tb = getattr(ts, name).create(**kw, **KW).shine()
    assert tb.nrays == jb.nrays
    for f in ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'Jss', 'Jpp', 'Jsp'):
        np.testing.assert_allclose(getattr(tb, f).numpy(),
                                   np.asarray(getattr(jb, f)), rtol=0,
                                   atol=1e-15, err_msg=f)
    np.testing.assert_array_equal(tb.state.numpy(), np.asarray(jb.state))


def _shrink(mod, flat, key, **kw):
    mirror = flat.create(center=(0, 1000.0, 0), pitch=5e-3,
                         limPhysX=(-1.0, 1.0), limPhysY=(-40, 40))

    def trace(src):
        return {'foot': mirror.reflect(src.shine(key))[1]}
    return mod.shrink_source(trace, 'foot', -5e-3, 5e-3, -1e-3, 1e-3, 21,
                             21, **kw)


def test_shrink_source_matches_jax():
    j = _shrink(js, JFlat, jax.random.PRNGKey(0))
    t = _shrink(ts, FlatMirror, None, **KW)
    for f in ('minxprime', 'maxxprime', 'minzprime', 'maxzprime'):
        np.testing.assert_allclose(getattr(t, f), float(getattr(j, f)),
                                   rtol=1e-12, err_msg=f)


# ---- tests/test_gaussian_beams.py on the port ---------------------------

def test_polynomials_vs_scipy():
    x = np.linspace(-3, 3, 41)
    xt = torch.as_tensor(x)
    for n in (1, 2, 3, 5):
        np.testing.assert_allclose(ts.hermite_poly(n, xt).numpy(),
                                   special.eval_hermite(n, x), rtol=1e-10)
    for p in (1, 2, 3):
        for a in (0, 1, 2):
            np.testing.assert_allclose(
                ts.genlaguerre_poly(p, a, xt).numpy(),
                special.eval_genlaguerre(p, a, x), rtol=1e-9, atol=1e-9)


def _intensity(src, L=5000.0, lim=0.3, n=101):
    xs = np.linspace(-lim, lim, n)
    wave = prepare_wave_on_screen(Screen.create(center=(0, L, 0)), src, xs,
                                  xs, **KW)
    out = src.shine(None, wave, toGlobal=False)
    return xs, (out.Jss + out.Jpp).numpy().reshape(n, n)


def test_gaussian_beam_width():
    w0, L = 0.01, 5000.0
    xs, I = _intensity(ts.GaussianBeam.create(center=(0, 0, 0), w0=w0,
                                              energies=(E0,)), L=L)
    yR = E0 / float(CHBAR) * 1e7 / 2 * w0 ** 2
    Ix = I[I.shape[0] // 2]
    sigma = math.sqrt(float((Ix * xs ** 2).sum() / Ix.sum()))
    np.testing.assert_allclose(2 * sigma, w0 * math.sqrt(1 + (L / yR) ** 2),
                               rtol=0.02)


def test_laguerre_vortex_has_dark_center():
    _, I = _intensity(ts.LaguerreGaussianBeam(center=(0, 0, 0), w0=0.01,
                                              energies=(E0,), vortex=(1, 0)))
    mid = I.shape[0] // 2
    assert I[mid, mid] < 0.01 * I.max()


def test_hermite_mode_lobes():
    _, I = _intensity(ts.HermiteGaussianBeam(center=(0, 0, 0), w0=0.01,
                                             energies=(E0,), TEM=(1, 0)))
    mid = I.shape[0] // 2
    Ix = I[mid]
    assert Ix[mid] < 0.05 * Ix.max()
    assert Ix[:mid].max() > 0.5 * Ix.max() and \
        Ix[mid + 1:].max() > 0.5 * Ix.max()


def test_mesh_source():
    beam = ts.MeshSource.create(minxprime=-1e-4, maxxprime=1e-4,
                                minzprime=-2e-4, maxzprime=2e-4, nx=5, nz=7,
                                energies=(E0,), **KW).shine()
    assert beam.nrays == 5 * 7 + 1
    a = beam.a.numpy()
    assert a[0] == 0.0
    assert abs(a.min() + 1e-4) < 1e-12 and abs(a.max() - 1e-4) < 1e-12


def test_collimated_mesh_source():
    beam = ts.CollimatedMeshSource.create(dx=2.0, dz=1.0, nx=9, nz=5,
                                          energies=(E0,), **KW).shine()
    x = beam.x.numpy()
    assert x.min() == -1.0 and x.max() == 1.0
    np.testing.assert_allclose(beam.b.numpy(), 1.0)


def test_nesw_compass_rays():
    b = ts.NESWSource(dxprime=2e-4, dzprime=1e-4, **KW).shine(toGlobal=False)
    np.testing.assert_allclose(b.a.numpy(), [0.0, 2e-4, 0.0, -2e-4],
                               atol=1e-15)
    np.testing.assert_allclose(b.c.numpy(), [1e-4, 0.0, -1e-4, 0.0],
                               atol=1e-15)


def test_shrink_source_fits_mirror():
    mirror = FlatMirror.create(center=(0, 1000.0, 0), pitch=5e-3,
                               limPhysX=(-1.0, 1.0), limPhysY=(-40, 40))

    def trace(src):
        return {'foot': mirror.reflect(src.shine())[1]}
    mesh = ts.shrink_source(trace, 'foot', -5e-3, 5e-3, -1e-3, 1e-3, 21, 21,
                            **KW)
    assert (trace(mesh)['foot'].state.numpy()[1:] == 1).all()
    assert mesh.maxxprime < 2e-3 and mesh.minxprime > -2e-3
    assert mesh.maxzprime < 1e-3
