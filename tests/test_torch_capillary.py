"""The port's parametric mirrors, capillaries, multiple reflection and
DualVFM against the JAX package.

* ``ParabolicalMirrorParam`` (p and q forms), ``HyperbolicMirrorParam``
  and a cylindrical ``EllipticalMirrorParam``:
  ``reflect`` of the same numpy rays, every field to 1e-9 in float64 (the
  JAX package under ``jit``).
* ``EllipsoidCapillaryMirror``, ``ParaboloidCapillaryMirror`` and
  ``HyperboloidCapillaryMirror``: one ``reflect`` and
  ``multiple_reflect(maxReflections=8)`` of the same rays, every field,
  ``nRefl`` and the last bounce's local beam to 1e-9.  The capillaries'
  material is a mirror, which draws nothing, so the JAX package's
  per-bounce keys (``fold_in(key, i)``) have no counterpart to match.
* ``DualVFM`` on both cylinders (``select_surface``) to 1e-9.
* ``tests/test_parametric.py``'s four focus checks and
  ``tests/test_multiple_reflect.py`` on the port.
* The gradient of a focal sharpness in the ellipse's semi-minor axis
  through the parametric intersection search against a central
  difference (the counterpart of ``tests/test_gradients.py::
  test_grad_ellipse_semiaxis_through_parametric_intersection_fd``, at 400
  rays).
"""
import math

import numpy as np
import pytest
import torch
import jax

import xrt_tpu.materials as jm
import xrt_tpu.oes as jo
from xrt_tpu_torch import materials as tm, oes as to
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import GeometricSource
from test_torch_dcm import compare, jax_beam, port_beam, rays_np

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
E0, P, PITCH = 9000.0, 10000.0, 4e-3
FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'path', 'Jss', 'Jpp', 'Jsp')


def _mat(mod, **kw):
    return mod.Material.create('Rh', rho=12.41, **kw)


CONICS = {
    'parabola_p': ('ParabolicalMirrorParam', dict(p=P)),
    'parabola_q': ('ParabolicalMirrorParam', dict(q=2000.0)),
    'hyperbola': ('HyperbolicMirrorParam', dict(p=P, q=3000.0)),
    'ellipse_cyl': ('EllipticalMirrorParam',
                    dict(p=P, q=2000.0, isCylindrical=True)),
}


@pytest.mark.parametrize('case', sorted(CONICS))
def test_conic_reflect_matches_jax(case):
    cls, kw = CONICS[case]
    kw = dict(kw, pitch=PITCH, center=(0, P, 0), limPhysX=(-20, 20),
              limPhysY=(-400, 400))
    jmir = getattr(jo, cls).create(material=_mat(jm), **kw)
    tmir = getattr(to, cls).create(material=_mat(tm, **KW), **kw)
    d = rays_np(1500, seed=3, dE=0.0, div=4e-5, size=(0.3, 0.2))
    jr = jax.jit(lambda b: jmir.reflect(b))(jax_beam(d))
    tr = tmir.reflect(port_beam(d))
    assert (tr[0].state == 1).float().mean() > 0.5
    for t, j in zip(tr, jr):
        compare(t, j, fields=FIELDS)


def _annulus(n, seed, r=(0.0, 0.2), div=0.0, y0=890.0):
    """Rays starting at y = *y0* (10 mm before a capillary at y = 1000 of
    length 200), on an annulus in (x, z), about +y with an rms divergence
    *div*, float64 numpy."""
    rng = np.random.RandomState(seed)
    rad = rng.uniform(r[0], r[1], n)
    ang = rng.uniform(0, 2 * np.pi, n)
    a = rng.normal(0, div, n)
    c = rng.normal(0, div, n)
    return dict(x=rad * np.cos(ang), y=np.full(n, y0), z=rad * np.sin(ang),
                a=a, b=np.sqrt(1 - a ** 2 - c ** 2), c=c,
                E=np.full(n, E0), state=np.ones(n, np.int32),
                path=np.zeros(n), Jss=np.ones(n), Jpp=np.zeros(n),
                Jsp=np.zeros(n, complex))


# (class, its arguments, the rays, the most bounces a ray makes at least)
CAPILLARIES = {
    'ellipsoid': ('EllipsoidCapillaryMirror',
                  dict(ellipseA=5000.0, ellipseB=2.0, workingDistance=50.0),
                  dict(div=3e-3), 4),
    'paraboloid': ('ParaboloidCapillaryMirror', dict(q=500.0, r0=0.6),
                   dict(div=1e-2), 6),
    'hyperboloid': ('HyperboloidCapillaryMirror',
                    dict(hyperbolaA=5000.0, hyperbolaB=2.0,
                         workingDistance=50.0),
                    dict(r=(0.2, 0.5), div=1e-3), 1),
}


def _capillaries(case):
    cls, kw, rays, _ = CAPILLARIES[case]
    kw = dict(kw, center=(0, 1000.0, 0), limPhysX=(-5, 5),
              limPhysY=(-100, 100))
    jc = getattr(jo, cls).create(
        material=jm.Material.create('Si', rho=2.33, kind='mirror'), **kw)
    tc = getattr(to, cls).create(
        material=tm.Material.create('Si', rho=2.33, kind='mirror', **KW),
        **kw)
    return jc, tc, rays


@pytest.mark.parametrize('case', sorted(CAPILLARIES))
def test_capillary_reflect_and_multiple_reflect_match_jax(case):
    jc, tc, rays = _capillaries(case)
    d = _annulus(600, seed=4, **rays)
    jr = jax.jit(lambda b: jc.reflect(b))(jax_beam(d))
    tr = tc.reflect(port_beam(d))
    for t, j in zip(tr, jr):
        compare(t, j, fields=FIELDS)
    jm_ = jax.jit(lambda b: jc.multiple_reflect(b, maxReflections=8))(
        jax_beam(d))
    tm_ = tc.multiple_reflect(port_beam(d), maxReflections=8)
    compare(tm_[0], jm_[0], fields=FIELDS)
    np.testing.assert_array_equal(tm_[0].nRefl.numpy(),
                                  np.asarray(jm_[0].nRefl))
    compare(tm_[1], jm_[1], fields=FIELDS)
    assert int(tm_[0].nRefl.max()) >= CAPILLARIES[case][3], case


def test_dual_vfm_matches_jax():
    kw = dict(center=(0, P, 0), pitch=PITCH, R=5e6, limPhysX=(-40, 40),
              limPhysY=(-300, 300))
    jd = jo.DualVFM.create(material=_mat(jm), **kw)
    td = to.DualVFM.create(material=_mat(tm, **KW), **kw)
    for surf in ('cylinder1', 'cylinder2'):
        (js, jdx), (ts, tdx) = jd.select_surface(surf), \
            td.select_surface(surf)
        assert tdx == jdx and ts.curSurface == js.curSurface
        d = rays_np(800, seed=5, dE=0.0, div=2e-5, size=(1.0, 0.2))
        d['x'] = d['x'] - tdx
        jr = jax.jit(lambda b: js.reflect(b))(jax_beam(d))
        tr = ts.reflect(port_beam(d))
        for t, j in zip(tr, jr):
            compare(t, j, fields=FIELDS)
        z = ts.local_z(torch.tensor([-tdx], dtype=F64),
                       torch.tensor([0.0], dtype=F64))
        assert float(z[0]) < 0     # the beam sits in the chosen cylinder


# ---- tests/test_parametric.py and test_multiple_reflect.py -------------

def fan_source(nrays=20000, dzprime=5e-5):
    return GeometricSource.create(
        nrays=nrays, center=(0, 0, 0), dx=0.0, dz=0.0, distx=None,
        distz=None, distxprime=None, dxprime=0.0, dzprime=dzprime,
        distE='lines', energies=(E0,), polarization='horizontal', **KW)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize('cyl', [False, True])
def test_elliptical_point_and_cylinder_focus(cyl):
    p, q = 10000.0, 2000.0
    m = to.EllipticalMirrorParam.create(
        p=p, q=q, pitch=PITCH, center=(0, p, 0), isCylindrical=cyl,
        limPhysX=(-20, 20), limPhysY=(-400, 400))
    screen = Screen.create(center=(0, p + q * math.cos(2 * PITCH),
                                   q * math.sin(2 * PITCH)))
    img = screen.expose(m.reflect(fan_source().shine(_gen(int(cyl))))[0])
    good = (img.state == 1).numpy()
    assert good.mean() > 0.9
    z = img.z.numpy()[good]
    assert z.std() < 1e-3
    assert abs(z.mean()) < 1e-3


def test_parabolic_collimation():
    m = to.ParabolicalMirrorParam.create(
        p=P, pitch=PITCH, center=(0, P, 0), limPhysX=(-20, 20),
        limPhysY=(-400, 400))
    glo, _ = m.reflect(fan_source().shine(_gen(2)))
    good = (glo.state == 1).numpy()
    assert good.mean() > 0.9
    ang = np.arctan2(glo.c.numpy()[good], glo.b.numpy()[good])
    assert ang.std() < 1e-7
    np.testing.assert_allclose(ang.mean(), 2 * PITCH, rtol=1e-3)


def test_hyperbolic_virtual_focus():
    p, q = 10000.0, 3000.0
    m = to.HyperbolicMirrorParam.create(
        p=p, q=q, pitch=PITCH, center=(0, p, 0), limPhysX=(-20, 20),
        limPhysY=(-400, 400))
    glo, _ = m.reflect(fan_source(dzprime=2e-5).shine(_gen(3)))
    good = (glo.state == 1).numpy()
    assert good.mean() > 0.8
    y0, z0 = glo.y.numpy()[good], glo.z.numpy()[good]
    slope = glo.c.numpy()[good] / glo.b.numpy()[good]
    A = np.vstack([slope, np.ones_like(slope)]).T
    sol, *_ = np.linalg.lstsq(A, slope * y0 - z0, rcond=None)
    np.testing.assert_allclose(sol[0], p - q * math.cos(2 * PITCH),
                               rtol=0.02)


def test_capillary_multiple_bounces():
    """Rays entering an ellipsoidal capillary off axis bounce several
    times, exit with nRefl >= 1 and gain no flux."""
    cap = to.EllipsoidCapillaryMirror.create(
        ellipseA=5000.0, ellipseB=2.0, workingDistance=50.0,
        center=(0, 1000.0, 0),
        material=tm.Material.create('Si', rho=2.33, kind='mirror', **KW),
        limPhysX=(-5, 5), limPhysY=(-100, 100))
    src = GeometricSource.create(
        nrays=2000, distx='annulus', dx=(0.3, 0.8), dz=0.0, distz=None,
        distxprime=None, distzprime=None, dxprime=0.0, dzprime=0.0,
        distE='lines', energies=(E0,), polarization='horizontal', **KW)
    glo, loc = cap.multiple_reflect(src.shine(_gen(0)), maxReflections=8)
    good = (glo.state == 1).numpy()
    assert good.sum() > 100
    assert glo.nRefl.numpy()[good].max() >= 1
    assert np.isfinite(glo.x.numpy()).all()
    J = (glo.Jss + glo.Jpp).numpy()
    assert (J[good] <= 1.0 + 1e-9).all()


def test_grad_ellipse_semiaxis_through_parametric_intersection_fd():
    """d(focal sharpness)/d(ellipseB) through the ray path's parametric
    intersection search (the Newton steps carry the gradient) against a
    central difference, float64, rtol 5e-3 (the JAX test's)."""
    p, q = 10000.0, 2000.0
    m0 = to.EllipticalMirrorParam.create(
        p=p, q=q, pitch=PITCH, center=(0, p, 0), material=_mat(tm, **KW),
        limPhysX=(-20, 20), limPhysY=(-300, 300))
    screen = Screen.create(center=(0, p + q, 2 * PITCH * q))
    src = GeometricSource.create(nrays=400, dx=0.05, dz=0.05, dxprime=3e-5,
                                 dzprime=3e-5, energies=(E0,),
                                 distE='lines', **KW)
    beam = src.shine(_gen(11))

    def sharp(bscale):
        m = m0.replace(ellipseB=m0.ellipseB * bscale)
        img = screen.expose(m.reflect(beam)[0])
        w = torch.where(img.state == 1, img.Jss + img.Jpp, 0.0)
        return torch.sum(w * torch.exp(-(img.z / 0.02) ** 2)) / \
            torch.sum(w)

    s0 = torch.tensor(1.0, dtype=F64, requires_grad=True)
    g = float(torch.autograd.grad(sharp(s0), s0)[0])
    h = 1e-4
    with torch.no_grad():
        fd = (float(sharp(torch.tensor(1.0 + h, dtype=F64))) -
              float(sharp(torch.tensor(1.0 - h, dtype=F64)))) / (2 * h)
    assert np.isfinite(g) and abs(fd) > 0
    np.testing.assert_allclose(g, fd, rtol=5e-3)
