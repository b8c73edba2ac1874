"""The port's figure errors against the JAX package.

* ``ops.interp.map_coordinates`` against ``jax.scipy.ndimage.
  map_coordinates(order=1, mode='nearest')`` on numpy-seeded maps and
  coordinates inside, on and beyond the edges: 1e-12; its gradients in
  the map values and in the coordinates against the JAX package's.
* The maps of ``random_roughness`` (height and slope rms, one and two
  correlation lengths), ``gaussian_bump``, ``waviness``, ``planar_ridge``
  and ``imported_figure_error`` (arrays and a text file, with a *baseFE*)
  equal the JAX package's bit for bit (both float64 numpy); heights,
  normal rotations, rms and rms slopes on the device to 1e-12.
* ``reflect`` off a flat mirror, a toroid and an elliptical
  (parametric) mirror carrying a figure error, and the 3-vector normal
  hook: every field to 1e-9 in float64 (the JAX package under ``jit``).
* ``tests/test_figure_error.py``'s four checks, on the port.
* ``replace(zmap=amp * zmap)`` keeps *amp* on the tape, and a wave chain's
  focal flux through a figure-errored mirror has the gradient in the
  amplitude of a four-point finite difference (the counterpart of
  ``tests/test_gradients.py::test_grad_figure_error_amplitude_fd``).
"""
import torch_harness  # noqa: F401

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.scipy.ndimage import map_coordinates as jmap

import xrt_tpu.figure_error as jfe
import xrt_tpu.materials as jm
import xrt_tpu.oes as jo
from xrt_tpu_torch import figure_error as tfe, materials as tm, oes as to
from xrt_tpu_torch.ops.interp import map_coordinates
from xrt_tpu_torch.sources import GeometricSource
from test_torch_dcm import compare, jax_beam, port_beam, rays_np

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
E0, P, PITCH = 9000.0, 10000.0, 4e-3


def T(v):
    return torch.as_tensor(np.asarray(v, float), dtype=F64)


@pytest.mark.parametrize('shape', [(7, 9), (1, 5), (16, 3)])
def test_map_coordinates_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.normal(size=shape)
    c = np.stack([rng.uniform(-2, shape[0] + 1, 500),
                  rng.uniform(-2, shape[1] + 1, 500)])
    c[:, :20] = np.round(c[:, :20])          # on the nodes
    ref = np.asarray(jmap(a, c, order=1, mode='nearest'))
    at, ct = T(a).requires_grad_(), T(c).requires_grad_()
    got = map_coordinates(at, (ct[0], ct[1]))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-12)
    w = rng.normal(size=500)
    got.backward(T(w))
    ga, gc = jax.grad(lambda A, C: jnp.sum(
        jmap(A, C, order=1, mode='nearest') * w), argnums=(0, 1))(a, c)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), atol=1e-12)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc), atol=1e-12)


def _both(name, **kw):
    return getattr(jfe, name)(**kw), getattr(tfe, name)(**kw, **KW)


MAPS = [
    ('random_roughness', dict(rms=2.0, corrLength=3.0, seed=4)),
    ('random_roughness', dict(rms=0.5, rmsKind='slope', corrLength=4.0,
                              seed=1)),
    ('random_roughness', dict(rms=(1.0, 0.5), rmsKind='slope',
                              corrLength=5.0, seed=2)),
    ('random_roughness', dict(rms=1.0, corrLength=None, seed=3)),
    ('gaussian_bump', dict(height=30.0, sigmaX=2.0, sigmaY=8.0,
                           centerY=3.0)),
    ('waviness', dict(amplitude=5.0, period=20.0, phase=0.3)),
    ('waviness', dict(amplitude=2.0, period=3.0, direction='x')),
    ('planar_ridge', dict(height=4.0, width=6.0, centerY=2.0)),
]


@pytest.mark.parametrize('name,kw', MAPS)
def test_maps_and_their_evaluation_match_jax(name, kw):
    kw = dict(kw, limPhysX=(-10, 10), limPhysY=(-60, 60), gridStep=0.5)
    j, t = _both(name, **kw)
    for f in ('zmap', 'dzdx', 'dzdy', 'x0', 'y0', 'dx', 'dy'):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)
    rng = np.random.default_rng(5)
    x, y = rng.uniform(-12, 12, 2000), rng.uniform(-65, 65, 2000)
    np.testing.assert_allclose(
        t.local_z_distorted(T(x), T(y)).numpy(),
        np.asarray(j.local_z_distorted(jnp.asarray(x), jnp.asarray(y))),
        atol=1e-12 * float(np.abs(np.asarray(j.zmap)).max()) * 1e-6)
    for tn, jn in zip(t.local_n_distorted(T(x), T(y)),
                      j.local_n_distorted(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-15)
    np.testing.assert_allclose(float(t.get_rms()), float(j.get_rms()),
                               rtol=1e-12)
    for a, b in zip(t.get_rms_slope(), j.get_rms_slope()):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-12)


def test_imported_maps_with_a_base_match_jax(tmp_path):
    base_j, base_t = _both('waviness', amplitude=3.0, period=7.0,
                           limPhysX=(-5, 5), limPhysY=(-20, 20),
                           gridStep=0.5)
    rng = np.random.default_rng(8)
    xs, ys = np.linspace(-5, 5, 11), np.linspace(-20, 20, 41)
    z = rng.normal(size=(41, 11))
    j = jfe.imported_figure_error(array=z, x1d=xs, y1d=ys, recenter=True,
                                  baseFE=base_j)
    t = tfe.imported_figure_error(array=z, x1d=xs, y1d=ys, recenter=True,
                                  baseFE=base_t, **KW)
    np.testing.assert_allclose(t.zmap.numpy(), np.asarray(j.zmap),
                               rtol=0, atol=1e-12)
    X, Y = np.meshgrid(xs, ys)
    path = tmp_path / 'fe.txt'
    np.savetxt(path, np.c_[X.ravel(), Y.ravel(), z.ravel() * 1e-6])
    j = jfe.imported_figure_error(fileName=str(path))
    t = tfe.imported_figure_error(fileName=str(path), **KW)
    np.testing.assert_array_equal(t.zmap.numpy(), np.asarray(j.zmap))
    np.testing.assert_array_equal(t.dzdy.numpy(), np.asarray(j.dzdy))


FE_KW = dict(limPhysX=(-10, 10), limPhysY=(-200, 200), gridStep=0.5)


def _mirrors(kind):
    rough = dict(rms=20.0, corrLength=15.0, seed=7, **FE_KW)
    fj = jfe.random_roughness(**rough)
    ft = tfe.random_roughness(**rough, **KW)
    mj, mt = (jm.Material.create('Rh', rho=12.41),
              tm.Material.create('Rh', rho=12.41, **KW))
    kw = dict(center=(0, P, 0), pitch=PITCH, limPhysX=(-10, 10),
              limPhysY=(-200, 200))
    if kind == 'toroid':
        kw.update(R=2 * P / PITCH, r=50.0)
    if kind == 'ellipse':
        kw.update(p=P, q=2000.0)
    cls = dict(flat='FlatMirror', toroid='ToroidMirror',
               ellipse='EllipticalMirrorParam')[kind]
    return (getattr(jo, cls).create(material=mj, figure_error=fj, **kw),
            getattr(to, cls).create(material=mt, figure_error=ft, **kw))


@pytest.mark.parametrize('kind', ['flat', 'toroid', 'ellipse'])
def test_reflect_with_a_figure_error_matches_jax(kind):
    """The search finds the distorted surface (radially on the ellipse)
    and the normal turns by the slopes: every field to 1e-9."""
    jmir, tmir = _mirrors(kind)
    d = rays_np(2000, seed=9, dE=0.0, div=2e-5, size=(0.5, 0.3))
    jr = jax.jit(lambda b: jmir.reflect(b))(jax_beam(d))
    tr = tmir.reflect(port_beam(d))
    for t, j in zip(tr, jr):
        compare(t, j)
    # the error moves the reflected rays: the same mirror without it
    plain = tmir.replace(figure_error=None).reflect(port_beam(d))[0]
    assert float((plain.c - tr[0].c).abs().max()) > 1e-7


class _VectorFE:
    """A figure error whose normal hook is a 3-vector (the reference's
    other form)."""

    def __init__(self, fe):
        self.fe = fe

    def local_z_distorted(self, x, y):
        return self.fe.local_z_distorted(x, y)

    def local_n_distorted(self, x, y):
        a, b = self.fe.local_n_distorted(x, y)
        return [1e-3 * torch.sin(a) if isinstance(a, torch.Tensor) else
                1e-3 * jnp.sin(a), 0.5 * b, 0.0 * b]


def test_three_vector_normal_hook_matches_jax():
    jmir, tmir = _mirrors('flat')
    jv, tv = _VectorFE(jmir.figure_error), _VectorFE(tmir.figure_error)
    jcls = type('J', (jo.FlatMirror,), {
        'local_n_distorted': lambda s, x, y: jv.local_n_distorted(x, y)})
    tcls = type('T', (to.FlatMirror,), {
        'local_n_distorted': lambda s, x, y: tv.local_n_distorted(x, y)})
    kw = dict(center=(0, P, 0), pitch=PITCH, limPhysX=(-10, 10),
              limPhysY=(-200, 200))
    d = rays_np(500, seed=10, dE=0.0, div=2e-5, size=(0.5, 0.3))
    jr = jcls.create(figure_error=jmir.figure_error, **kw).reflect(
        jax_beam(d))
    tr = tcls.create(figure_error=tmir.figure_error, **kw).reflect(
        port_beam(d))
    for t, j in zip(tr, jr):
        compare(t, j)


# ---- tests/test_figure_error.py on the port -----------------------------

def test_waviness_rms():
    w = tfe.waviness(amplitude=5.0, period=20.0, limPhysX=(-10, 10),
                     limPhysY=(-100, 100), gridStep=0.25, **KW)
    np.testing.assert_allclose(float(w.get_rms()), 5.0 / math.sqrt(2),
                               rtol=0.02)
    z = w.local_z_distorted(T([0.0]), T([5.0]))
    np.testing.assert_allclose(float(z[0]), 5e-6 * math.sin(
        2 * math.pi * 5.0 / 20.0), rtol=0.05)


def test_random_roughness_rms():
    r = tfe.random_roughness(rms=2.0, corrLength=3.0, seed=4,
                             limPhysX=(-10, 10), limPhysY=(-100, 100),
                             gridStep=0.5, **KW)
    np.testing.assert_allclose(float(r.get_rms()), 2.0, rtol=1e-6)


def test_waviness_broadens_reflection():
    """Slope errors broaden the reflected angular distribution by ~2x the
    rms slope (within 15%)."""
    amp_nm, period = 50.0, 20.0
    w = tfe.waviness(amplitude=amp_nm, period=period, limPhysX=(-10, 10),
                     limPhysY=(-200, 200), gridStep=0.2, **KW)
    flat = to.FlatMirror.create(center=(0, P, 0), pitch=PITCH,
                                limPhysX=(-10, 10), limPhysY=(-200, 200))
    wavy = flat.replace(figure_error=w)
    src = GeometricSource.create(
        nrays=20000, dx=0.0, dz=0.0, distx=None, distz=None,
        distxprime=None, dxprime=0.0, dzprime=2e-5, distE='lines',
        energies=(E0,), polarization='horizontal', **KW)
    beam = src.shine(torch.Generator().manual_seed(0))
    gf, gw = flat.reflect(beam)[0], wavy.reflect(beam)[0]
    good = ((gw.state == 1) & (gf.state == 1)).numpy()
    ang_f = torch.atan2(gf.c, gf.b).numpy()[good]
    ang_w = torch.atan2(gw.c, gw.b).numpy()[good]
    slope_rms = 2 * math.pi * amp_nm * 1e-6 / period / math.sqrt(2)
    extra = np.sqrt(max(ang_w.std() ** 2 - ang_f.std() ** 2, 0.0))
    np.testing.assert_allclose(extra, 2 * slope_rms, rtol=0.15)


def test_bump_displaces_heights():
    g = tfe.gaussian_bump(height=100.0, sigmaX=2.0, sigmaY=10.0,
                          limPhysX=(-10, 10), limPhysY=(-100, 100),
                          gridStep=0.25, **KW)
    z0 = float(g.local_z_distorted(T([0.0]), T([0.0]))[0])
    np.testing.assert_allclose(z0, 100e-6, rtol=0.02)


# ---- gradients ----------------------------------------------------------

def test_amplitude_stays_on_the_tape():
    w = tfe.waviness(amplitude=1.0, period=25.0, **FE_KW, **KW)
    amp = torch.tensor(1.5, dtype=F64, requires_grad=True)
    fe = w.replace(zmap=amp * w.zmap, dzdx=amp * w.dzdx, dzdy=amp * w.dzdy)
    x, y = T(np.linspace(-3, 3, 50)), T(np.linspace(2, 9, 50))
    z = fe.local_z_distorted(x, y)
    g, = torch.autograd.grad(z.sum(), amp)
    np.testing.assert_allclose(float(g), float(
        w.local_z_distorted(x, y).sum()), rtol=1e-12)


def test_grad_figure_error_amplitude_fd():
    """d(focal flux)/d(figure-error amplitude) through a two-hop wave
    chain (slit -> Kirchhoff -> figure-errored mirror -> reflect ->
    Kirchhoff -> screen) against a four-point finite difference, float64,
    at the JAX test's geometry with fewer samples: the amplitude moves the
    receiving samples (retargeted by ``wave_frame_rotation``) and the
    reflected phase and normals.  rtol 2e-3, the JAX test's."""
    from xrt_tpu_torch.apertures import RectangularAperture
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GaussianBeam
    from xrt_tpu_torch.waves import (diffract, prepare_wave_on_aperture,
                                     prepare_wave_on_oe,
                                     prepare_wave_on_screen, reflect_wave,
                                     wave_frame_rotation)
    p, q, pitch = 5000.0, 2000.0, 5e-3
    mat = tm.Material.create('Rh', rho=12.41, **KW)
    fe_unit = tfe.waviness(amplitude=1.0, period=25.0, limPhysX=(-5, 5),
                           limPhysY=(-60, 60), gridStep=1.0, **KW)
    mirror0 = to.FlatMirror.create(center=(0, p, 0), pitch=pitch,
                                   material=mat, limPhysX=(-5, 5),
                                   limPhysY=(-60, 60), figure_error=fe_unit)
    slit = RectangularAperture.create(center=(0, 0, 0),
                                      opening=(-0.2, 0.2, -0.2, 0.2))
    screen = Screen.create(center=(0, p + q, 2 * pitch * q))
    gb = GaussianBeam.create(w0=0.08, distE='lines', energies=(E0,),
                             polarization='horizontal')
    waveSlit = prepare_wave_on_aperture(
        slit, gb, 300, generator=torch.Generator().manual_seed(3), **KW)
    slitBeam = gb.shine(None, waveSlit, toGlobal=False)
    wvM0 = prepare_wave_on_oe(mirror0, slit, (24, 32), **KW)
    zscr = np.linspace(-0.3, 0.3, 41)
    wvScr0 = prepare_wave_on_screen(screen, mirror0, np.asarray([0.0]),
                                    zscr, **KW)
    R = wave_frame_rotation(mirror0, slit)
    z_unit = fe_unit.local_z_distorted(wvM0.x, wvM0.y)
    wz = torch.exp(-(T(zscr) / 0.1) ** 2)

    def loss(amp):
        fe = fe_unit.replace(zmap=amp * fe_unit.zmap,
                             dzdx=amp * fe_unit.dzdx,
                             dzdy=amp * fe_unit.dzdy)
        m = mirror0.replace(figure_error=fe)
        dz = (amp - 1.0) * z_unit
        wvM = wvM0.replace(xDiffr=wvM0.xDiffr + R[0, 2] * dz,
                           yDiffr=wvM0.yDiffr + R[1, 2] * dz,
                           zDiffr=wvM0.zDiffr + R[2, 2] * dz,
                           z=wvM0.z + dz)
        b = diffract(slitBeam, wvM)
        _, loc = reflect_wave(m, b)
        out = diffract(loc, wvScr0)
        return torch.sum((out.Jss + out.Jpp) * wz) * 1e-10

    a0 = torch.tensor(1.0, dtype=F64, requires_grad=True)
    g = float(torch.autograd.grad(loss(a0), a0)[0])
    h = 0.02
    with torch.no_grad():
        f = [float(loss(torch.tensor(1.0 + k * h, dtype=F64)))
             for k in (-2, -1, 1, 2)]
    fd = (f[0] - 8 * f[1] + 8 * f[2] - f[3]) / (12 * h)
    assert np.isfinite(g) and abs(fd) > 0
    np.testing.assert_allclose(g, fd, rtol=2e-3)
