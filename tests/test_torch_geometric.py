"""The port's geometric source, screens, apertures and stock mirrors.

``jax.random`` streams cannot be reproduced by a ``torch.Generator``, so
the source is held against the analytic moments of its laws: a mean within
5 sigma / sqrt(N) (N = 40000), a standard deviation within 3% (5 sigma of
its own sampling error at this N is 1.8%), ranges exactly.  The elements
downstream are deterministic and are compared with the JAX package on the
same numpy beam in float64, to 1e-12 relative to each field's largest
value.  The analytic checks of the JAX package's end-to-end trace tests
(flat-mirror deflection and |r_s|^2, spherical and toroidal focusing,
aperture blocking) are re-stated for the port.
"""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xrt_tpu import apertures as jap, beam as jbeam, screens as jsc
from xrt_tpu.oes import (BentFlatMirror as JBent, ConicalMirror as JCon,
                         CylindricalMirror as JCyl, SphericalMirror as JSph)
from xrt_tpu_torch import apertures as tap, interop, screens as tsc
from xrt_tpu_torch.materials import Material
from xrt_tpu_torch.oes import (BentFlatMirror, ConicalMirror,
                               CylindricalMirror, FlatMirror,
                               SphericalMirror, ToroidMirror)
from xrt_tpu_torch.sources import GeometricSource

F64 = torch.float64
N = 40000
E0, PITCH, P, Q = 9000.0, 4e-3, 10000.0, 2000.0


def T(v):
    return torch.from_numpy(np.ascontiguousarray(v))


def source(**kw):
    base = dict(nrays=N, dtype=F64, device='cpu', distE='lines',
                energies=(E0,))
    base.update(kw)
    return GeometricSource.create(**base)


def shine(src, seed=0, **kw):
    return src.shine(torch.Generator().manual_seed(seed), **kw)


def mean_is(v, mu, sigma):
    assert abs(float(v.mean()) - mu) < 5 * sigma / math.sqrt(v.numel())


def std_is(v, sigma):
    assert abs(float(v.std()) / sigma - 1) < 0.03


# ---- the source's laws ------------------------------------------------

def test_normal_law():
    b = shine(source(dx=0.32, dz=0.018, dxprime=1e-3, dzprime=1e-4))
    for v, s in ((b.x, 0.32), (b.z, 0.018), (b.a, 1e-3), (b.c, 1e-4)):
        mean_is(v, 0.0, s)
        std_is(v, s)
    assert float(b.y.abs().max()) == 0 and b.Es is None
    assert b.state.dtype == torch.int32 and bool((b.state == 1).all())
    assert float(b.path.abs().max()) == 0 and bool((b.E == E0).all())


def test_flat_law_width_and_range():
    b = shine(source(distx='flat', dx=2.0, distz='flat', dz=(-1.0, 3.0),
                     disty='flat', dy=0.5, distxprime='flat', dxprime=1e-3,
                     distzprime=None))
    mean_is(b.x, 0.0, 2.0 / math.sqrt(12))
    std_is(b.x, 2.0 / math.sqrt(12))
    assert -1.0 <= float(b.x.min()) and float(b.x.max()) < 1.0
    mean_is(b.z, 1.0, 4.0 / math.sqrt(12))
    assert -1.0 <= float(b.z.min()) and float(b.z.max()) < 3.0
    std_is(b.y, 0.5 / math.sqrt(12))
    assert float(b.c.abs().max()) == 0


def test_annulus_law_is_uniform_in_area():
    b = shine(source(distx='annulus', dx=(1.0, 2.0), distz='annulus',
                     dz=(0.0, math.pi), distxprime=None, distzprime=None))
    r = torch.sqrt(b.x ** 2 + b.z ** 2)
    assert 1.0 - 1e-12 <= float(r.min()) and float(r.max()) <= 2.0 + 1e-12
    # uniform in area: r^2 is flat on [1, 4]
    mean_is(r ** 2, 2.5, 3.0 / math.sqrt(12))
    std_is(r ** 2, 3.0 / math.sqrt(12))
    assert float(b.z.min()) >= -1e-12       # phi in [0, pi]: upper half
    b = shine(source(distx='annulus', dx=(0.0, 1.0), distz='annulus',
                     distxprime=None, distzprime=None))
    mean_is(b.z, 0.0, 0.5)                  # the full circle
    assert float(b.z.min()) < -0.9


def test_energy_laws():
    b = shine(source(distE='normal', energies=(E0, 2.0)))
    mean_is(b.E, E0, 2.0)
    std_is(b.E, 2.0)
    b = shine(source(distE='flat', energies=(8900.0, 9100.0)))
    mean_is(b.E, E0, 200 / math.sqrt(12))
    assert 8900 <= float(b.E.min()) and float(b.E.max()) < 9100
    b = shine(source(distE='lines', energies=(8000.0, 9000.0),
                     energyWeights=(1.0, 3.0)))
    assert set(b.E.tolist()) == {8000.0, 9000.0}
    assert abs(float((b.E == 9000.0).double().mean()) - 0.75) < 0.011
    b = shine(source(distE=None))
    assert bool((b.E == 9000.0).all())


def test_uniform_ray_density_amplitudes():
    sig, cut = 0.1, 0.35
    b = shine(source(uniformRayDensity=True, dx=(sig, cut), distz=None,
                     distxprime=None, distzprime=None))
    assert float(b.x.abs().max()) <= cut
    std_is(b.x, 2 * cut / math.sqrt(12))    # the rays are uniform
    amp = np.exp(-b.x.numpy() ** 2 / sig ** 2 / 2) / \
        math.sqrt(2 * math.pi) / sig * 2 * cut
    np.testing.assert_allclose(b.Jss.numpy(), amp, rtol=1e-13)
    np.testing.assert_allclose(b.Es.real.numpy(), np.sqrt(amp), rtol=1e-13)
    # the weights carry the Gaussian: their mean is its integral over the
    # cut, and the weighted size is sigma (cut at 3.5 sigma)
    assert abs(float(b.Jss.mean()) - math.erf(cut / sig / math.sqrt(2))) < \
        5 * float(b.Jss.std()) / math.sqrt(N)
    ws = math.sqrt(float((b.Jss * b.x ** 2).sum() / b.Jss.sum()))
    assert abs(ws / sig - 1) < 0.03


def test_direction_is_normalized():
    b = shine(source(dxprime=0.2, dzprime=0.3))
    np.testing.assert_allclose(
        (b.a ** 2 + b.b ** 2 + b.c ** 2).numpy(), 1.0, rtol=1e-14)
    b = shine(source(distxprime='flat', dxprime=(1.5, 2.0),
                     distzprime='flat', dzprime=(1.0, 2.0)))   # a^2+c^2 > 1
    np.testing.assert_allclose(
        (b.a ** 2 + b.b ** 2 + b.c ** 2).numpy(), 1.0, rtol=1e-14)
    assert float(b.b.min()) > 0


@pytest.mark.parametrize('pol,J', [
    ('horizontal', (1.0, 0.0, 0j)), ('vertical', (0.0, 1.0, 0j)),
    ('right', (0.5, 0.5, 0.5j)), ('left', (0.5, 0.5, -0.5j)),
    ('unpolarized', (0.5, 0.5, 0j)), (45.0, (0.5, 0.5, 0.5 + 0j)),
    ((0.7, 0.3, 0.1, -0.2), (0.7, 0.3, 0.1 - 0.2j))])
def test_polarization(pol, J):
    b = shine(source(polarization=pol, nrays=64), withAmplitudes=True)
    for got, want in zip((b.Jss, b.Jpp, b.Jsp), J):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-15)
    assert b.Es.dtype == torch.complex128
    if isinstance(pol, str) and pol[0] in 'hvrl':
        np.testing.assert_allclose((b.Es * b.Ep.conj()).numpy(), J[2],
                                   atol=1e-15)
    if pol == 'unpolarized':     # a random Ep amplitude below 1/sqrt(2)
        assert 0 <= float(b.Ep.real.min()) < float(b.Ep.real.max()) < \
            2 ** -0.5


def test_rotation_center_and_local_frame():
    kw = dict(dx=0.1, dz=0.05, dxprime=1e-4, dzprime=1e-4)
    loc = shine(source(**kw), toGlobal=False)
    glo = shine(source(center=(1.0, 2.0, 3.0), **kw))
    for f, c in zip('xyz', (1.0, 2.0, 3.0)):    # the same draws, shifted
        np.testing.assert_allclose(getattr(glo, f).numpy(),
                                   getattr(loc, f).numpy() + c, atol=1e-15)
    yaw = 0.3
    rot = shine(source(yaw=yaw, pitch=0.1, **kw), toGlobal=False)
    # yaw turns +y towards -x first, then pitch lifts it towards +z
    assert abs(float(rot.a.mean()) + math.sin(yaw)) < 1e-4
    assert abs(float(rot.c.mean()) -
               math.sin(0.1) * math.cos(yaw)) < 1e-4
    np.testing.assert_allclose(
        (rot.a ** 2 + rot.b ** 2 + rot.c ** 2).numpy(), 1.0, rtol=1e-14)
    np.testing.assert_allclose(
        (rot.x ** 2 + rot.y ** 2 + rot.z ** 2).numpy(),
        (loc.x ** 2 + loc.y ** 2 + loc.z ** 2).numpy(), rtol=1e-12)


def test_one_seed_one_beam_in_either_dtype():
    """A CPU generator draws float64 on the host: float32 and float64
    beams from one seed are the same samples; an int seed makes the
    generator on the source's device."""
    kw = dict(dx=0.1, dz=0.05, dxprime=3e-5, dzprime=3e-5, distE='flat',
              energies=(8900.0, 9100.0), nrays=1000)
    b64 = shine(source(**kw), seed=4)
    b32 = shine(source(**dict(kw, dtype=torch.float32)), seed=4)
    assert b32.x.dtype == torch.float32 and b32.Jsp.dtype == torch.complex64
    for f in ('x', 'z', 'a', 'c', 'E'):     # scaled in either dtype
        np.testing.assert_allclose(getattr(b32, f).numpy(),
                                   getattr(b64, f).numpy(), rtol=2e-7)
    assert torch.equal(source(**kw).shine(4).x, b64.x)
    assert not torch.equal(shine(source(**kw), seed=5).x, b64.x)


# ---- screens, apertures and mirrors against the JAX package ------------

def _beam_np(seed, n=300):
    rng = np.random.RandomState(seed)
    a, c = rng.normal(0, 2e-3, (2, n))
    b = np.sqrt(1 - a ** 2 - c ** 2)
    Es = rng.uniform(0.5, 1, n) * np.exp(1j * rng.uniform(0, 6.28, n))
    Ep = 0.3 * Es * np.exp(0.7j)
    state = np.ones(n, np.int32)
    state[::7] = -1
    state[1::11] = 2
    return dict(x=rng.normal(0, 0.3, n), y=rng.uniform(-5, 5, n),
                z=rng.normal(0, 0.2, n), a=a, b=b, c=c,
                E=rng.uniform(8900, 9100, n), state=state,
                path=rng.uniform(0, 10, n), Jss=np.abs(Es) ** 2,
                Jpp=np.abs(Ep) ** 2, Jsp=Es * np.conj(Ep), Es=Es, Ep=Ep)


FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'path', 'Jss', 'Jpp', 'Jsp', 'Es',
          'Ep')


def beams_match(t, j, tol=1e-12):
    np.testing.assert_array_equal(t.state.numpy(), np.asarray(j.state))
    for f in FIELDS:
        g, r = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert np.abs(g - r).max() <= tol * max(np.abs(r).max(), 1e-300), f


def both_beams(seed):
    d = _beam_np(seed)
    return interop.beam_from_numpy(d, device='cpu', dtype=F64), \
        jbeam.Beam(**{k: jnp.asarray(v) for k, v in d.items()})


SCREEN = dict(center=(0.1, 2000.0, -0.2), x=(1, 0.01, 0),
              z=(0, -0.02, 1))


@pytest.mark.parametrize('method,positive', [
    ('expose', False), ('expose', True), ('expose_global', False),
    ('expose_global', True)])
def test_screen_matches_jax(method, positive):
    kw = dict(SCREEN, center=(0.1, 2.0, -0.2))  # some rays start behind it
    tb, jb = both_beams(0)
    ts, js = tsc.Screen.create(**kw), jsc.Screen.create(**kw)
    t = getattr(ts, method)(tb, onlyPositivePath=positive)
    j = getattr(js, method)(jb, onlyPositivePath=positive)
    # the propagation phase is 1e7 * k * path ~ 1e11 rad at float64
    beams_match(t, j, tol=1e-12 if method == 'expose' else 1e-11)
    assert positive == bool((t.state.numpy() == -1).sum() >
                            (tb.state.numpy() == -1).sum())
    np.testing.assert_allclose(ts.ey, np.asarray(js.ey), atol=1e-15)
    p = ts.local_to_global(T(np.ones(3)), T(np.zeros(3)), T(np.ones(3)))
    q = js.local_to_global(jnp.ones(3), jnp.zeros(3), jnp.ones(3))
    for g, r in zip(p, q):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-14)


def test_screen_compression_matches_jax():
    tb, jb = both_beams(1)
    kw = dict(SCREEN, compressX=0.5, compressZ=3.0)
    beams_match(tsc.Screen.create(**kw).expose(tb),
                jsc.Screen.create(**kw).expose(jb))


@pytest.mark.parametrize('positive', [False, True])
def test_hemispheric_screen_matches_jax(positive):
    tb, jb = both_beams(2)
    kw = dict(center=(0, 1.0, 0), R=500.0)
    t = tsc.HemisphericScreen.create(**kw).expose(
        tb, onlyPositivePath=positive)
    j = jsc.HemisphericScreen.create(**kw).expose(
        jb, onlyPositivePath=positive)
    beams_match(t, j, tol=1e-11)
    # the image is in angles: x = phi R, z = theta R
    good = t.state.numpy() > 0
    np.testing.assert_allclose(
        (t.z / 500.0).numpy()[good],
        np.arcsin(np.asarray(jb.c))[good], atol=2e-2)


APERTURES = [
    ('rect', dict(opening=(-0.2, 0.3, -0.1, 0.15))),
    ('rect', dict(kind=('left', 'top'), opening=(-0.2, 0.1))),
    ('rect', dict(opening=(-0.2, 0.3, -0.1, 0.15), isBeamStop=True)),
    ('rect', dict(opening=(-0.2, 0.3, -0.1, 0.15), softEdge=0.02)),
    ('rect', dict(kind=('right',), opening=(0.1,), softEdge=0.05,
                  isBeamStop=True)),
    ('round', dict(r=0.3)),
    ('round', dict(r=0.3, isBeamStop=True)),
    ('round', dict(r=0.3, softEdge=0.03)),
]


@pytest.mark.parametrize('shape,kw', APERTURES)
def test_aperture_propagate_matches_jax(shape, kw):
    tb, jb = both_beams(3)
    name = 'RectangularAperture' if shape == 'rect' else 'RoundAperture'
    kw = dict(kw, center=(0.05, 300.0, -0.02), x=(1, 0, 0.01))
    ta = getattr(tap, name).create(**kw)
    ja = getattr(jap, name).create(**kw)
    tg, tl = ta.propagate(tb, needNewGlobal=True)
    jg, jl = ja.propagate(jb, needNewGlobal=True)
    beams_match(tl, jl, tol=1e-11)
    beams_match(tg, jg, tol=1e-11)
    beams_match(ta.propagate(tb), jl, tol=1e-11)
    if 'softEdge' not in kw:        # hard edges kill, soft ones attenuate
        assert (tl.state.numpy() == -1).sum() > (tb.state.numpy() ==
                                                 -1).sum()
    else:
        np.testing.assert_array_equal(tl.state.numpy(), tb.state.numpy())
        assert float((tl.Jss / tb.Jss).min()) < 0.5


MIRRORS = [
    (BentFlatMirror, JBent, dict(R=2.0e5, limPhysY=(-300, 300))),
    (BentFlatMirror, JBent, dict(R=(P, Q), pitch=PITCH,
                                 limPhysY=(-300, 300))),
    (SphericalMirror, JSph, dict(R=(P, Q, PITCH))),
    (CylindricalMirror, JCyl, dict(r=(P, Q), pitch=PITCH)),
    (CylindricalMirror, JCyl, dict(r=35.0)),
    (ConicalMirror, JCon, dict(L0=800.0, theta=0.3)),
    (ConicalMirror, JCon, dict(L0=500.0, theta=math.pi / 6)),
]


@pytest.mark.parametrize('tcls,jcls,kw', MIRRORS)
def test_mirror_surfaces_match_jax(tcls, jcls, kw):
    rng = np.random.RandomState(5)
    x = np.concatenate([rng.uniform(-20, 20, 200), [40.0, -36.0]])
    y = np.concatenate([rng.uniform(-300, 300, 200), [0.0, 10.0]])
    tm, jm_ = tcls.create(**kw), jcls.create(**kw)
    tz, jz = tm.local_z(T(x), T(y)), jm_.local_z(jnp.asarray(x),
                                                 jnp.asarray(y))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jz)).max())
    for g, r in zip(tm.local_n(T(x), T(y)),
                    jm_.local_n(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11,
                                   atol=1e-15)


# ---- the analytic checks of the end-to-end trace tests -----------------

def trace_source(nrays=20000, **kw):
    base = dict(nrays=nrays, dx=0.1, dz=0.05, dxprime=2e-5, dzprime=1e-5,
                polarization='horizontal')
    base.update(kw)
    return source(**base)


def test_source_to_screen_statistics():
    img = tsc.Screen.create(center=(0, P, 0)).expose(
        shine(trace_source(), 3))
    sx, sz = math.hypot(0.1, 2e-5 * P), math.hypot(0.05, 1e-5 * P)
    std_is(img.x, sx)
    std_is(img.z, sz)
    mean_is(img.x, 0.0, sx)
    np.testing.assert_allclose(img.path.numpy(), P, rtol=1e-6)


def test_flat_mirror_deflection_and_reflectivity():
    mat = Material.create('Si', rho=2.33, kind='mirror', dtype=F64,
                          device='cpu')
    mirror = FlatMirror.create(center=(0, P, 0), pitch=PITCH, material=mat,
                               limPhysX=(-10, 10), limPhysY=(-150, 150))
    screen = tsc.Screen.create(center=(0, P + Q, 2 * PITCH * Q))
    glo, loc = mirror.reflect(shine(trace_source(), 5))
    img = screen.expose(glo)
    good = glo.state == 1
    assert float(good.double().mean()) > 0.95
    # the reflected beam rises at 2 * pitch and lands on the screen centre
    np.testing.assert_allclose(float((glo.c / glo.b)[good].mean()),
                               math.tan(2 * PITCH), rtol=2e-2)
    assert abs(float(img.z[good].mean())) < 0.05
    # a horizontally polarized beam on a vertically deflecting mirror is
    # s-polarized: the flux falls by |r_s|^2
    rs = mat.get_amplitude(torch.tensor([E0], dtype=F64),
                           torch.tensor([-math.sin(PITCH)], dtype=F64))[0]
    flux = float((glo.Jss + glo.Jpp)[good].sum() / good.sum())
    np.testing.assert_allclose(flux, float(rs.abs() ** 2), rtol=1e-3)
    np.testing.assert_allclose(float(loc.theta[good].mean()), PITCH,
                               rtol=1e-2)


def test_spherical_mirror_focusing():
    """1:1 vertical focusing with the Coddington meridional radius."""
    src = trace_source(dx=0.0, dz=0.0, distx=None, distz=None, dxprime=0.0,
                       dzprime=5e-5, distxprime=None)
    mirror = SphericalMirror.create(center=(0, P, 0), pitch=PITCH,
                                    R=(P, P), limPhysX=(-20, 20),
                                    limPhysY=(-300, 300))
    img = tsc.Screen.create(center=(0, 2 * P, 2 * PITCH * P)).expose(
        mirror.reflect(shine(src, 7))[0])
    good = img.state == 1
    assert float(good.double().mean()) > 0.9
    # unfocused the image would be 2 P dzprime = 1 mm high
    assert float(img.z[good].std()) < 0.02
    assert abs(float(img.z[good].mean())) < 0.02


def test_toroid_focusing_both_planes():
    src = trace_source(dx=0.0, dz=0.0, distx=None, distz=None,
                       dxprime=3e-5, dzprime=3e-5)
    mirror = ToroidMirror.create(center=(0, P, 0), pitch=PITCH, R=(P, Q),
                                 r=(P, Q), limPhysX=(-20, 20),
                                 limPhysY=(-300, 300))
    img = tsc.Screen.create(center=(0, P + Q, 2 * PITCH * Q)).expose(
        mirror.reflect(shine(src, 11))[0])
    good = img.state == 1
    assert float(good.double().mean()) > 0.9
    # unfocused: 3e-5 * 12000 = 0.36 mm in both planes
    assert float(img.x[good].std()) < 0.05
    assert float(img.z[good].std()) < 0.05


def test_aperture_blocks():
    slit = tap.RectangularAperture.create(
        center=(0, P / 2, 0), opening=(-0.05, 0.05, -0.02, 0.02))
    loc = slit.propagate(shine(trace_source(), 13))
    inside = (loc.x.abs() <= 0.05) & (loc.z.abs() <= 0.02)
    assert torch.equal(loc.state == 1, inside)
    assert 0.01 < float(inside.double().mean()) < 0.5


def test_hemispheric_screen_image_is_in_angles():
    src = trace_source(dx=0.0, dz=0.0, distx=None, distz=None,
                       dxprime=1e-3, dzprime=2e-3)
    beam = shine(src, 17)
    img = tsc.HemisphericScreen.create(center=(0, 0, 0), R=1000.0).expose(
        beam)
    assert bool((img.state == 1).all())
    np.testing.assert_allclose(img.path.numpy(), 1000.0, rtol=1e-12)
    np.testing.assert_allclose((img.z / 1000.0).numpy(),
                               np.arcsin(beam.c.numpy()), atol=1e-12)
    np.testing.assert_allclose(
        (img.x / 1000.0).numpy(),
        np.arctan2(beam.a.numpy(), beam.b.numpy()), atol=1e-12)
