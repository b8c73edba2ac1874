"""The port's refractive plates and compound refractive lenses against the
JAX package.

* ``Plate.double_refract`` (parallel faces and a wedge, absorption along
  the path inside) and ``multiple_refract`` of all four lens classes
  (``ParaboloidFlatLens``, ``ParabolicCylinderFlatLens``,
  ``DoubleParaboloidLens``, ``DoubleParabolicCylinderLens``) on the same
  rays to 1e-9, float64 (the JAX package under ``jit``).
* ``nCRL=(f, E)`` gives the JAX package's lens count for every class.
* ``tests/test_refractive.py``'s checks: a plate's transmission equals
  T_fresnel^2 e^(-mu t) to 1e-3, a CRL stack focuses a 0.6 mm beam below
  20 um at f = 2 focus / (nCRL delta).
* Float32 against float64 (ROADMAP C18), example 14's stack (16 Be
  lenses, f = 3 m at 9 keV): the port's focal distance and transmission
  within the JAX package's own float32 error (a subprocess with x64 off)
  plus 1e-3, its focal sizes within 1% of the JAX package's error.
* ``run_ray_tracing`` of example 14's CRL in both packages: the same
  histograms to 1e-9 of their totals.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
import xrt_tpu.oes as jo
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu_torch import materials as tm, oes as to
from xrt_tpu_torch.screens import Screen
from test_torch_dcm import compare, jax_beam, port_beam, rays_np
from test_torch_materials import trace_both

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
E0, P = 9000.0, 10000.0
LENSES = ('ParaboloidFlatLens', 'ParabolicCylinderFlatLens',
          'DoubleParaboloidLens', 'DoubleParabolicCylinderLens')
#: examples/14_lenses_crl.py
CRL = dict(focus=0.1, zmax=1.0, center=(0, P, 0), t=0.05,
           limPhysX=(-2, 2), limPhysY=(-2, 2))
F_TARGET = 3000.0


def parallel_rays(n=400, seed=3, half=0.25, E=E0):
    """A flat parallel beam 2 half wide along +y, horizontally polarized."""
    d = rays_np(n, seed=seed, dE=0.0, div=0.0)
    rng = np.random.RandomState(seed + 1)
    d.update(x=rng.uniform(-half, half, n), z=rng.uniform(-half, half, n),
             a=np.zeros(n), b=np.ones(n), c=np.zeros(n), E=np.full(n, E))
    return d


def mats(kind):
    return (jm.Material.create('Be', rho=1.848, kind=kind),
            tm.Material.create('Be', rho=1.848, kind=kind, **KW))


@pytest.mark.parametrize('wedge,pitch', [(0.0, math.pi / 2),
                                         (0.01, math.pi / 2 - 0.2)])
def test_plate_double_refract_matches_jax(wedge, pitch):
    jmat = jm.Material.create('C', rho=3.52, kind='plate')
    tmat = tm.Material.create('C', rho=3.52, kind='plate', **KW)
    kw = dict(center=(0, P, 0), pitch=pitch, t=0.5, wedgeAngle=wedge,
              limPhysX=(-10, 10), limPhysY=(-10, 10))
    d = rays_np(500, seed=4, dE=3.0, div=1e-5, size=(0.2, 0.2))
    jr = jax.jit(lambda b: jo.Plate.create(material=jmat, **kw)
                 .double_refract(b))(jax_beam(d))
    tr = to.Plate.create(material=tmat, **kw).double_refract(port_beam(d))
    for t, j in zip(tr, jr):
        compare(t, j)
    assert float((tr[0].state == 1).double().mean()) > 0.99


def test_plate_transmission_and_absorption():
    """tests/test_refractive.py: at normal incidence through parallel
    faces the direction is kept and the flux is T_fresnel^2 e^(-mu t)."""
    tmat = tm.Material.create('C', rho=3.52, kind='plate', **KW)
    t = 0.5
    plate = to.Plate.create(center=(0, P, 0), pitch=math.pi / 2, t=t,
                            material=tmat, limPhysX=(-10, 10),
                            limPhysY=(-10, 10))
    beam = port_beam(parallel_rays(2000, half=0.2))
    glo, _, _ = plate.double_refract(beam)
    good = glo.state.numpy() == 1
    assert good.mean() > 0.99
    np.testing.assert_allclose(glo.c.numpy()[good], beam.c.numpy()[good],
                               atol=1e-12)
    E = torch.tensor([E0], dtype=F64)
    mu = float(tmat.get_absorption_coefficient(E)[0])
    T2 = float(tmat.get_amplitude(E, torch.tensor([-1.0], dtype=F64))[0]
               .abs()[0]) ** 4
    flux = float((glo.Jss + glo.Jpp).numpy()[good].mean())
    np.testing.assert_allclose(flux, T2 * math.exp(-mu * t * 0.1),
                               rtol=1e-3)


@pytest.mark.parametrize('cls', LENSES)
def test_lens_count_matches_jax(cls):
    jmat, tmat = mats('lens')
    for f, E in ((F_TARGET, E0), (5000.0, 12000.0), (800.0, 8000.0)):
        j = getattr(jo, cls).create(nCRL=(f, E), material=jmat, **CRL)
        t = getattr(to, cls).create(nCRL=(f, E), material=tmat, **CRL)
        assert t.nCRL == j.nCRL > 1


@pytest.mark.parametrize('cls', LENSES)
def test_multiple_refract_matches_jax(cls):
    jmat, tmat = mats('lens')
    kw = dict(CRL, focus=0.2, nCRL=3, roll=0.3)
    j = getattr(jo, cls).create(material=jmat, **kw)
    t = getattr(to, cls).create(material=tmat, **kw)
    d = parallel_rays(300, seed=5, half=0.6)
    d['c'] = np.random.RandomState(6).normal(0, 1e-5, 300)
    d['b'] = np.sqrt(1 - d['c'] ** 2)
    jr = jax.jit(lambda b: j.multiple_refract(b))(jax_beam(d))
    tr = t.multiple_refract(port_beam(d))
    for a, b in zip(tr, jr):
        compare(a, b)


def focal_numbers(glo, dist):
    """(focal distance from the rays' crossings of the axis, std x, std z
    at *dist* past the lens, transmission) of a beam after the stack,
    float64 numpy; *glo* maps field names to arrays."""
    good = glo['state'] == 1
    x, z, a, b, c = (np.asarray(glo[k], float)[good] for k in 'xzabc')
    w = (np.asarray(glo['Jss'], float) + np.asarray(glo['Jpp'], float))[good]
    y = np.asarray(glo['y'], float)[good]
    far = np.abs(x) > 0.1
    f = np.median((y - x * b / a)[far]) - P
    s = (P + dist - y) / b
    return (f, np.std(x + a * s), np.std(z + c * s),
            w.sum() / good.size)


JAX_F32 = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
import xrt_tpu.materials as jm
import xrt_tpu.oes as jo
from xrt_tpu.beam import Beam
a = dict(np.load(IN))
mat = jm.Material.create('Be', rho=1.848, kind='lens')
lens = jo.ParaboloidFlatLens.create(material=mat, nCRL=NLENS, **LENSKW)
b = Beam(**{k: jnp.asarray(v) for k, v in a.items()})
glo = jax.jit(lambda b: lens.multiple_refract(b)[0])(b)
np.savez(OUT, **{k: np.asarray(getattr(glo, k)) for k in
                 ('x', 'y', 'z', 'a', 'b', 'c', 'Jss', 'Jpp', 'state')})
print('OK')
'''


def test_crl_float32_against_float64(clean_env_runner, tmp_path):
    """Example 14's stack: the float32 focal distance and transmission
    against float64 on the same float32 rays, the port within the JAX
    package's own float32 error plus 1e-3 (relative).  Measured: the focal
    distance 1.94e-2 in both packages (delta = 4.2e-6 of Be at 9 keV
    carries ~1.4% in one float32 ulp of n), transmission 6.7e-6.  The
    focal sizes (0.50 um in float64) are below the float32 resolution of
    positions at 13 m (one ulp is 1 um): both packages' float32 spots are
    ~4.7 times as large; the port's size error is held within 1% of the
    JAX package's."""
    jmat, tmat = mats('lens')
    nCRL = to.ParaboloidFlatLens.create(nCRL=(F_TARGET, E0), material=tmat,
                                        **CRL).nCRL
    d = parallel_rays(2000, seed=8, half=0.25)
    d32 = {k: (v.astype(np.float32) if v.dtype == np.float64 else
               v.astype(np.complex64) if v.dtype == complex else v)
           for k, v in d.items()}
    np.savez(tmp_path / 'in.npz', **d32)
    code = JAX_F32.replace('IN', repr(str(tmp_path / 'in.npz'))).replace(
        'OUT', repr(str(tmp_path / 'out.npz'))).replace(
        'NLENS', repr(nCRL)).replace('LENSKW', repr(CRL))
    out, _ = clean_env_runner(code, timeout=300, f32=True)
    assert 'OK' in out
    jax32 = dict(np.load(tmp_path / 'out.npz'))
    d64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else
               v.astype(complex) if v.dtype == np.complex64 else v)
           for k, v in d32.items()}
    res = {}
    for dt in (torch.float32, F64):
        lens = to.ParaboloidFlatLens.create(
            nCRL=nCRL, material=tm.Material.create(
                'Be', rho=1.848, kind='lens', dtype=dt, device='cpu'), **CRL)
        glo = lens.multiple_refract(port_beam(d64, dt))[0]
        res[dt] = {k: getattr(glo, k).numpy() for k in
                   ('x', 'y', 'z', 'a', 'b', 'c', 'Jss', 'Jpp', 'state')}
    delta = 1 - float(tmat.get_refractive_index(E0).real)
    f_thin = 2 * 0.1 / (nCRL * delta)
    n64 = focal_numbers(res[F64], f_thin)
    n32 = focal_numbers(res[torch.float32], f_thin)
    nj = focal_numbers(jax32, f_thin)
    port = (abs(n32[0] / n64[0] - 1), abs(n32[1] - n64[1]) / n64[1],
            abs(n32[2] - n64[2]) / n64[2], abs(n32[3] / n64[3] - 1))
    ref = (abs(nj[0] / n64[0] - 1), abs(nj[1] - n64[1]) / n64[1],
           abs(nj[2] - n64[2]) / n64[2], abs(nj[3] / n64[3] - 1))
    print(f'CRL of {nCRL} lenses, float64: focus at {n64[0]:.3f} mm (thin '
          f'lens {f_thin:.3f}), sizes {n64[1] * 1e3:.3f} x '
          f'{n64[2] * 1e3:.3f} um, transmission {n64[3]:.5f}; float32 '
          f'against float64: focal distance {port[0]:.2e} (JAX package '
          f'{ref[0]:.2e}), sizes {port[1]:.2e} / {port[2]:.2e} '
          f'({ref[1]:.2e} / {ref[2]:.2e}), transmission {port[3]:.2e} '
          f'({ref[3]:.2e})')
    assert abs(n64[0] / f_thin - 1) < 0.05
    for i in (0, 3):
        assert port[i] <= ref[i] + 1e-3
    for i in (1, 2):
        assert port[i] <= 1.01 * ref[i]


def crl_lines(nCRL=None):
    jmat, tmat = mats('lens')
    n = (F_TARGET, E0) if nCRL is None else nCRL
    return (jo.ParaboloidFlatLens.create(nCRL=n, material=jmat, **CRL),
            to.ParaboloidFlatLens.create(nCRL=n, material=tmat, **CRL))


def test_crl_focuses():
    """tests/test_refractive.py: the stack focuses a 0.6 mm parallel beam
    below 20 um at the thin-lens distance."""
    _, t = crl_lines()
    delta = 1 - float(t.material.get_refractive_index(E0).real)
    f_real = 2 * 0.1 / (t.nCRL * delta)
    glo = t.multiple_refract(port_beam(parallel_rays(1000, half=0.3)))[0]
    img = Screen.create(center=(0, P + f_real, 0)).expose(glo)
    good = img.state.numpy() == 1
    assert good.mean() > 0.95
    assert img.x.numpy()[good].std() < 0.02
    assert img.z.numpy()[good].std() < 0.02


def test_crl_trace_matches_jax():
    """Example 14 through run_ray_tracing in both packages (5 lenses of
    its stack, its beam and screen)."""
    jl, tl = crl_lines(nCRL=5)
    delta = 1 - float(tl.material.get_refractive_index(E0).real)
    f_real = 2 * 0.1 / (5 * delta)
    scr = dict(center=(0, P + f_real, 0))
    jscr, tscr = JScreen.create(**scr), Screen.create(**scr)
    d = parallel_rays(300, seed=11, half=0.25)

    def jproc(bl, key):
        return {'screen': jscr.expose(jl.multiple_refract(jax_beam(d))[0])}

    def tproc(bl, rng):
        return {'screen': tscr.expose(tl.multiple_refract(port_beam(d))[0])}
    trace_both(jproc, tproc, (
        dict(label='x', unit='um', bins=16, limits=[-30, 30]),
        dict(label='z', unit='um', bins=16, limits=[-30, 30]),
        dict(label='energy', unit='eV', bins=8, limits=[E0 - 1, E0 + 1])))
