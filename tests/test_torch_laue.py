"""The port's Laue crystals and volumetric diffraction against the JAX
package.

* ``local_z``, ``local_n`` and ``local_n_depth`` of ``LauePlate``,
  ``BentLaueCylinder`` (circular and parabolic, with an asymmetry angle),
  ``GroundBentLaueCylinder``, ``BentLaueSphere`` and ``BentLaue2D`` (its
  ``djparams`` from the elastic model, and the isotropic fallback) to
  1e-12.
* ``reflect`` on the same rays to 1e-9 (float64; the JAX package under
  ``jit``): a flat Laue plate, a bent Laue cylinder with ``useTT=True``
  (Takagi-Taupin amplitudes, the bending radius from the element), a
  ground-bent one with an asymmetric TT crystal (its radius a float on the
  JAX side, whose jit cannot take the float of a doubled array radius),
  ``BentLaue2D``
  with TT amplitudes, and ``BentLaue2D`` with
  volumetric diffraction, the depth draws injected (the JAX package's
  from its key).
* ``tests/test_bentlaue2d.py``'s and ``tests/test_tt.py``'s physical
  checks: the surface and depth normals, a TT bent Laue cylinder passing
  > 90% of the rays with a finite, nonzero reflectivity, and a volumetric
  BentLaue2D integrating more flux than a flat plate.
* ``run_ray_tracing`` of the bent-Laue monochromator of
  ``examples/13_laue_mono.py`` (useTT) in both packages: the same
  histograms to 1e-9 of their totals.
"""
import torch_harness  # noqa: F401

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
E0 = 40000.0


def si(mod, **kw):
    kw.setdefault('t', 0.2)
    return mod.CrystalSi.create(hkl=(1, 1, 1), geom='Laue reflected', **kw,
                                **(KW if mod is tm else {}))


SHAPES = {
    'plate': ('LauePlate', dict()),
    'plate_asym': ('LauePlate', dict(alpha=0.1)),
    'cylinder': ('BentLaueCylinder', dict(R=2000.0)),
    'cylinder_parab_asym': ('BentLaueCylinder',
                            dict(R=1500.0, crossSection='parabolic',
                                 alpha=-0.05)),
    'cylinder_coddington': ('BentLaueCylinder',
                            dict(R=(20000.0, 5000.0), pitch=0.05)),
    'ground': ('GroundBentLaueCylinder', dict(R=3000.0, alpha=0.03)),
    'sphere': ('BentLaueSphere', dict(R=2500.0)),
    'sphere_parab': ('BentLaueSphere',
                     dict(R=2500.0, crossSection='parabolic')),
    'bent2d': ('BentLaue2D', dict(Rm=2000.0, Rs=-10000.0)),
    'bent2d_asym': ('BentLaue2D', dict(Rm=3000.0, Rs=8000.0, alpha=0.05)),
}


def pair(name, material=True, **extra):
    cls, kw = SHAPES[name]
    kw = dict(kw, center=(0, 1000.0, 0), **extra)
    return (getattr(jo, cls).create(material=si(jm) if material else None,
                                    **kw),
            getattr(to, cls).create(material=si(tm) if material else None,
                                    **kw))


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_surfaces_and_normals_match_jax(name):
    j, t = pair(name)
    rng = np.random.RandomState(3)
    x, y = rng.uniform(-10, 10, 200), rng.uniform(-20, 20, 200)
    z = rng.uniform(-0.2, 0.0, 200)
    X, Y, Z = (torch.from_numpy(v) for v in (x, y, z))
    np.testing.assert_allclose(t.local_z(X, Y).numpy(),
                               np.asarray(j.local_z(jnp.asarray(x),
                                                    jnp.asarray(y))),
                               rtol=1e-12, atol=1e-14)
    for got, ref in zip(t.local_n(X, Y), j.local_n(jnp.asarray(x),
                                                   jnp.asarray(y))):
        np.testing.assert_allclose(np.broadcast_to(got.numpy(), x.shape),
                                   np.broadcast_to(np.asarray(ref),
                                                   x.shape),
                                   rtol=1e-12, atol=1e-14)
    deep_t = t.local_n_depth(X, Y, Z)
    deep_j = j.local_n_depth(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    assert (deep_t is None) == (deep_j is None)
    if deep_t is not None:
        for got, ref in zip(deep_t, deep_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-12, atol=1e-14)


def test_bentlaue2d_without_elastic_constants():
    """A crystal the elastic table lacks: no djparams, and the depth normal
    takes the isotropic estimate with the crystal's nu."""
    kw = dict(hkl=(1, 1, 1), d=3.0, t=0.2, geom='Laue reflected',
              elements='Ge', rho=5.3, name='Gx')
    jmat = jm.CrystalDiamond.create(nu=0.3, **kw)
    tmat = tm.CrystalDiamond.create(nu=None, **kw, **KW)
    j = jo.BentLaue2D.create(Rm=2000.0, Rs=-8000.0, material=jmat)
    t = to.BentLaue2D.create(Rm=2000.0, Rs=-8000.0, material=tmat)
    assert t.djparams is None
    assert j.djparams is not None       # nu set: the isotropic model
    t2 = to.BentLaue2D.create(Rm=2000.0, Rs=-8000.0, material=tm.
                              CrystalDiamond.create(nu=0.3, **kw, **KW))
    np.testing.assert_allclose(t2.djparams, np.asarray(j.djparams),
                               rtol=1e-12)
    x = torch.tensor([0.0, 3.0]), torch.tensor([1.0, -4.0])
    hN = t.local_n_depth(*(v.double() for v in x),
                         torch.tensor([-0.1, -0.05], dtype=F64))
    jt = jo.BentLaue2D.create(Rm=2000.0, Rs=-8000.0, material=jm.
                              CrystalDiamond.create(**kw))
    jt = jt.replace(djparams=None)
    ref = jt.local_n_depth(jnp.asarray([0.0, 3.0]), jnp.asarray([1.0, -4.0]),
                           jnp.asarray([-0.1, -0.05]))
    for g, r in zip(hN, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-14)


def laue_rays(n=400, seed=2, dE=30.0):
    d = rays_np(n, seed=seed, dE=dE, div=2e-5)
    d['E'] = d['E'] - 9000.0 + E0
    return d


def geometry(thetaB):
    return dict(center=(0, 1000.0, 0), pitch=thetaB + math.pi / 2,
                limPhysX=(-10, 10), limPhysY=(-10, 10))


REFLECT_CASES = {
    'plate': ('LauePlate', dict(), dict()),
    'cylinder_tt': ('BentLaueCylinder', dict(R=5000.0), dict(useTT=True,
                                                           t=0.1)),
    'ground_tt_asym': ('GroundBentLaueCylinder', dict(R=4000.0, alpha=0.02),
                       dict(useTT=True, t=0.1)),
    'bent2d_volumetric': ('BentLaue2D', dict(Rm=2000.0, Rs=-10000.0),
                          dict(volumetricDiffraction=True)),
    'bent2d_tt': ('BentLaue2D', dict(Rm=2000.0, Rs=-10000.0),
                  dict(useTT=True, t=0.1)),
}


@pytest.mark.parametrize('case', sorted(REFLECT_CASES))
def test_reflect_matches_jax(case):
    cls, okw, mkw = REFLECT_CASES[case]
    jmat, tmat = si(jm, **mkw), si(tm, **mkw)
    thetaB = float(jmat.get_Bragg_angle(E0))
    geo = geometry(thetaB)
    geo['pitch'] += okw.get('alpha', 0.0)    # the planes turned by alpha
    j = getattr(jo, cls).create(material=jmat, **okw, **geo)
    t = getattr(to, cls).create(material=tmat, **okw, **geo)
    d = laue_rays()
    key = jax.random.PRNGKey(1)
    draws = None
    if mkw.get('volumetricDiffraction'):
        kvd, _ = jax.random.split(key)
        draws = dict(depth=torch.from_numpy(np.asarray(jax.random.uniform(
            kvd, (d['x'].shape[0],), jnp.float64))))
    if cls == 'GroundBentLaueCylinder':
        # the JAX package takes float(2 R) of a ground-bent crystal, which
        # its jit cannot trace from an array R: give it R as a float
        j = j.replace(R=float(j.R))
    jg, jl = jax.jit(lambda b: j.reflect(b, key))(jax_beam(d))
    tg, tl = t.reflect(port_beam(d), draws=draws)
    compare(tg, jg)
    compare(tl, jl)
    good = tg.state.numpy() == 1
    assert good.mean() > 0.9
    assert float((tg.Jss + tg.Jpp)[torch.from_numpy(good)].max()) > 1e-3


def test_tt_bent_laue_cylinder_e2e():
    """tests/test_tt.py's end-to-end check on the port's own rays."""
    from xrt_tpu_torch.sources import GeometricSource
    mat = tm.CrystalSi.create(hkl=(1, 1, 1), t=0.1, geom='Laue reflected',
                              useTT=True, **KW)
    thetaB = float(mat.get_Bragg_angle(40000.0))
    oe = to.BentLaueCylinder.create(
        R=5000.0, center=(0, 1000.0, 0), pitch=thetaB + math.pi / 2,
        material=mat, limPhysX=(-10, 10), limPhysY=(-10, 10))
    src = GeometricSource.create(nrays=300, dzprime=5e-5,
                                 energies=(40000.0,), distE='lines', **KW)
    glo, _ = oe.reflect(src.shine(torch.Generator().manual_seed(0)))
    good = glo.state.numpy() == 1
    assert good.mean() > 0.9
    I = (glo.Jss + glo.Jpp).numpy()[good]
    assert np.all(np.isfinite(I)) and I.max() > 1e-3


def test_volumetric_bentlaue2d_beats_flat_plate():
    """tests/test_bentlaue2d.py: diffraction through the depth of the bent
    lattice integrates more flux than a flat Laue plate; the depth normal
    turns linearly with depth by coef2 and with y by invR1."""
    from xrt_tpu_torch.sources import GeometricSource
    cr = si(tm, volumetricDiffraction=True)
    thetaB = float(cr.get_Bragg_angle(E0))
    oe = to.BentLaue2D.create(Rm=2000.0, Rs=-10000.0, material=cr,
                              **geometry(thetaB))
    src = GeometricSource.create(nrays=2000, dzprime=1e-4, energies=(E0,),
                                 distE='lines', **KW)
    beam = src.shine(torch.Generator().manual_seed(0))
    glo, _ = oe.reflect(beam, torch.Generator().manual_seed(1))
    good = glo.state.numpy() == 1
    assert good.mean() > 0.9
    I = (glo.Jss + glo.Jpp).numpy()[good]
    assert np.all(np.isfinite(I)) and I.max() > 1e-4
    flat = to.LauePlate.create(material=si(tm), **geometry(thetaB))
    glof, _ = flat.reflect(beam)
    goodf = glof.state.numpy() == 1
    assert I.sum() > (glof.Jss + glof.Jpp).numpy()[goodf].sum()
    z = torch.tensor([0.0, -0.05, -0.1], dtype=F64)
    hN = oe.local_n_depth(torch.zeros(3, dtype=F64),
                          torch.zeros(3, dtype=F64), z)
    ang = np.arctan2(-hN[2].numpy(), hN[1].numpy())
    coef2, invR1 = oe.djparams[1], oe.djparams[2]
    assert np.isclose(ang[1], -0.05 * coef2 * 1e3, rtol=1e-4, atol=1e-12)
    assert np.isclose(ang[2], 2 * ang[1], rtol=1e-4)
    hN2 = oe.local_n_depth(torch.zeros(1, dtype=F64),
                           torch.tensor([10.0], dtype=F64),
                           torch.zeros(1, dtype=F64))
    ang2 = float(np.arctan2(-hN2[2].numpy(), hN2[1].numpy())[0])
    assert np.isclose(ang2, -10.0 * invR1 * 1e3, rtol=1e-4)


def test_laue_mono_trace_matches_jax():
    """``examples/13_laue_mono.py``'s monochromator (Si(111), 0.7 mm, R = 2
    m, Takagi-Taupin), 60 keV +- 600 eV, through run_ray_tracing."""
    e0 = 60000.0
    kw = dict(hkl=(1, 1, 1), t=0.7, geom='Laue reflected', useTT=True)
    jmat = jm.CrystalSi.create(**kw)
    tmat = tm.CrystalSi.create(**kw, **KW)
    thetaB = float(jmat.get_Bragg_angle(e0))
    okw = dict(R=2000.0, center=(0, 10000.0, 0),
               pitch=math.pi / 2 + thetaB, limPhysX=(-20, 20),
               limPhysY=(-20, 20))
    jmono = jo.BentLaueCylinder.create(material=jmat, **okw)
    tmono = to.BentLaueCylinder.create(material=tmat, **okw)
    scr = dict(center=(0, 10000.0 + 2000.0 * math.cos(2 * thetaB),
                       -2000.0 * math.sin(2 * thetaB)))
    jscr, tscr = JScreen.create(**scr), Screen.create(**scr)
    d = rays_np(300, seed=9, dE=0.0, div=0.0)
    rng = np.random.RandomState(10)
    c = rng.uniform(-3e-4, 3e-4, 300)
    d.update(E=rng.uniform(e0 - 600, e0 + 600, 300), c=c,
             b=np.sqrt(1 - d['a'] ** 2 - c ** 2))

    def jproc(bl, key):
        return {'screen': jscr.expose(jmono.reflect(jax_beam(d))[0])}

    def tproc(bl, rng_):
        return {'screen': tscr.expose(tmono.reflect(port_beam(d))[0])}
    jp, tp = trace_both(jproc, tproc, (
        dict(label='x', unit='mm', bins=16, limits=[-0.5, 0.5]),
        dict(label='z', unit='mm', bins=24, limits=[-4.0, 4.0]),
        dict(label='energy', unit='eV', bins=16,
             limits=[e0 - 650, e0 + 650])))
    assert tp.intensity > 1e-3 * tp.nRaysAll


JAX_F32 = r'''
import math
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
import xrt_tpu.materials as jm
import xrt_tpu.oes as jo
from xrt_tpu.beam import Beam
a = dict(np.load(IN))
mat = jm.CrystalSi.create(hkl=(1, 1, 1), t=0.7, geom='Laue reflected',
                          useTT=True)
thetaB = float(mat.get_Bragg_angle(60000.0))
mono = jo.BentLaueCylinder.create(material=mat, pitch=math.pi / 2 + thetaB,
                                  **OKW)
glo = jax.jit(lambda b: mono.reflect(b)[0])(
    Beam(**{k: jnp.asarray(v) for k, v in a.items()}))
np.savez(OUT, I=np.asarray(glo.Jss + glo.Jpp), state=np.asarray(glo.state),
         E=np.asarray(glo.E))
print('OK')
'''


def laue_mono_rays(n, seed, e0=60000.0):
    d = rays_np(n, seed=seed, dE=0.0, div=0.0)
    rng = np.random.RandomState(seed + 1)
    c = rng.uniform(-3e-4, 3e-4, n)
    d.update(E=rng.uniform(e0 - 600, e0 + 600, n), c=c,
             b=np.sqrt(1 - d['a'] ** 2 - c ** 2))
    return d


def test_laue_mono_float32_flux(clean_env_runner, tmp_path):
    """The Laue monochromator's flux per ray and weighted mean energy,
    float32 against float64 on the same float32 rays: the port within the
    JAX package's own float32 error plus 1e-3 (phase 21 of chip_smoke.py
    prints that figure beside its own, tighter limit on the card).
    Measured: flux 2.7e-3 / 8.6e-2 (port / JAX package),
    mean energy 1.8 / 82 eV.  Per ray both float32 results scatter widely
    (the 0.7 mm bent crystal's fringes are finer than float32's angle
    noise), so the sums depend on the sample: on 1000 of these rays both
    are ~4% off (ROADMAP C17)."""
    okw = dict(R=2000.0, center=(0, 10000.0, 0), limPhysX=(-20, 20),
               limPhysY=(-20, 20))
    d = laue_mono_rays(3000, 21)
    d32 = {k: (v.astype(np.float32) if v.dtype == np.float64 else
               v.astype(np.complex64) if v.dtype == complex else v)
           for k, v in d.items()}
    np.savez(tmp_path / 'in.npz', **d32)
    code = JAX_F32.replace('IN', repr(str(tmp_path / 'in.npz'))).replace(
        'OUT', repr(str(tmp_path / 'out.npz'))).replace('OKW', repr(okw))
    out, _ = clean_env_runner(code, timeout=300, f32=True)
    assert 'OK' in out
    j32 = np.load(tmp_path / 'out.npz')
    d64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else
               v.astype(complex) if v.dtype == np.complex64 else v)
           for k, v in d32.items()}

    def moments(I, state, E):
        w = np.where(state == 1, I.astype(float), 0.0)
        return w.sum() / w.size, (w * E).sum() / w.sum()
    res = {}
    for dt in (torch.float32, F64):
        mat = tm.CrystalSi.create(hkl=(1, 1, 1), t=0.7, geom='Laue reflected',
                                  useTT=True, dtype=dt, device='cpu')
        thetaB = float(mat.get_Bragg_angle(60000.0))
        mono = to.BentLaueCylinder.create(material=mat,
                                          pitch=math.pi / 2 + thetaB, **okw)
        g = mono.reflect(port_beam(d64, dt))[0]
        res[dt] = moments((g.Jss + g.Jpp).numpy(), g.state.numpy(),
                          g.E.double().numpy())
    f64, E64 = res[F64]
    f32, E32 = res[torch.float32]
    fj, Ej = moments(j32['I'], j32['state'], j32['E'].astype(float))
    port = (abs(f32 / f64 - 1), abs(E32 - E64))
    ref = (abs(fj / f64 - 1), abs(Ej - E64))
    print(f'Laue mono float32 vs float64, 3000 rays: flux per ray '
          f'{port[0]:.2e} (JAX package {ref[0]:.2e}), weighted mean E '
          f'{port[1]:.2e} eV ({ref[1]:.2e})')
    assert f64 > 1e-3
    assert port[0] <= ref[0] + 1e-3 and port[1] <= ref[1] + 1e-3
