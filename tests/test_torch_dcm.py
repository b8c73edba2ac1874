"""The port's double-crystal monochromator and crystal OEs against the JAX
package, on the same numpy rays.

* ``DCM.double_reflect`` of 1000 rays around 9 keV (Si(111), fixed exit
  20 mm) aligned at creation ('9000 eV', alignE), with the misalignments
  cryst2pitch, cryst2finePitch, cryst2roll, cryst2perpTransl,
  cryst2longTransl, cryst1roll, braggOffset, and the sagittally bent
  DCMwithSagittalFocusing: the global beam and both local beams, every
  field, against the JAX package run under ``jax.jit`` in float64.
  Directions to 1e-9, energies and paths to 1e-9 of their largest
  magnitude, the coherency elements to 1e-9 of the largest of the three
  (the rocking curve's slope amplifies one-ulp differences of the
  incidence by ~1e4; measured 2e-11), positions to 1e-9 of the beam's
  position scale (at least 1 mm), states equal; ``local_to_global`` of
  both local beams (``is2ndXtal`` for the second) likewise.
* A flat Si(111) crystal at nine pitch offsets around the Bragg angle
  (-40 to +80 urad), a parallel beam: the port against the JAX package
  to 1e-9 and against the material's |r_s|^2 at that incidence (1e-6, as
  ``tests/test_dcm.py``); one reflect with ``is2ndXtal=True``.
* The fixed exit in float64: exit directions equal to the incoming ones
  to 1e-9 (``tests/test_dcm.py``), the beam 20 mm up on a screen 1 m on.
* float32 against float64 on the same 4000 rays, beside the JAX package's
  own float32 run (a subprocess with x64 off): the transmitted flux per
  ray, the weighted mean and spread of the energy and the exit
  directions (against the float64 ones).  The port's float32 errors are
  no worse than the JAX package's plus a margin: flux 1e-3 relative, mean
  energy 0.01 eV, spread 1e-3 relative, directions 1e-6.
* ``DCMOnTripodWithOneXStage`` raises naming ROADMAP A11.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
from xrt_tpu import beam as jbeam
from xrt_tpu.oes import FlatMirror as JFlat
from xrt_tpu.oes.dcm import DCM as JDCM
from xrt_tpu.oes.dcm import DCMwithSagittalFocusing as JSagDCM
from xrt_tpu_torch import interop
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch.oes import (DCM, DCMOnTripodWithOneXStage,
                               DCMwithSagittalFocusing, FlatMirror)
from xrt_tpu_torch.screens import Screen

F64 = torch.float64
E0, P = 9000.0, 10000.0
FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'path', 'Jss', 'Jpp', 'Jsp',
          'theta')
DCM_KW = dict(center=(0, P, 0), fixedOffset=20.0, limPhysX=(-50, 50),
              limPhysY=(-500, 500))
MISALIGNED = dict(cryst2pitch=3e-6, cryst2finePitch=-1e-6, cryst2roll=2e-3,
                  cryst2longTransl=5.0, cryst1roll=1e-3, braggOffset=2e-6)


def rays_np(n=1000, seed=1, dE=3.0, div=1e-5, size=(0.1, 0.05)):
    """Horizontally polarized rays along +y around E0, float64 numpy."""
    rng = np.random.RandomState(seed)
    a = rng.normal(0, div, n)
    c = rng.normal(0, div, n)
    return dict(x=rng.normal(0, size[0], n), y=np.zeros(n),
                z=rng.normal(0, size[1], n), a=a, b=np.sqrt(1 - a**2 - c**2),
                c=c, E=rng.uniform(E0 - dE, E0 + dE, n),
                state=np.ones(n, np.int32), path=np.zeros(n),
                Jss=np.ones(n), Jpp=np.zeros(n), Jsp=np.zeros(n, complex))


def jax_beam(d):
    return jbeam.Beam(**{k: jnp.asarray(v) for k, v in d.items()})


def port_beam(d, dtype=F64):
    return interop.beam_from_numpy(d, device='cpu', dtype=dtype)


def _scale(j, names, floor):
    return max([floor] + [float(np.abs(np.asarray(getattr(j, f))).max())
                          for f in names])


def compare(t, j, tol=1e-9, fields=FIELDS):
    """Every field of two beams: positions against the beam's position
    scale (at least 1 mm), directions absolutely, the coherency elements
    against the largest of the three, the rest against each field's
    largest magnitude."""
    scales = dict.fromkeys('xyz', _scale(j, 'xyz', 1.0))
    scales.update(dict.fromkeys('abc', 1.0))
    scales.update(dict.fromkeys(('Jss', 'Jpp', 'Jsp'),
                                _scale(j, ('Jss', 'Jpp', 'Jsp'), 1e-300)))
    for f in fields:
        jv = getattr(j, f)
        if jv is None:
            continue
        jv = np.asarray(jv)
        tv = getattr(t, f).numpy()
        scale = scales.get(f, max(float(np.abs(jv).max()), 1e-300))
        assert np.abs(tv - jv).max() / scale < tol, f
    np.testing.assert_array_equal(t.state.numpy(), np.asarray(j.state))


_JIT = {}


def jit(name, fn):
    if name not in _JIT:
        _JIT[name] = jax.jit(fn)
    return _JIT[name]


@pytest.fixture(scope='module')
def rays():
    return rays_np()


CASES = {
    'energy_string': (JDCM, DCM, dict(bragg='9000 eV')),
    'alignE': (JDCM, DCM, dict(alignE=E0)),
    'misaligned': (JDCM, DCM, dict(alignE=E0, **MISALIGNED)),
    'perpTransl': (JDCM, DCM, dict(alignE=E0, fixedOffset=None,
                                   cryst2perpTransl=7.5)),
    'sagittal': (JSagDCM, DCMwithSagittalFocusing,
                 dict(alignE=E0, Rs=800.0, cryst2roll=1e-3)),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_double_reflect_matches_jax(rays, case):
    jcls, tcls, kw = CASES[case]
    kw = dict(DCM_KW, **kw)
    jd = jcls.create(material=jm.CrystalSi.create(hkl=(1, 1, 1)), **kw)
    td = tcls.create(material=tm.CrystalSi.create(hkl=(1, 1, 1), dtype=F64,
                                                  device='cpu'), **kw)
    assert td.braggAngle == float(jd.braggAngle)
    assert td.cryst2perpTransl == pytest.approx(float(jd.cryst2perpTransl),
                                                rel=1e-15)

    def run(d, b):
        g, l1, l2 = d.double_reflect(b)
        return g, l1, l2, d.local_to_global(l1), \
            d.local_to_global(l2, is2ndXtal=True)
    jout = jit(jcls.__name__, run)(jd, jax_beam(rays))
    tg, tl1, tl2 = td.double_reflect(port_beam(rays))
    tout = (tg, tl1, tl2, td.local_to_global(tl1),
            td.local_to_global(tl2, is2ndXtal=True))
    for t, j in zip(tout, jout):
        compare(t, j)
    good = tg.state.numpy() == 1
    assert good.mean() > 0.9
    assert float((tg.Jss + tg.Jpp)[torch.from_numpy(good)].mean()) > 0.1


def test_flat_crystal_rocking_matches_jax_and_material():
    cr = tm.CrystalSi.create(hkl=(1, 1, 1), dtype=F64, device='cpu')
    jcr = jm.CrystalSi.create(hkl=(1, 1, 1))
    thetaB = float(cr.get_Bragg_angle(E0))
    d = rays_np(n=100, div=0.0, size=(0.0, 0.0), dE=0.0)
    run = jit('flat', lambda oe, b: oe.reflect(b))
    jb, tb = jax_beam(d), port_beam(d)
    R = []
    for off in np.linspace(-40e-6, 80e-6, 9):
        kw = dict(center=(0, P, 0), pitch=thetaB + off, limPhysX=(-50, 50),
                  limPhysY=(-500, 500))
        jglo, jloc = run(JFlat.create(material=jcr, **kw), jb)
        tglo, tloc = FlatMirror.create(material=cr, **kw).reflect(tb)
        compare(tglo, jglo)
        compare(tloc, jloc)
        assert (tglo.state == 1).all()
        rs, _ = cr.get_amplitude(torch.tensor([E0], dtype=F64),
                                 torch.tensor([-math.sin(thetaB + off)],
                                              dtype=F64))
        R.append((float(tglo.Jss.mean()), float(torch.abs(rs[0]) ** 2)))
    R = np.array(R)
    np.testing.assert_allclose(R[:, 0], R[:, 1], rtol=1e-6, atol=1e-10)
    assert R[0, 0] < 0.1 and R[:, 0].max() > 0.8
    # the second-crystal frames on a plain OE: turned by pi in roll
    kw = dict(center=(0, P, 0), pitch=-thetaB, limPhysX=(-50, 50),
              limPhysY=(-500, 500))
    jr = jit('flat2', lambda oe, b: oe.reflect(b, is2ndXtal=True))(
        JFlat.create(material=jcr, **kw), jb)
    tr = FlatMirror.create(material=cr, **kw).reflect(tb, is2ndXtal=True)
    for t, j in zip(tr, jr):
        compare(t, j)


def test_fixed_exit(rays):
    td = DCM.create(material=tm.CrystalSi.create(hkl=(1, 1, 1), dtype=F64,
                                                 device='cpu'),
                    alignE=E0, **DCM_KW)
    beam = port_beam(rays)
    glo, _, _ = td.double_reflect(beam)
    good = glo.state == 1
    assert good.float().mean() > 0.9
    for f in 'abc':
        d = (getattr(glo, f) - getattr(beam, f))[good]
        assert float(d.abs().max()) < 1e-9, f
    img = Screen.create(center=(0, P + 1000.0, 20.0)).expose(glo)
    assert abs(float(img.z[good].mean())) < 0.2


JAX_F32 = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
import xrt_tpu.materials as jm
from xrt_tpu import beam as jbeam
from xrt_tpu.oes.dcm import DCM
a = dict(np.load(IN))
b = jbeam.Beam(**{k: jnp.asarray(v) for k, v in a.items()})
d = DCM.create(material=jm.CrystalSi.create(hkl=(1, 1, 1)), **KW)
g, _, _ = jax.jit(lambda d, b: d.double_reflect(b))(d, b)
np.savez(OUT, **{k: np.asarray(getattr(g, k)) for k in
                 ('a', 'b', 'c', 'E', 'Jss', 'Jpp', 'state')})
print('OK')
'''


def _metrics(g, g64, n):
    """(flux per ray, mean E, E spread, largest direction difference from
    the float64 run) of the transmitted rays."""
    good = (g['state'] == 1) & (g64['state'] == 1)
    I = (g['Jss'] + g['Jpp'])[g['state'] == 1]
    E = g['E'][g['state'] == 1]
    Em = np.average(E, weights=I)
    dirs = max(np.abs(g[f][good] - g64[f][good]).max() for f in 'abc')
    return (I.sum() / n, Em, math.sqrt(np.average((E - Em) ** 2,
                                                   weights=I)), dirs)


def test_float32_no_worse_than_jax_float32(clean_env_runner, tmp_path):
    d = rays_np(n=4000, seed=3, dE=8.0)
    kw = dict(DCM_KW, alignE=E0, **MISALIGNED)
    np.savez(tmp_path / 'in.npz', **{
        k: (v.astype(np.complex64) if np.iscomplexobj(v) else
            v.astype(np.int32) if k == 'state' else v.astype(np.float32))
        for k, v in d.items()})
    code = JAX_F32.replace('IN', repr(str(tmp_path / 'in.npz'))).replace(
        'OUT', repr(str(tmp_path / 'out.npz'))).replace('KW', repr(kw))
    out, _ = clean_env_runner(code, timeout=300)
    assert 'OK' in out
    j32 = dict(np.load(tmp_path / 'out.npz'))
    d32 = {k: (v.astype(np.float32).astype(np.float64) if
               v.dtype == np.float64 else v) for k, v in d.items()}
    res = {}
    for dt in (F64, torch.float32):
        td = DCM.create(material=tm.CrystalSi.create(
            hkl=(1, 1, 1), dtype=dt, device='cpu'), **kw)
        g, _, _ = td.double_reflect(port_beam(d32, dt))
        res[dt] = {k: getattr(g, k).numpy().astype(
            np.float64 if k != 'state' else np.int32)
            for k in ('a', 'b', 'c', 'E', 'Jss', 'Jpp', 'state')}
    n = len(d['x'])
    m64 = _metrics(res[F64], res[F64], n)
    m32 = _metrics(res[torch.float32], res[F64], n)
    mj = _metrics({k: v.astype(np.float64) if k != 'state' else v
                   for k, v in j32.items()}, res[F64], n)
    port = (abs(m32[0] / m64[0] - 1), abs(m32[1] - m64[1]),
            abs(m32[2] / m64[2] - 1))
    ref = (abs(mj[0] / m64[0] - 1), abs(mj[1] - m64[1]),
           abs(mj[2] / m64[2] - 1))
    print(f'float32 against float64: flux {port[0]:.3e} (JAX package '
          f'{ref[0]:.3e}), mean E {port[1]:.3e} eV ({ref[1]:.3e}), spread '
          f'{port[2]:.3e} ({ref[2]:.3e}), directions {m32[3]:.3e} '
          f'({mj[3]:.3e})')
    for p, r, margin in zip(port, ref, (1e-3, 1e-2, 1e-3)):
        assert p <= r + margin
    assert m32[3] <= mj[3] + 1e-6


def test_tripod_raises_naming_the_item():
    with pytest.raises(NotImplementedError, match='A11'):
        DCMOnTripodWithOneXStage(jack1=(0, 0, 0), jack2=(0, 0, 0),
                                 jack3=(0, 0, 0), dx=0.0, center=(0, 0, 0))


def test_mosaic_normal_and_mosaic_reflect():
    """``_mosaic_normal`` with the JAX package's draws injected equals its
    own to 1e-12; a mosaic graphite crystal OE reflects with finite
    amplitudes below 1."""
    from xrt_tpu.oes.base import _mosaic_normal as j_mosaic
    from xrt_tpu_torch.oes.base import _mosaic_normal as t_mosaic
    g_kw = dict(a=2.456, c=6.696, gamma=120, atoms=[6] * 4,
                atomsXYZ=[[0., 0., 0.], [0., 0., 0.5], [1. / 3, 2. / 3, 0.],
                          [2. / 3, 1. / 3, 0.5]], mosaicity=0.007)
    jg = jm.CrystalFromCell.create('graphite', (0, 0, 2), **g_kw)
    tg = tm.CrystalFromCell.create('graphite', (0, 0, 2), dtype=F64,
                                   device='cpu', **g_kw)
    rng = np.random.RandomState(4)
    n = 500
    nrm = rng.normal(0, 0.3, (3, n)) + np.array([[0.], [0.], [1.]])
    nrm[:, :50] = np.array([[0.95], [0.2], [0.05]])     # |nz| < 0.9
    nrm /= np.linalg.norm(nrm, axis=0)
    E = np.full(n, 10000.0)
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    draws = (torch.from_numpy(np.array(jax.random.normal(k1, (n,)))),
             torch.from_numpy(np.array(jax.random.uniform(k2, (n,)))))
    want = j_mosaic(key, jg, tuple(jnp.asarray(v) for v in nrm),
                    jnp.asarray(E))
    got = t_mosaic(None, tg, tuple(torch.from_numpy(v) for v in nrm),
                   torch.from_numpy(E), draws)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-12)
    thetaB = float(tg.get_Bragg_angle(10000.0))
    oe = FlatMirror.create(center=(0, P, 0), pitch=thetaB, material=tg,
                           limPhysX=(-50, 50), limPhysY=(-500, 500))
    d = rays_np(n=2000, div=0.0, size=(0.1, 0.1), dE=0.0)
    d['E'] = np.full(2000, 10000.0)
    glo, _ = oe.reflect(port_beam(d), torch.Generator().manual_seed(1))
    I = (glo.Jss + glo.Jpp).numpy()
    assert np.isfinite(I).all() and 0 < I.max() < 1
    # the crystallites spread the exit directions by ~2 mosaicities
    assert 0.003 < float(glo.c.std()) < 0.05


def test_grating_deflection_orders_match_jax():
    """Asymmetric-crystal and grating deflection: per-ray orders as the JAX
    package takes them, and a tuple of orders shared among the rays."""
    from xrt_tpu.oes.base import _OEMethods
    rng = np.random.RandomState(6)
    n = 400
    a, c = rng.normal(0, 1e-3, (2, n))
    b = np.sqrt(1 - a ** 2 - c ** 2)
    E = rng.uniform(8000, 10000, n)
    g = (np.zeros(n), rng.uniform(-300, -200, n), np.zeros(n))
    nrm = [np.zeros(n), np.zeros(n), np.ones(n)]
    bidn = -np.sin(np.full(n, 0.02)) + 0 * a
    order = rng.choice([-1.0, 1.0, 2.0], n)
    oe = FlatMirror.create()
    args = (a, b, c, E, g, nrm, bidn)
    want = _OEMethods._grating_deflection(
        None, None, *(jnp.asarray(v) if not isinstance(v, (tuple, list))
                      else tuple(jnp.asarray(u) for u in v) for v in args),
        order=jnp.asarray(order), sig=-1)
    got = oe._grating_deflection(
        None, *(torch.from_numpy(v) if not isinstance(v, (tuple, list))
                else tuple(torch.from_numpy(u) for u in v) for v in args),
        order=torch.from_numpy(order), sig=-1)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-12)
    got = oe._grating_deflection(
        torch.Generator().manual_seed(2),
        *(torch.from_numpy(v) if not isinstance(v, (tuple, list))
          else tuple(torch.from_numpy(u) for u in v) for v in args),
        order=(-1.0, 1.0, 2.0), sig=-1)
    loc = got[3].numpy()
    assert set(np.unique(loc)) == {-1.0, 1.0, 2.0}
    again = oe._grating_deflection(
        None, *(torch.from_numpy(v) if not isinstance(v, (tuple, list))
                else tuple(torch.from_numpy(u) for u in v) for v in args),
        order=got[3], sig=-1)
    for t, u in zip(got, again):
        assert torch.equal(t, u)
