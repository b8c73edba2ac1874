"""The port's crystals against the JAX package and the goldens.

* The ten rocking curves of ``tests/test_materials.py`` (``ROCKING_CASES``:
  Si(111) and Si(333), thick and thin, Bragg and Laue, reflected and
  transmitted, symmetric and +-5 deg asymmetric) against
  ``tests/golden/ref_materials.npz`` at that file's limits (rtol 1e-4,
  atol 3e-6), float64.
* ``CrystalSi`` (d, F0, Fhkl, Darwin width, Bragg angle, the asymmetric
  angle correction), alpha-quartz from its cell and mosaic graphite
  against the same goldens at the JAX tests' limits.
* The port against the JAX package's ``get_amplitude`` on the same
  numbers to 1e-10 of the largest amplitude, and its ``get_dtheta``,
  ``get_dtheta_regular``, ``get_Darwin_width``, ``get_extinction_lengths``
  and ``get_refractive_correction`` to 1e-10 relative, float64; the Bragg
  angle of a Python-number energy as the JAX package takes it (f1, f2 in
  float32, a weakly typed scalar there) to 1e-15.
* float32 rocking curves against float64: the port's error no worse than
  the JAX package's own float32 error on the same angles (run in a
  subprocess with x64 off) plus 1e-3 of the peak.
* Guards: ``useTT=True`` is accepted and an unbent crystal's
  Takagi-Taupin entry is its two-beam amplitude; the complex-free i z
  helper.
"""
import math
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import xrt_tpu.materials as jm
from xrt_tpu.physconsts import CH
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch.materials.crystal import _mul_i

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')

ROCKING_CASES = [
    ('braggSi111_thick_0', (1, 1, 1), 3.13562, None, 'Bragg reflected', 0.),
    ('braggSi111_thick_5', (1, 1, 1), 3.13562, None, 'Bragg reflected', 5.),
    ('braggSi111_thick_m5', (1, 1, 1), 3.13562, None, 'Bragg reflected',
     -5.),
    ('braggSi111_100mum_0', (1, 1, 1), 3.13562, 0.100, 'Bragg reflected',
     0.),
    ('braggSi111_007mum_0', (1, 1, 1), 3.13562, 0.007, 'Bragg reflected',
     0.),
    ('laueSi111_100mum_0', (1, 1, 1), 3.13562, 0.100, 'Laue reflected', 0.),
    ('laueSi111_100mum_5', (1, 1, 1), 3.13562, 0.100, 'Laue reflected', 5.),
    ('braggtSi111_100mum_0', (1, 1, 1), 3.13562, 0.100, 'Bragg transmitted',
     0.),
    ('lauetSi111_100mum_0', (1, 1, 1), 3.13562, 0.100, 'Laue transmitted',
     0.),
    ('braggSi333_thick_0', (3, 3, 3), 3.13562 / 3, None, 'Bragg reflected',
     0.),
]


@pytest.fixture(scope='module')
def ref():
    return np.load(os.path.join(GOLDEN, 'ref_materials.npz'))


def T(v, dtype=F64):
    return torch.as_tensor(np.asarray(v), dtype=dtype)


def rocking_geometry(d, geom, alphaDeg, dtheta, E0=10000.):
    """(E, gamma0, gammah, hns0) of the golden rocking curves, float64
    numpy."""
    thetaCenter = math.asin(CH / (2 * d * E0))
    theta = dtheta + thetaCenter
    alpha = math.radians(alphaDeg)
    s0 = (np.zeros_like(theta), np.cos(theta + alpha),
          -np.sin(theta + alpha))
    sh = (np.zeros_like(theta), np.cos(theta - alpha), np.sin(theta - alpha))
    n = (0, 0, 1) if geom.startswith('Bragg') else (0, -1, 0)
    hn = (0, math.sin(alpha), math.cos(alpha))
    gamma0 = sum(i * j for i, j in zip(n, s0))
    gammah = sum(i * j for i, j in zip(n, sh))
    hns0 = sum(i * j for i, j in zip(hn, s0))
    return np.full(dtheta.shape, E0), gamma0, gammah, hns0


def port_crystal(hkl, dsp, t, geom, dtype=F64):
    return tm.CrystalDiamond.create(hkl=hkl, d=dsp, t=t, geom=geom,
                                    dtype=dtype, device='cpu')


@pytest.mark.parametrize('name,hkl,dsp,t,geom,alphaDeg', ROCKING_CASES)
def test_rocking_curves_vs_golden_and_jax(ref, name, hkl, dsp, t, geom,
                                          alphaDeg):
    """The golden curve at rtol 1e-4, atol 3e-6; the JAX package's
    amplitudes on the same numbers to 1e-9 of the largest: at the edges of
    the total-reflection plateau alpha^2 + chih chih_ / b passes near zero,
    and the slope of its root there amplifies one-ulp differences of the
    inputs (2e-10 measured on Si(333), whose susceptibilities agree to
    4e-16)."""
    cr = port_crystal(hkl, dsp, t, geom)
    dth = ref[f'rc_{name}_dtheta']
    args = rocking_geometry(float(cr.d), geom, alphaDeg, dth)
    curS, curP = cr.get_amplitude(*(T(a) for a in args))
    np.testing.assert_allclose(curS.numpy(), ref[f'rc_{name}_s'],
                               rtol=1e-4, atol=3e-6)
    np.testing.assert_allclose(curP.numpy(), ref[f'rc_{name}_p'],
                               rtol=1e-4, atol=3e-6)
    jc = jm.CrystalDiamond.create(hkl=hkl, d=dsp, t=t, geom=geom)
    jS, jP = jc.get_amplitude(*(jnp.asarray(a) for a in args))
    for got, want in ((curS, jS), (curP, jP)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() / scale < 1e-9


def test_crystal_si(ref):
    si = tm.CrystalSi.create(hkl=(1, 1, 1), tK=297.15, dtype=F64,
                             device='cpu')
    np.testing.assert_allclose(float(si.d), ref['crystalSi_d'], rtol=1e-12)
    Es = T(ref['crystalSi_E'])
    F0, Fhkl, _ = si.get_structure_factor(Es, 0.5 / si.d)
    np.testing.assert_allclose(F0.numpy(), ref['crystalSi_F0'], rtol=1e-7)
    np.testing.assert_allclose(Fhkl.numpy(), ref['crystalSi_Fhkl'],
                               rtol=1e-7)
    np.testing.assert_allclose(si.get_Darwin_width(Es).numpy(),
                               ref['crystalSi_darwin_s'], rtol=1e-7)
    np.testing.assert_allclose(si.get_Bragg_angle(Es).numpy(),
                               ref['crystalSi_thetaB'], rtol=1e-12)
    np.testing.assert_allclose(
        si.get_dtheta(Es, alpha=math.radians(5.)).numpy(),
        ref['crystalSi_dtheta'], rtol=1e-7)
    assert si.get_a() == pytest.approx(jm.CrystalSi.create().get_a(),
                                       rel=1e-15)


QUARTZ = dict(
    a=4.91304, c=5.40463, gamma=120, atoms=[14] * 3 + [8] * 6,
    atomsXYZ=[[0.4697, 0., 0.], [-0.4697, -0.4697, 1. / 3],
              [0., 0.4697, 2. / 3], [0.4125, 0.2662, 0.1188],
              [-0.1463, -0.4125, 0.4521], [-0.2662, 0.1463, -0.2145],
              [0.1463, -0.2662, -0.1188], [-0.4125, -0.1463, 0.2145],
              [0.2662, 0.4125, 0.5479]])
GRAPHITE = dict(a=2.456, c=6.696, gamma=120, atoms=[6] * 4,
                atomsXYZ=[[0., 0., 0.], [0., 0., 0.5], [1. / 3, 2. / 3, 0.],
                          [2. / 3, 1. / 3, 0.5]],
                mosaicity=np.radians(0.4))


def test_crystal_from_cell(ref):
    qu = tm.CrystalFromCell.create('alphaQuartz', (1, 0, 2), dtype=F64,
                                   device='cpu', **QUARTZ)
    np.testing.assert_allclose(float(qu.d), ref['quartz_d'], rtol=1e-12)
    np.testing.assert_allclose(float(qu.V), ref['quartz_V'], rtol=1e-12)
    Es = T(ref['crystalSi_E'])
    F0, Fhkl, Fhkl_ = qu.get_structure_factor(Es, 0.5 / qu.d)
    np.testing.assert_allclose(F0.numpy(), ref['quartz_F0'], rtol=1e-7)
    np.testing.assert_allclose(Fhkl.numpy(), ref['quartz_Fhkl'], rtol=1e-7)
    np.testing.assert_allclose(Fhkl_.numpy(), ref['quartz_Fhkl_'],
                               rtol=1e-7)


def test_mosaic(ref):
    g = tm.CrystalFromCell.create('graphite', (0, 0, 2), dtype=F64,
                                  device='cpu', **GRAPHITE)
    thetaB = float(g.get_Bragg_angle(10000.))
    dth = ref['mosaic_dtheta']
    ms, mp = g.get_amplitude_mosaic(T(np.full(dth.shape, 10000.)),
                                    T(-np.sin(thetaB + dth)))
    np.testing.assert_allclose(ms.numpy(), ref['mosaic_s'], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(mp.numpy(), ref['mosaic_p'], rtol=1e-6,
                               atol=1e-9)
    # strongly typed float64 energies: jnp.full of a Python number is
    # weakly typed, and the JAX package then interpolates f1, f2 in the
    # tables' float32
    jg = jm.CrystalFromCell.create('graphite', (0, 0, 2), **GRAPHITE)
    jms, jmp = jg.get_amplitude_mosaic(
        jnp.asarray(np.full(dth.shape, 10000.)),
        -jnp.sin(thetaB + jnp.asarray(dth)))
    np.testing.assert_allclose(ms.numpy(), np.asarray(jms), rtol=1e-10)
    np.testing.assert_allclose(mp.numpy(), np.asarray(jmp), rtol=1e-10)


CRYSTALS = {
    'Si111': (lambda m, **k: m.CrystalSi.create(hkl=(1, 1, 1), **k)),
    'Si444': (lambda m, **k: m.CrystalDiamond.create(
        hkl=(4, 4, 4), d=3.1354161 / 4, elements='Si', rho=2.33, **k)),
    'diamond220_laue': (lambda m, **k: m.CrystalDiamond.create(
        hkl=(2, 2, 0), geom='Laue reflected', t=0.2, **k)),
    'quartz102': (lambda m, **k: m.CrystalFromCell.create(
        'alphaQuartz', (1, 0, 2), **QUARTZ, **k)),
}


@pytest.mark.parametrize('name', sorted(CRYSTALS))
def test_crystal_methods_match_jax(name):
    """Amplitudes over +-100 urad around the Bragg angle at 9 keV and
    random asymmetric geometries, and the angle corrections, to 1e-10."""
    make = CRYSTALS[name]
    cr = make(tm, dtype=F64, device='cpu')
    jc = make(jm)
    E = 9000.0 if name != 'Si444' else 9132.0
    thB = float(jc.get_Bragg_angle(E))
    rng = np.random.RandomState(5)
    n = 301
    Es = E + rng.uniform(-3, 3, n)
    th = thB + np.linspace(-1e-4, 1e-4, n)
    alpha = rng.uniform(-0.05, 0.05, n)
    gin = -np.sin(th + alpha)
    gout = np.sin(th - alpha)
    hin = -np.sin(th)
    got = cr.get_amplitude(T(Es), T(gin), T(gout), T(hin))
    want = jc.get_amplitude(jnp.asarray(Es), jnp.asarray(gin),
                            jnp.asarray(gout), jnp.asarray(hin))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() / np.abs(w).max() < 1e-10
    Ev = np.linspace(E - 200, E + 200, 11)
    for meth, kw in (('get_dtheta', {}), ('get_dtheta', {'alpha': 0.03}),
                     ('get_dtheta_regular', {'alpha': 0.03}),
                     ('get_Darwin_width', {}),
                     ('get_refractive_correction', {'alpha': 0.02})):
        g = getattr(cr, meth)(T(Ev), **kw).numpy()
        w = np.asarray(getattr(jc, meth)(jnp.asarray(Ev), **kw))
        np.testing.assert_allclose(g, w, rtol=1e-10, err_msg=meth)
    for g, w in zip(cr.get_extinction_lengths(T(Ev)),
                    jc.get_extinction_lengths(jnp.asarray(Ev))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)
    # a Python-number energy: the Bragg angle less its correction as a
    # monochromator takes it at creation
    assert float(cr.get_Bragg_angle(E) - cr.get_dtheta(E)) == \
        pytest.approx(float(jc.get_Bragg_angle(E) - jc.get_dtheta(E)),
                      rel=1e-15, abs=0)


JAX_F32 = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
import xrt_tpu.materials as jm
a = dict(np.load(IN))
out = {}
for name, hkl, d, t, geom in CASES:
    cr = jm.CrystalDiamond.create(hkl=hkl, d=d, t=t, geom=geom)
    s, p = cr.get_amplitude(*(jnp.asarray(a[name + k], jnp.float32)
                              for k in ('_E', '_g0', '_gh', '_hn')))
    out[name + '_s'] = np.asarray(s)
    out[name + '_p'] = np.asarray(p)
np.savez(OUT, **out)
print('OK')
'''


def test_float32_rocking_no_worse_than_jax_float32(clean_env_runner,
                                                   tmp_path):
    """float32 |r|^2 of thick Si(111) and Si(333) against float64 on the
    same angles: the port's error within the JAX package's own float32
    error plus 1e-3 of the peak reflectivity.  Both are large on the steep
    flanks (ROADMAP C10): the deviation parameter is a difference of
    numbers near sin(theta_B) that comes out near 1e-5 (Si(111)) or 2e-6
    (Si(333), a five times narrower curve)."""
    cases = [c for c in ROCKING_CASES if c[0] in
             ('braggSi111_thick_0', 'braggSi111_thick_5',
              'braggSi333_thick_0')]
    dth = np.linspace(-20e-6, 80e-6, 401)
    arrays = {}
    for name, hkl, d, t, geom, alphaDeg in cases:
        args = rocking_geometry(d, geom, alphaDeg, dth)
        for k, v in zip(('_E', '_g0', '_gh', '_hn'), args):
            arrays[name + k] = np.asarray(v, np.float32)
    np.savez(tmp_path / 'in.npz', **arrays)
    code = JAX_F32.replace('IN', repr(str(tmp_path / 'in.npz'))).replace(
        'OUT', repr(str(tmp_path / 'out.npz'))).replace(
        'CASES', repr([c[:5] for c in cases]))
    out, _ = clean_env_runner(code, timeout=300)
    assert 'OK' in out
    jax32 = np.load(tmp_path / 'out.npz')
    for name, hkl, d, t, geom, alphaDeg in cases:
        ins = [arrays[name + k].astype(np.float64) for k in
               ('_E', '_g0', '_gh', '_hn')]
        r64 = [np.abs(c.numpy()) ** 2 for c in port_crystal(
            hkl, d, t, geom).get_amplitude(*(T(a) for a in ins))]
        r32 = [np.abs(c.numpy()) ** 2 for c in port_crystal(
            hkl, d, t, geom, torch.float32).get_amplitude(
            *(T(a, torch.float32) for a in ins))]
        for pol, a64, a32 in zip('sp', r64, r32):
            peak = a64.max()
            port_err = np.abs(a32 - a64).max() / peak
            jax_err = np.abs(np.abs(jax32[f'{name}_{pol}']) ** 2 -
                             a64).max() / peak
            print(f'{name} {pol}: float32 max|dR|/R_peak port '
                  f'{port_err:.3e}, JAX package {jax_err:.3e}')
            assert port_err <= jax_err + 1e-3, (name, pol, port_err,
                                                jax_err)


def test_bent_crystal_amplitudes_raise_naming_the_item():
    """Bent crystals are ported (``tests/test_torch_tt.py``): ``useTT=True``
    is accepted by both crystal constructors and raises nothing, and an
    unbent crystal's Takagi-Taupin entry gives its two-beam amplitudes."""
    cr = tm.CrystalSi.create(useTT=True, dtype=F64, device='cpu')
    assert cr.useTT
    assert tm.CrystalFromCell.create('Si', useTT=True, dtype=F64,
                                     device='cpu').useTT
    thetaB = float(cr.get_Bragg_angle(9000.0))
    E = torch.full((41,), 9000.0, dtype=F64)
    bIn = -torch.sin(thetaB + torch.linspace(-3e-5, 6e-5, 41, dtype=F64))
    for got, ref in zip(cr.get_amplitude_pytte(E, bIn),
                        cr.get_amplitude(E, bIn)):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_mul_i_is_i_times_z():
    z = torch.tensor([1 + 2j, -3.5 + 0.25j, 0j], dtype=torch.complex128)
    np.testing.assert_array_equal(_mul_i(z).numpy(), 1j * z.numpy())
