"""The port's bending magnet, wiggler and synchrotron field maps against the
JAX package and against xrt's golden data.

* ``BendingMagnet`` and ``Wiggler``: parameters and ``build_I_map`` at
  ``ref_sources.npz``'s 693 points, float64, to
  ``tests/test_sources_synchrotron.py``'s tolerances (rtol 3e-8), and to
  the JAX package's maps within 1e-8 of each output's largest magnitude.
  The modified Bessel function K_nu near x = 8 is a difference of two
  series of ~420 that cancel to ~1e-4: one ulp of a power or of the
  order of a sum moves it by ~2e-9 relative, so the port and the JAX
  package agree to that, not to the last bit.
* ROADMAP C15: the JAX package's float32 K_nu (run in a subprocess with
  x64 off) is NaN for x in (6.2, 8) and 1e-4 / 4e-3 off at x = 4 / 6;
  the port evaluates it in float64 whatever the rays' dtype, so its
  float32 K holds float64 to 1e-6 with no NaN, and so does the float32
  bending-magnet map on the golden's points.
* ROADMAP C16: near a harmonic h the undulator's periodic factor
  sin(pi Np ww1) / sin(pi ww1) is a ratio of two sines near zero whose
  arguments (~pi Np h) carry float32 ulps of ~1e-4 rad; at configuration
  5's 7th harmonic (Np = 111) the JAX package's float32 map is out by up
  to 2.5x on axis.  The port evaluates the factor in float64: its float32
  map holds float64 to 1e-5.
* Ray-mode ``shine`` with the JAX package's draws injected: the bending
  magnet (with an energy spread and a pitch) and the wiggler equal the
  JAX beams, the ray geometry to 1e-12 (the bending magnet's positions
  of the orbit's radius) and the fields and the flux bookkeeping to 1e-8
  (the Bessel functions' rounding above).
* ``intensities_on_mesh`` (Stokes and vortex results, a harmonic axis, an
  energy-spread axis, the divergence convolution) and
  ``multi_electron_stack`` (with the JAX package's draws) against the JAX
  package, float64, to 1e-9; the undulator's ``tuning_curves``,
  ``power_vs_K`` and ``power_vs_K_through_aperture`` and the wiggler's
  ``power_vs_K`` likewise.
"""
import torch_harness  # noqa: F401

import os

import numpy as np
import pytest
import scipy.special as sp
import torch
import jax
import jax.numpy as jnp

from xrt_tpu.sources.synchrotron import (BendingMagnet as JBM,
                                         Wiggler as JWiggler,
                                         _kv_nu as jkv_nu)
from xrt_tpu.sources.undulator import Undulator as JUndulator
from xrt_tpu_torch.sources import BendingMagnet, Undulator, Wiggler
from xrt_tpu_torch.sources.synchrotron import _kv_nu

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
F64 = torch.float64
CPU = dict(dtype=F64, device='cpu')
BM_KW = dict(nrays=400, eE=6.0, eI=0.2, B0=0.85, eMin=10000, eMax=60000,
             xPrimeMax=1.0, zPrimeMax=0.3)
WIG_KW = dict(nrays=400, eE=3.0, eI=0.5, K=13.0, period=150.0, n=10,
              eMin=1000, eMax=30000, xPrimeMax=1.0, zPrimeMax=0.3)
#: tests/test_mesh_intensities.py's sources, with a fixed node grid
MESH_BM = dict(eE=3.0, eI=0.5, B0=1.7, eEpsilonX=0.0, eEpsilonZ=0.0,
               eMin=9000.0, eMax=11000.0, xPrimeMax=1e-3, zPrimeMax=0.3e-3)
MESH_UND = dict(eE=3.0, eI=0.5, K=1.45, period=29.0, n=40, eEpsilonX=0.0,
                eEpsilonZ=0.0, eMin=3000.0, eMax=3200.0, xPrimeMax=0.05e-3,
                zPrimeMax=0.05e-3, gNodes=48)


def rel(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.abs(t - j).max() / np.abs(j).max())


@pytest.fixture(scope='module')
def ref():
    return np.load(os.path.join(GOLDEN, 'ref_sources.npz'))


SOURCES = {'bm': (BendingMagnet, JBM, BM_KW),
           'wig': (Wiggler, JWiggler, WIG_KW)}


@pytest.mark.parametrize('name', sorted(SOURCES))
def test_intensity_map_matches_golden_and_jax(ref, name):
    cls, jcls, kw = SOURCES[name]
    src = cls.create(**kw, **CPU)
    if name == 'bm':
        np.testing.assert_allclose(src.gamma, ref['bm_gamma'], rtol=1e-12)
        np.testing.assert_allclose(src.ro, ref['bm_ro'], rtol=1e-10)
        for p in ('dx', 'dz', 'dxprime', 'dzprime'):
            np.testing.assert_allclose(getattr(src, p), ref['bm_' + p],
                                       rtol=1e-10)
    else:
        np.testing.assert_allclose(src.K, ref['wig_K'], rtol=1e-10)
        np.testing.assert_allclose(src.B0, ref['wig_B'], rtol=1e-10)
        np.testing.assert_allclose(src.X0, ref['wig_X0'], rtol=1e-8)
    E, th, ps = (torch.from_numpy(ref[f'{name}_{k}'])
                 for k in ('E', 'theta', 'psi'))
    got = src.build_I_map(None, E, th, ps)
    atol_I = 0.0 if name == 'bm' else 1e-3
    np.testing.assert_allclose(got[0].numpy(), ref[f'{name}_I'], rtol=3e-8,
                               atol=atol_I)
    for i, k in ((1, 'Es'), (2, 'Ep')):
        np.testing.assert_allclose(got[i].numpy(), ref[f'{name}_{k}'],
                                   rtol=3e-8, atol=1e-10)
    jgot = jcls.create(**kw).build_I_map(
        jax.random.PRNGKey(0), *(jnp.asarray(v.numpy()) for v in (E, th,
                                                                  ps)))
    for t, j in zip(got, jgot):
        assert rel(t, j) < 1e-8


def test_kv_nu_float64_matches_jax_and_scipy():
    x = np.concatenate([np.geomspace(1e-4, 1.0, 200),
                        np.linspace(1.0, 80.0, 2000)])
    for nu in (1 / 3, 2 / 3):
        got = _kv_nu(nu, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, sp.kv(nu, x), rtol=3e-8)
        np.testing.assert_allclose(got, np.asarray(jkv_nu(nu,
                                                          jnp.asarray(x))),
                                   rtol=1e-8)


JAX_F32_KV = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
from xrt_tpu.sources.synchrotron import _kv_nu
x = np.linspace(0.05, 12.0, 2391).astype(np.float32)
np.savez(OUT, x=x, **{f'k{i}': np.asarray(_kv_nu(nu, jnp.asarray(x)))
                      for i, nu in enumerate((1 / 3, 2 / 3))})
print('OK')
'''


def test_c15_float32_bessel_repaired(ref, clean_env_runner, tmp_path):
    """ROADMAP C15: the reference's float32 series breaks below x = 8;
    the port's float32 holds its float64."""
    out = tmp_path / 'kv.npz'
    stdout, _ = clean_env_runner(f'OUT = {str(out)!r}\n' + JAX_F32_KV)
    assert 'OK' in stdout
    res = np.load(out)
    x = res['x'].astype(np.float64)
    band = (x > 6.3) & (x < 7.95)
    for i, nu in enumerate((1 / 3, 2 / 3)):
        exact = sp.kv(nu, x)
        jax32 = res[f'k{i}'].astype(np.float64)
        # the JAX package's float32: NaN across the band, and digits lost
        # to the cancellation of the two series below it
        assert np.isnan(jax32[band]).all()
        near4 = np.abs(x - 4.0) < 0.05
        assert np.nanmax(np.abs(jax32[near4] / exact[near4] - 1)) > 1e-5
        port32 = _kv_nu(nu, torch.from_numpy(res['x'])).numpy()
        assert port32.dtype == np.float32 and np.isfinite(port32).all()
        port64 = _kv_nu(nu, torch.from_numpy(x)).numpy()
        assert np.abs(port32 / port64 - 1).max() < 1e-6
    # the float32 bending-magnet map on the golden's points (x up to ~70)
    bm = BendingMagnet.create(**BM_KW, dtype=torch.float32, device='cpu')
    args = [torch.from_numpy(ref[f'bm_{k}']).float()
            for k in ('E', 'theta', 'psi')]
    got32 = bm.build_I_map(None, *args)
    got64 = BendingMagnet.create(**BM_KW, **CPU).build_I_map(
        None, *(a.double() for a in args))
    for t32, t64 in zip(got32, got64):
        assert torch.isfinite(torch.abs(t32)).all()
        assert rel(t32.to(t64.dtype), t64) < 1e-5


def jax_draws(key, nrays, M, source, dt=jnp.float64):
    """The draws of the JAX package's ``shine`` of a bending magnet or a
    wiggler from *key*, as numpy."""
    keys = jax.random.split(key, 10)
    d = dict(E=jax.random.uniform(keys[0], (M,), dt),
             theta=jax.random.uniform(keys[1], (M,), dt),
             psi=jax.random.uniform(keys[2], (M,), dt),
             gamma=jax.random.normal(keys[3], (M,), dt),
             choice=jax.random.uniform(keys[4], (nrays,), dt),
             dtheta=jax.random.normal(keys[5], (nrays,), dt),
             dpsi=jax.random.normal(keys[7], (nrays,), dt))
    if source == 'wig':
        k1, k2, k3 = jax.random.split(keys[8], 3)
        d.update(pole=jax.random.randint(k1, (nrays,), -10, 10),
                 x=jax.random.normal(k2, (nrays,), dt),
                 z=jax.random.normal(k3, (nrays,), dt))
    else:
        k1, k2 = jax.random.split(keys[8])
        d.update(smear=jax.random.normal(keys[6], (nrays,), dt),
                 z=jax.random.normal(k1, (nrays,), dt),
                 x=jax.random.normal(k2, (nrays,), dt))
    return {k: np.array(v) for k, v in d.items()}


SHINE_CASES = {'bm': ('bm', {}), 'bm_spread_pitch':
               ('bm', dict(eEspread=1e-3, pitch=2e-4)), 'wig': ('wig', {})}
GEOMETRY = ('x', 'y', 'z', 'a', 'b', 'c', 'E')
FIELDS = ('Jss', 'Jpp', 'Jsp', 'Es', 'Ep', 'accepted', 'acceptedE',
          'seededI')


@pytest.mark.parametrize('case', sorted(SHINE_CASES))
def test_shine_with_injected_draws_matches_jax(case):
    name, extra = SHINE_CASES[case]
    cls, jcls, kw = SOURCES[name]
    kw = dict(kw, **extra)
    src = cls.create(**kw, **CPU)
    key = jax.random.PRNGKey(7)
    jb = jcls.create(**kw).shine(key)
    tb = src.shine(None, draws=jax_draws(key, 400, 400 * src.oversample,
                                         name))
    for f in GEOMETRY + FIELDS:
        j = np.asarray(getattr(jb, f))
        t = getattr(tb, f).numpy()
        scale = max(float(np.abs(j).max()), 1e-300)
        if f in ('x', 'y') and name == 'bm':
            # a point on the orbit: a difference of numbers of the
            # orbit's radius
            scale = src.ro * 1e3
        tol = 1e-12 if f in GEOMETRY else 1e-8
        assert np.abs(t - j).max() / scale < tol, f
    np.testing.assert_array_equal(tb.state.numpy(), np.asarray(jb.state))
    if name == 'wig':
        assert torch.count_nonzero(tb.Jsp) == 0


def test_free_shine_runs_on_the_port_generator():
    bm = BendingMagnet.create(**dict(BM_KW, nrays=3000), **CPU)
    b = bm.shine(torch.Generator().manual_seed(1))
    assert torch.isfinite(b.Jss).all() and float(b.accepted) > 0
    assert float(b.E.min()) >= 10000 and float(b.E.max()) <= 60000
    w = Wiggler.create(**dict(WIG_KW, nrays=3000), **CPU)
    b = w.shine(torch.Generator().manual_seed(2))
    L = w.L0 * w.Np
    assert float(b.y.abs().max()) < L / 2 + w.L0


def _pair(kind, **extra):
    if kind == 'bm':
        kw = dict(MESH_BM, **extra)
        return BendingMagnet.create(**kw, **CPU), JBM.create(**kw)
    kw = dict(MESH_UND, **extra)
    return Undulator.create(**kw, **CPU), JUndulator.create(**kw)


THETA = np.linspace(-2e-5, 2e-5, 5)
PSI = np.linspace(-2e-5, 2e-5, 4)
MESH_CASES = {
    'bm_stokes': ('bm', {}, dict(energy=np.array([10000.0]),
                                 theta=np.linspace(-5e-4, 5e-4, 5),
                                 psi=np.linspace(-3e-4, 3e-4, 21))),
    'bm_convolved': ('bm', dict(eEpsilonZ=0.02, betaZ=2.0),
                     dict(energy=np.array([10000.0, 10500.0]),
                          theta=np.linspace(-5e-4, 5e-4, 5),
                          psi=np.linspace(-3e-4, 3e-4, 21))),
    'und_harmonic': ('und', {}, dict(energy=np.array([3100.0, 3120.0]),
                                     theta=THETA, psi=PSI,
                                     harmonic=[1, 2])),
    'und_spread_vortex': ('und', dict(eEspread=2e-3),
                          dict(energy=np.linspace(3050.0, 3150.0, 3),
                               theta=THETA, psi=PSI, eSpreadNSamples=8,
                               resultKind='vortex')),
    'und_spread_convolved': ('und', dict(eEspread=2e-3, eEpsilonX=0.3,
                                         eEpsilonZ=0.01),
                             dict(energy=np.linspace(3050.0, 3150.0, 3),
                                  theta=THETA, psi=PSI,
                                  eSpreadNSamples=6)),
    'und_spread_vortex_convolved': ('und', dict(eEspread=2e-3,
                                                eEpsilonX=0.3,
                                                eEpsilonZ=0.01),
                                    dict(energy=np.array([3100.0]),
                                         theta=THETA, psi=PSI,
                                         eSpreadNSamples=6,
                                         resultKind='vortex')),
}


@pytest.mark.parametrize('case', sorted(MESH_CASES))
def test_intensities_on_mesh_match_jax(case):
    kind, extra, kw = MESH_CASES[case]
    t, j = _pair(kind, **extra)
    got = t.intensities_on_mesh(**kw)
    ref = [np.asarray(r) for r in j.intensities_on_mesh(**kw)]
    assert len(got) == len(ref)
    if kw.get('resultKind') == 'vortex':
        # intensities and angular-momentum terms on the scale of the
        # intensity, fields on the scale of the field
        s = np.abs(ref[0] + ref[1]).max()
        scales = [s] * 4 + [np.abs(np.concatenate([ref[4], ref[5]])).max()
                            ] * 2
    else:
        # s0, then the normalized s1/s0, s2/s0, s3/s0
        scales = [np.abs(ref[0]).max(), 1.0, 1.0, 1.0]
    for g, r, sc in zip(got, ref, scales):
        assert g.shape == r.shape
        assert np.abs(g - r).max() / sc < 1e-9


@pytest.mark.parametrize('kind', ['bm', 'und'])
def test_multi_electron_stack_matches_jax_on_its_draws(kind):
    extra = dict(eEpsilonX=0.3, eEpsilonZ=0.01)
    if kind == 'und':
        extra['eEspread'] = 1e-3
    t, j = _pair(kind, **extra)
    energy = np.array([3099.0, 3100.0, 3101.0]) if kind == 'und' else \
        np.array([9990.0, 10000.0, 10010.0])
    key = jax.random.PRNGKey(3)
    k1, k2, k3, _ = jax.random.split(key, 4)
    draws = {n: np.asarray(jax.random.normal(k, (3,), jnp.float64))
             for n, k in (('dtheta', k1), ('dpsi', k2), ('gamma', k3))}
    kw = dict(energy=energy, theta=np.linspace(-2e-5, 2e-5, 4),
              psi=np.linspace(-2e-5, 2e-5, 3))
    got = t.multi_electron_stack(draws=draws, **kw)
    ref = j.multi_electron_stack(key, **kw)
    for g, r in zip(got, ref):
        assert g.shape == (3, 4, 3)
        assert rel(g, r) < 1e-9


def test_undulator_tuning_curves_and_power_match_jax():
    t, j = _pair('und')
    Ks = [1.3, 1.45]
    E1s = [float(j.replace(Ky=j.Ky * 0 + K).E1) for K in Ks]
    energy = np.linspace(min(E1s) - 150, max(E1s) + 50, 13)
    theta = np.linspace(-2e-5, 2e-5, 3)
    psi = np.linspace(-2e-5, 2e-5, 3)
    tE, tF = t.tuning_curves(energy, theta, psi, [1], Ks)
    jE, jF = j.tuning_curves(energy, theta, psi, [1], Ks)
    assert tE.shape == (2, 1)
    np.testing.assert_array_equal(tE, jE)
    np.testing.assert_allclose(tF, jF, rtol=1e-9)
    np.testing.assert_allclose(
        t.power_vs_K_through_aperture(energy, theta, psi, Ks),
        j.power_vs_K_through_aperture(energy, theta, psi, Ks), rtol=1e-9)
    np.testing.assert_allclose(t.power_vs_K(), float(j.power_vs_K()),
                               rtol=1e-12)
    np.testing.assert_allclose(t.power_vs_K(Ks), np.asarray(j.power_vs_K(
        jnp.asarray(Ks))), rtol=1e-12)
    w = Wiggler.create(**WIG_KW, **CPU)
    jw = JWiggler.create(**WIG_KW)
    np.testing.assert_allclose(w.power_vs_K(), float(jw.power_vs_K()),
                               rtol=1e-12)
    np.testing.assert_allclose(w.power_vs_K([5.0, 13.0]), np.asarray(
        jw.power_vs_K(jnp.asarray([5.0, 13.0]))), rtol=1e-12)


#: BASELINE configuration 5's undulator (tests/test_baseline_configs.py)
C5_UND = dict(eE=3.0, eI=0.5, period=18.0, n=111, targetE=(9000.0, 7),
              eEpsilonX=0.263, eEpsilonZ=0.008, betaX=9.0, betaZ=2.0,
              xPrimeMax=0.02, zPrimeMax=0.02, gNodes=64, eMin=8999.0,
              eMax=9001.0)

JAX_F32_UND = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
from xrt_tpu.sources import Undulator
d = np.load(IN)
I = Undulator.create(**ARGS).build_I_map(
    jax.random.PRNGKey(0), *(jnp.asarray(d[k]) for k in ('E', 't', 'p')))[0]
np.savez(OUT, I=np.asarray(I))
print('OK')
'''


def test_c16_float32_undulator_periodic_factor_repaired(clean_env_runner,
                                                        tmp_path):
    """ROADMAP C16 at configuration 5's undulator, on the axis and across
    the central cone at 9 keV +- 1 eV."""
    E, t, p = (v.ravel().astype(np.float32) for v in np.meshgrid(
        np.linspace(8999.0, 9001.0, 9), np.linspace(-4e-6, 4e-6, 9),
        np.linspace(-3e-6, 3e-6, 7), indexing='ij'))
    np.savez(tmp_path / 'in.npz', E=E, t=t, p=p)
    stdout, _ = clean_env_runner(
        f'IN = {str(tmp_path / "in.npz")!r}\n'
        f'OUT = {str(tmp_path / "out.npz")!r}\nARGS = {C5_UND!r}\n' +
        JAX_F32_UND)
    assert 'OK' in stdout
    jax32 = np.load(tmp_path / 'out.npz')['I'].astype(np.float64)
    pts = [torch.from_numpy(v) for v in (E, t, p)]
    I64 = Undulator.create(**C5_UND, **CPU).build_I_map(
        None, *(v.double() for v in pts))[0].numpy()
    I32 = Undulator.create(**C5_UND, dtype=torch.float32,
                           device='cpu').build_I_map(None, *pts)[0].numpy()
    # the JAX package's float32 misses by tens of percent of the peak
    assert np.abs(jax32 - I64).max() / I64.max() > 0.1
    assert np.abs(I32 - I64).max() / I64.max() < 1e-5
    # float64 is the reference's arithmetic
    jI = JUndulator.create(**C5_UND).build_I_map(
        jax.random.PRNGKey(0), *(jnp.asarray(v.double().numpy())
                                 for v in pts))[0]
    assert rel(I64, jI) < 1e-10
