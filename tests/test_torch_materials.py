"""The port's refractive index and multilayers against the JAX package.

* ROADMAP C12: ``Material.get_refractive_index`` in float32 equals the JAX
  package's float32 bit for bit on 2000 energies from 1 to 100 keV for Be,
  C, Si, W and Au (the JAX side in a subprocess with x64 off, at XLA O0:
  at O1 and above XLA:CPU contracts the table interpolation's
  multiply-add into an FMA, and f1 then differs at ~12% of the energies);
  the port's earlier formula, (CH / E) ** 2 with a reciprocal and a
  complex division by the mass, differed at 28-54% of them.
* The mirror kinds' float32 Fresnel amplitude: squaring by products moves
  none of its bits (its differences from the JAX package, ~2e-7, come from
  the complex division and square root), so its formula stays.
* A tabulated refractive index (``refractiveIndexFile``) against the JAX
  package and ``tests/test_materials.py``'s values.
* ``Multilayer`` (periodic and graded), ``Coated`` and a transmitting
  multilayer against the JAX package to 1e-10 of the largest amplitude,
  float64; against ``tests/golden/ref_materials.npz`` at the limits of
  ``tests/test_materials.py`` (the transmitted golden is NaN, from an
  infinitely thick substrate, in xrt as in both packages).
* A [W/Si]x40 multilayer mirror (``examples/10_multilayer.py``) reflects
  as the JAX package does to 1e-9, and ``run_ray_tracing`` of both
  packages fills the same histograms to 1e-9 of their totals.
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
from xrt_tpu import plotspec as jps, runner as jrunner
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu_torch import materials as tm, oes as to
from xrt_tpu_torch import plotspec as tps, runner as trunner
from xrt_tpu_torch.physconsts import AVOGADRO, CH, PI2, R0
from xrt_tpu_torch.screens import Screen
from test_torch_dcm import compare, jax_beam, port_beam, rays_np

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
GOLDEN = 'tests/golden/ref_materials.npz'
ELEMENTS = [('Be', 1.848), ('C', 3.52), ('Si', 2.33), ('W', 19.3),
            ('Au', 19.3)]

JAX_F32 = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
import xrt_tpu.materials as jm
a = dict(np.load(IN))
out = {}
for el, rho in ELEMENTS:
    n = np.asarray(jm.Material.create(el, rho=rho).get_refractive_index(
        jnp.asarray(a['E'])))
    out[el + '_n'] = n
for el, rho, kind in MIRRORS:
    m = jm.Material.create(el, rho=rho, kind=kind,
                           t=5e-5 if kind == 'thin mirror' else None)
    rs, rp = m.get_amplitude(jnp.asarray(a['Em']), jnp.asarray(a['bm']))[:2]
    out[el + kind + '_s'] = np.asarray(rs)
    out[el + kind + '_p'] = np.asarray(rp)
np.savez(OUT, **out)
print('OK')
'''
MIRRORS = [('Au', 19.3, 'mirror'), ('Rh', 12.41, 'mirror'),
           ('Au', 19.3, 'thin mirror')]


@pytest.fixture(scope='module')
def jax32(clean_env_runner, tmp_path_factory):
    """The JAX package's float32 refractive indices and mirror amplitudes,
    from a subprocess with x64 off at XLA O0."""
    d = tmp_path_factory.mktemp('f32')
    E = np.linspace(1000.0, 100000.0, 2000).astype(np.float32)
    rng = np.random.RandomState(0)
    Em = rng.uniform(1000, 30000, 4000).astype(np.float32)
    bm = (-np.sin(rng.uniform(1e-3, 2e-2, 4000))).astype(np.float32)
    np.savez(d / 'in.npz', E=E, Em=Em, bm=bm)
    code = JAX_F32.replace('IN', repr(str(d / 'in.npz'))).replace(
        'OUT', repr(str(d / 'out.npz'))).replace(
        'ELEMENTS', repr(ELEMENTS)).replace('MIRRORS', repr(MIRRORS))
    out, _ = clean_env_runner(code, timeout=300, f32=True)
    assert 'OK' in out
    return dict(E=E, Em=Em, bm=bm, **np.load(d / 'out.npz'))


def _differ(a, b):
    return int(np.sum((a.real != b.real) | (a.imag != b.imag)))


@pytest.mark.parametrize('el,rho', ELEMENTS)
def test_refractive_index_float32_equals_jax_bits(jax32, el, rho):
    m = tm.Material.create(el, rho=rho, dtype=torch.float32, device='cpu')
    n = m.get_refractive_index(torch.from_numpy(jax32['E'])).numpy()
    ref = jax32[el + '_n']
    assert n.dtype == ref.dtype == np.complex64
    assert _differ(n, ref) == 0


@pytest.mark.parametrize('el,rho', ELEMENTS)
def test_earlier_refractive_formula_differed(jax32, el, rho):
    """The formula the port had: CH / E as a reciprocal times CH, a
    complex pow and a complex division by the mass."""
    m = tm.Material.create(el, rho=rho, dtype=torch.float32, device='cpu')
    E = torch.from_numpy(jax32['E'])
    xf = torch.zeros(E.shape, dtype=torch.complex64)
    for elem, xi in zip(m.elements, m.quantities):
        xf = xf + (elem.Z + elem.get_f1f2(E)) * xi
    old = (1 - 1e-24 * AVOGADRO * R0 / PI2 * (CH / E) ** 2 * m.rho * xf /
           m.mass).numpy()
    nold = _differ(old, jax32[el + '_n'])
    print(f'{el}: the earlier formula differs from the JAX package at '
          f'{nold} of 2000 energies, the port at 0')
    assert nold > 200


def test_mirror_amplitude_float32_keeps_its_formula(jax32):
    """Squaring n1 / n2 and rs, rp by products in place of ``** 2`` leaves
    every float32 amplitude as it is; both stay within 3e-7 of the JAX
    package's largest amplitude (the complex division and square root of
    the two libraries round differently), 2e-5 for the thin mirror."""
    from xrt_tpu_torch.physconsts import CHBAR
    E = torch.from_numpy(jax32['Em'])
    b = torch.from_numpy(jax32['bm'])
    for el, rho, kind in MIRRORS:
        m = tm.Material.create(el, rho=rho, kind=kind, dtype=torch.float32,
                               device='cpu',
                               t=5e-5 if kind == 'thin mirror' else None)
        kept = m.get_amplitude(E, b)[:2]
        # the same amplitude with its squares taken by products
        n = m.get_refractive_index(E)
        one = torch.ones_like(n)
        r12 = one / n
        q = r12 * r12 * torch.clamp(1 - b ** 2, min=0.0)
        cosBeta = torch.sqrt(torch.complex(1 - q.real, -q.imag))
        cosA = torch.abs(b)
        rs = (one * cosA - n * cosBeta) / (one * cosA + n * cosBeta)
        rp = (n * cosA - one * cosBeta) / (n * cosA + one * cosBeta)
        if kind == 'thin mirror':
            arg = 2 * E / CHBAR * (n * cosBeta) * m.t * 1e7
            p2 = torch.exp(torch.complex(-arg.imag, arg.real))
            rs = rs * (1 - p2) / (1 - rs * rs * p2)
            rp = rp * (1 - p2) / (1 - rp * rp * p2)
        limit = 2e-5 if kind == 'thin mirror' else 3e-7
        for pol, k, p in zip('sp', kept, (rs, rp)):
            ref = jax32[f'{el}{kind}_{pol}']
            nk, nprod = _differ(k.numpy(), ref), _differ(p.numpy(), ref)
            print(f'{el} {kind} {pol}: differ from the JAX package at {nk} '
                  f'(kept) / {nprod} (products) of 4000')
            assert nk <= nprod
            assert np.abs(k.numpy() - ref).max() < limit * \
                np.abs(ref).max()


def test_refractive_index_file(tmp_path):
    fn = str(tmp_path / 'ri.csv')
    with open(fn, 'w') as f:
        f.write('"Photon energy, eV","n","k"\n')
        f.write('1000,0.999,1e-5\n')
        f.write('2000,,2e-5\n')
        f.write('3000,0.9995,3e-5\n')
    E = np.array([900., 1000., 1500., 2000., 2500., 3000., 3500.])
    t = tm.Material.create('Si', rho=2.33, kind='plate',
                           refractiveIndexFile=fn, **KW)
    j = jm.Material.create('Si', rho=2.33, kind='plate',
                           refractiveIndexFile=fn)
    n = t.get_refractive_index(torch.from_numpy(E)).numpy()
    np.testing.assert_array_equal(n, np.asarray(j.get_refractive_index(E)))
    assert abs(n[1] - (0.999 + 1e-5j)) < 1e-12
    assert abs(n[3] - (0.99925 + 2e-5j)) < 1e-9
    En, nn = tm.Material.read_ri_file(fn)
    np.testing.assert_array_equal(En, [1000., 3000.])


def _layers(mod, **kw):
    return (mod.Material.create('Si', rho=2.33, **kw),
            mod.Material.create('W', rho=19.3, **kw))


ML_CASES = {
    'periodic': lambda mod, si, w, kw: mod.Multilayer.create(
        si, 27, w, 18, 40, si, **kw),
    'graded': lambda mod, si, w, kw: mod.Multilayer.create(
        si, 45, w, 27, 100, si, tThicknessLow=9, bThicknessLow=5.4,
        idThickness=3.0, **kw),
    'graded_class': lambda mod, si, w, kw: mod.GradedMultilayer.create(
        si, 30, w, 20, 20, si, tThicknessLow=20, bThicknessLow=12, **kw),
    'coated': lambda mod, si, w, kw: mod.Coated(
        coating=w, cThickness=300, surfaceRoughness=4.0, substrate=si,
        substRoughness=2.0, **kw),
    'transmitted': lambda mod, si, w, kw: mod.Multilayer.create(
        si, 27, w, 18, 10, si, substThickness=2e4, idThickness=2.0,
        geom='transmitted', **kw),
    'transmitted_free': lambda mod, si, w, kw: mod.Multilayer.create(
        tLayer=si, tThickness=30, bLayer=w, bThickness=20, nPairs=15,
        geom='transmitted', substThickness=0.0, **kw),
}


@pytest.mark.parametrize('case', sorted(ML_CASES))
def test_multilayer_matches_jax(case):
    theta = np.linspace(0.1, 4.0, 300)
    E = np.full(theta.shape, 8050.0)
    E[::3] = 17000.0
    s = np.sin(np.radians(theta))
    tsi, tw = _layers(tm, **KW)
    jsi, jw = _layers(jm)
    t = ML_CASES[case](tm, tsi, tw, KW)
    j = ML_CASES[case](jm, jsi, jw, {})
    got = t.get_amplitude(torch.from_numpy(E), torch.from_numpy(s))
    ref = j.get_amplitude(jnp.asarray(E), jnp.asarray(s))
    for g, r in zip(got[:2], ref[:2]):
        r = np.asarray(r)
        assert np.isfinite(r).all()
        assert np.abs(g.numpy() - r).max() < 1e-10 * np.abs(r).max(), case
    assert t.resolved_kind() == j.resolved_kind()
    np.testing.assert_allclose(float(t.d), float(j.d), rtol=1e-15)


def test_multilayer_angles_match_jax():
    tsi, tw = _layers(tm, **KW)
    jsi, jw = _layers(jm)
    t = tm.Multilayer.create(tsi, 27, tw, 18, 40, tsi, **KW)
    j = jm.Multilayer.create(jsi, 27, jw, 18, 40, jsi)
    E = np.linspace(6000, 20000, 50)
    for name in ('get_Bragg_angle', 'get_dtheta'):
        got = getattr(t, name)(torch.from_numpy(E)).numpy()
        ref = np.asarray(getattr(j, name)(jnp.asarray(E)))
        np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.fixture(scope='module')
def ref():
    return np.load(GOLDEN)


def test_multilayer_goldens(ref):
    """``tests/test_materials.py``'s multilayer, graded and coated
    goldens at its limits."""
    theta = ref['mlWSi_theta_deg']
    E = torch.full(theta.shape, 8050., dtype=F64)
    s = torch.from_numpy(np.sin(np.deg2rad(theta)))
    si, w = _layers(tm, **KW)
    for ml, key in ((tm.Multilayer.create(si, 27, w, 18, 40, si, **KW),
                     'mlWSi'),
                    (tm.Multilayer.create(si, 45, w, 27, 100, si,
                                          tThicknessLow=9, bThicknessLow=5.4,
                                          **KW), 'mlWSigraded'),
                    (tm.Coated(coating=w, cThickness=300, substrate=si,
                               **KW), 'coatedW')):
        rs, rp = ml.get_amplitude(E, s)[:2]
        np.testing.assert_allclose(rs.numpy()[1:], ref[key + '_rs'][1:],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(rp.numpy()[1:], ref[key + '_rp'][1:],
                                   rtol=1e-5, atol=1e-7)


def test_multilayer_transmitted_golden(ref):
    th = ref['mltScCr_theta_deg']
    mSc = tm.Material.create('Sc', rho=2.98, table='Chantler', **KW)
    mCr = tm.Material.create('Cr', rho=7.18, table='Chantler', **KW)
    mLt = tm.Multilayer.create(tLayer=mSc, tThickness=15.48, bLayer=mCr,
                               bThickness=15.72, nPairs=100,
                               geom='transmitted', **KW)
    ts, tp = mLt.get_amplitude(torch.full(th.shape, 398.0, dtype=F64),
                               torch.from_numpy(np.sin(np.deg2rad(th))))[:2]
    np.testing.assert_allclose(ts.numpy(), ref['mltScCr_ts'], rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(tp.numpy(), ref['mltScCr_tp'], rtol=1e-7,
                               atol=1e-9)


# ---- the multilayer mirror of examples/10_multilayer.py -------------------

ML_E0, ML_P, ML_Q = 8050.0, 10000.0, 2000.0


def ml_peak_angle(mod, ml, E=ML_E0):
    """The peak of the Parratt reflectivity around the first Bragg angle
    of the d = 45 A period (as the example finds it)."""
    theta0 = math.asin(CH / E * 1e-7 / (2 * 45.0e-7))
    thetas = np.linspace(0.9 * theta0, 1.4 * theta0, 201)
    if mod is tm:
        R = np.abs(ml.get_amplitude(torch.full(thetas.shape, E, dtype=F64),
                                    torch.from_numpy(np.sin(thetas)))[0]
                   .numpy()) ** 2
    else:
        R = np.abs(np.asarray(ml.get_amplitude(
            jnp.full(thetas.shape, E), jnp.sin(jnp.asarray(thetas)))[0]))**2
    return float(thetas[int(np.argmax(R))])


def ml_rays(n=600, seed=5):
    d = rays_np(n, seed=seed, dE=0.0, div=0.0)
    rng = np.random.RandomState(seed + 1)
    c = rng.uniform(-1.5e-3, 1.5e-3, n) * 0.0202
    a = rng.normal(0, 1e-5, n)
    d.update(E=np.full(n, ML_E0), a=a, c=c, b=np.sqrt(1 - a * a - c * c))
    return d


def ml_line(mod, **kw):
    si, w = _layers(mod, **kw)
    ml = mod.Multilayer.create(si, 27.0, w, 18.0, 40, si, **kw)
    thetaB = ml_peak_angle(mod, ml)
    mirror = (jo if mod is jm else to).FlatMirror.create(
        center=(0, ML_P, 0), pitch=thetaB, material=ml, limPhysX=(-10, 10),
        limPhysY=(-60, 60))
    return ml, mirror, thetaB


def test_multilayer_mirror_reflect_matches_jax():
    d = ml_rays()
    _, jmir, jth = ml_line(jm)
    _, tmir, tth = ml_line(tm, **KW)
    assert jth == tth
    jg, jl = jax.jit(lambda b: jmir.reflect(b))(jax_beam(d))
    tg, tl = tmir.reflect(port_beam(d))
    compare(tg, jg)
    compare(tl, jl)
    # the traced reflectivity is the material's own at the rays' angles
    good = tg.state.numpy() == 1
    assert good.mean() > 0.99
    R = (tg.Jss + tg.Jpp).numpy()[good]
    ml = tmir.material
    E = torch.full((int(good.sum()),), ML_E0, dtype=F64)
    rs = ml.get_amplitude(E, torch.sin(tl.theta)[torch.from_numpy(good)]
                          .abs())[0]
    np.testing.assert_allclose(R, (rs.abs() ** 2).numpy(), rtol=1e-9)
    assert R.max() > 0.5


def trace_both(jax_process, port_process, axes, repeats=2):
    """``run_ray_tracing`` of both packages with one plot of fixed limits
    (*axes*: x, y and colour ``XYCAxis`` keywords) over *repeats* passes
    of the same rays; each histogram equal to 1e-9 of its total."""
    def plot(mod):
        return mod.XYCPlot(beam='screen', xaxis=mod.XYCAxis(**axes[0]),
                           yaxis=mod.XYCAxis(**axes[1]),
                           caxis=mod.XYCAxis(**axes[2]))
    jp, tp = plot(jps), plot(tps)
    jrunner.run_ray_tracing(jp, repeats=repeats, run_process=jax_process,
                            key=0)
    trunner.run_ray_tracing(tp, repeats=repeats, run_process=port_process,
                            rng=0, device='cpu')
    assert tp.nRaysAll == jp.nRaysAll and tp.nRaysGood == jp.nRaysGood
    total = float(jp.intensity)
    assert total > 0
    assert abs(tp.intensity - total) < 1e-9 * total
    for k in ('total1D_x', 'total1D_y', 'total1D_c', 'total2D',
              'total2D_RGB'):
        r = np.asarray(getattr(jp, k))
        g = np.asarray(getattr(tp, k))
        assert g.shape == r.shape, k
        assert np.abs(g - r).max() < 1e-9 * total, k
    return jp, tp


def test_multilayer_trace_matches_jax():
    d = ml_rays(400, seed=7)
    _, jmir, th = ml_line(jm)
    _, tmir, _ = ml_line(tm, **KW)
    scr = dict(center=(0, ML_P + ML_Q, 2 * th * ML_Q))
    jscr, tscr = JScreen.create(**scr), Screen.create(**scr)

    def jproc(bl, key):
        return {'screen': jscr.expose(jmir.reflect(jax_beam(d))[0])}

    def tproc(bl, rng):
        return {'screen': tscr.expose(tmir.reflect(port_beam(d))[0])}
    trace_both(jproc, tproc, (
        dict(label='x', unit='mm', bins=16, limits=[-0.5, 0.5]),
        dict(label='z', unit='mm', bins=24, limits=[-0.3, 0.3]),
        dict(label="z'", unit='mrad', bins=16, limits=[40.0, 41.0])))
