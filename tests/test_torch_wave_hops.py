"""The port's one-call wave hops and the BASELINE configurations 5, 2 and 3
against the JAX package, float64 (the JAX package eagerly, under
``jax.disable_jit()``, where the wave chain holds 1e-9).

* ``propagate_wave_to_aperture`` from a source (the filament field shone at
  the samples, ``wave=None`` with ``fixedEnergy``) and from an aperture
  (a Kirchhoff hop), ``propagate_wave_to_oe`` onto a zone plate (diffract,
  then ``reflect_wave``: the 'FZP' kind's grating deflection) and
  ``expose_wave_on_screen``, and the methods ``propagate_wave`` of an
  aperture and of an OE and ``Screen.expose_wave``: the port is given the
  JAX package's receiver samples (``samples=``; the JAX package draws them
  from its keys), and every field it fills agrees to 1e-9 of its largest
  magnitude; ``qualify_sampling`` to 1e-12.
* BASELINE configuration 5 (``tests/test_baseline_configs.py``): undulator
  filament -> 80 um slit (900 samples) -> Au zone plate (4000 samples, the
  zone mask) -> 161-point focal line, on the JAX package's samples and
  e-beam draws: the focal intensity to 1e-9 of its peak, the open
  fraction in 0.2-0.8 and the focal concentration (centre > 5 x the outer
  mean), through ``diffract`` and through ``Screen.expose_wave``.
* BASELINE configuration 2: bending magnet -> Rh toroid -> slit -> screen
  at 8000 rays on the JAX package's draws: the footprint to 1e-9 of the
  mirror's scale, the intensities to 1e-8 (the bending magnet's Bessel
  functions, ``tests/test_torch_synchrotron.py``), the same rays lost, and
  the JAX test's limits (std x < 0.3 mm, z < 0.1 mm).
* BASELINE configuration 3: undulator (3000 rays) -> Si(111) DCM on the
  JAX package's draws (JAX under ``jax.jit``): the exit beam to 1e-9, and
  the JAX test's limits (transmitted band < 10 eV, the fixed exit
  parallel to the incoming beam to 1e-9).  With configurations 1
  (``tests/test_torch_trace.py``) and 4 (``tests/test_torch_beamline.py``)
  every configuration of ``tests/test_baseline_configs.py`` has its
  counterpart in the port.
"""
import torch_harness  # noqa: F401

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
from xrt_tpu import waves as jw
from xrt_tpu.apertures import RectangularAperture as JSlit
from xrt_tpu.oes import NormalFZP as JFZP, ToroidMirror as JToroid
from xrt_tpu.physconsts import CH
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu.sources import BendingMagnet as JBM, Undulator as JUndulator
from xrt_tpu_torch import materials as tm, waves as tw
from xrt_tpu_torch.apertures import RectangularAperture
from xrt_tpu_torch.oes import NormalFZP, ToroidMirror
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import BendingMagnet, Undulator

F64 = torch.float64
CPU = dict(dtype=F64, device='cpu')
E0 = 9000.0
F_FZP = 2000.0
#: tests/test_baseline_configs.py's undulator, for configuration 5
UND = dict(nrays=100, eE=3.0, eI=0.5, period=18.0, n=111, targetE=(E0, 7),
           eEpsilonX=0.263, eEpsilonZ=0.008, betaX=9.0, betaZ=2.0,
           xPrimeMax=0.02, zPrimeMax=0.02, gNodes=64, eMin=E0 - 1,
           eMax=E0 + 1)
SLIT = dict(center=(0, 25000.0, 0), opening=(-0.04, 0.04, -0.04, 0.04))
FZP = dict(f=F_FZP, E=E0, N=60, center=(0, 27000.0, 0), pitch=math.pi / 2,
           order=1)
RN = math.sqrt(60 * F_FZP * CH / E0 * 1e-7)


def fzp_pair():
    return (NormalFZP.create(material=tm.Material.create(
        'Au', rho=19.3, kind='FZP', **CPU), **FZP),
        JFZP.create(material=jm.Material.create('Au', rho=19.3, kind='FZP'),
                    **FZP))


def close(t, j, fields, tol=1e-9):
    for f in fields:
        jv = np.asarray(getattr(j, f))
        tv = getattr(t, f).numpy()
        scale = max(float(np.abs(jv).max()), 1e-300)
        assert np.abs(tv - jv).max() / scale < tol, f


def _local_samples(w, *names):
    return tuple(np.asarray(getattr(w, n)) for n in names)


def test_one_call_hops_match_jax():
    """Source -> slit (filament shine), slit -> slit (Kirchhoff), slit ->
    zone plate (Kirchhoff and reflect), zone plate -> screen, through the
    functions and through the elements' methods."""
    und_kw = dict(UND, eEpsilonX=0.0, eEpsilonZ=0.0)   # no draws
    und, jund = Undulator.create(**und_kw, **CPU), JUndulator.create(**und_kw)
    slit, jslit = RectangularAperture.create(**SLIT), JSlit.create(**SLIT)
    s2kw = dict(center=(0, 25500.0, 0), opening=(-0.03, 0.05, -0.05, 0.03))
    slit2, jslit2 = RectangularAperture.create(**s2kw), JSlit.create(**s2kw)
    fzp, jfzp = fzp_pair()
    scr_kw = dict(center=(0, 27000.0 + F_FZP, 0))
    scr, jscr = Screen.create(**scr_kw), JScreen.create(**scr_kw)
    dim1 = np.linspace(-0.2 * RN, 0.2 * RN, 7)
    dim2 = np.linspace(-0.1 * RN, 0.1 * RN, 5)
    wave_fields = ('Es', 'Ep', 'Jss', 'Jpp', 'a', 'b', 'c')
    with jax.disable_jit():
        # the JAX package's hops, and the samples it draws in them
        ka = jax.random.PRNGKey(11)
        ja = jw.propagate_wave_to_aperture(jslit, None, nrays=300, key=ka,
                                           fixedEnergy=E0, prevOE=jund)
        jsa = jw.prepare_wave_on_aperture(jslit, jund, 300,
                                          key=jax.random.split(ka)[0])
        kb = jax.random.PRNGKey(12)
        jb = jw.propagate_wave_to_aperture(jslit2, ja, key=kb)
        jsb = jw.prepare_wave_on_aperture(jslit2, jslit, 300,
                                          key=jax.random.split(kb)[0])
        kc = jax.random.PRNGKey(13)
        jcg, jcl = jw.propagate_wave_to_oe(jfzp, ja, nrays=500, key=kc)
        jsc = jw.prepare_wave_on_oe(jfzp, jslit, 500,
                                    key=jax.random.split(kc)[0])
        jd = jw.expose_wave_on_screen(jscr, jcl, dim1, dim2, prevOE=jfzp)
        jfn, jgood = jw.qualify_sampling(jd, E0, 35.0)
    a = tw.propagate_wave_to_aperture(
        slit, None, prevOE=und, fixedEnergy=E0,
        samples=_local_samples(jsa, 'x', 'z'), **CPU)
    close(a, ja, wave_fields)
    a_m = slit.propagate_wave(None, prevOE=und, fixedEnergy=E0,
                              samples=_local_samples(jsa, 'x', 'z'), **CPU)
    assert torch.equal(a_m.Es, a.Es)
    b = slit2.propagate_wave(a, samples=_local_samples(jsb, 'x', 'z'))
    close(b, jb, wave_fields)
    cg, cl = fzp.propagate_wave(a, samples=_local_samples(jsc, 'x', 'y',
                                                          'z'))
    close(cl, jcl, ('Es', 'Ep', 'Jss', 'Jpp', 'a', 'b', 'c', 'order'))
    close(cg, jcg, ('a', 'b', 'c', 'Jss', 'Jpp'))
    assert cl.area is not None
    np.testing.assert_array_equal(cl.state.numpy(), np.asarray(jcl.state))
    d = scr.expose_wave(cl, dim1, dim2, prevOE=fzp)
    close(d, jd, wave_fields)
    fn, good = tw.qualify_sampling(d, E0, 35.0)
    np.testing.assert_allclose(float(fn), float(jfn), rtol=1e-12)
    np.testing.assert_allclose(float(good), float(jgood), rtol=1e-12)
    with pytest.raises(ValueError, match='toOE'):
        scr.expose_wave(cg, dim1, dim2)


def config5_jax():
    """The JAX test's configuration 5, float64, with its keys: (slit wave,
    FZP samples, open fraction, focal z and intensity, the e-beam draws of
    the filament)."""
    with jax.disable_jit():
        und = JUndulator.create(**UND)
        slit = JSlit.create(**SLIT)
        wave_slit = jw.prepare_wave_on_aperture(slit, und, 900,
                                                key=jax.random.PRNGKey(5))
        wave_slit = und.shine_wave(jax.random.PRNGKey(6), wave_slit,
                                   fixedEnergy=E0)
        _, fzp = fzp_pair()
        wave_fzp = jw.prepare_wave_on_oe(fzp, slit, 4000,
                                         key=jax.random.PRNGKey(7))
        src = wave_slit.replace(state=jnp.ones_like(wave_slit.state))
        wave_fzp = jw.diffract(src, wave_fzp)
        state = fzp.rays_good(wave_fzp.x, wave_fzp.y,
                              jnp.ones_like(wave_fzp.state))
        masked = wave_fzp.replace(state=state)
        screen = JScreen.create(center=(0, 27000.0 + F_FZP, 0))
        zs = np.linspace(-0.2 * RN, 0.2 * RN, 161)
        focus = jw.prepare_wave_on_screen(screen, fzp, np.asarray([0.0]), zs)
        out = jw.diffract(masked, focus)
    draws = [float(jax.random.normal(k, (), jnp.float64))
             for k in jax.random.split(jax.random.PRNGKey(6), 5)]
    return dict(slit=_local_samples(wave_slit, 'x', 'z'),
                fzp=_local_samples(wave_fzp, 'x', 'y', 'z'),
                Es_slit=np.asarray(wave_slit.Es), open=np.asarray(state),
                z=np.asarray(out.z), I=np.asarray(out.Jss + out.Jpp),
                draws=draws, zs=zs)


def test_config5_focal_intensity_matches_jax():
    ref = config5_jax()
    und = Undulator.create(**UND, **CPU)
    slit = RectangularAperture.create(**SLIT)
    fzp, _ = fzp_pair()
    wave_slit = tw.prepare_wave_on_aperture(slit, und, None,
                                            samples=ref['slit'], **CPU)
    wave_slit = und.shine_wave(None, wave_slit, E0, draws=ref['draws'])
    np.testing.assert_allclose(
        wave_slit.Es.numpy(), ref['Es_slit'], rtol=0,
        atol=1e-9 * np.abs(ref['Es_slit']).max())
    wave_fzp = tw.prepare_wave_on_oe(fzp, slit, None, samples=ref['fzp'],
                                     **CPU)
    src = wave_slit.replace(state=torch.ones_like(wave_slit.state))
    wave_fzp = tw.diffract(src, wave_fzp)
    state = fzp.rays_good(wave_fzp.x, wave_fzp.y,
                          torch.ones_like(wave_fzp.state))
    np.testing.assert_array_equal(state.numpy(), ref['open'])
    frac_open = float(torch.mean((state == 1).double()))
    assert 0.2 < frac_open < 0.8
    masked = wave_fzp.replace(state=state)
    screen = Screen.create(center=(0, 27000.0 + F_FZP, 0))
    focus = tw.prepare_wave_on_screen(screen, fzp, np.asarray([0.0]),
                                      ref['zs'], **CPU)
    out = tw.diffract(masked, focus)
    via_method = screen.expose_wave(masked, np.asarray([0.0]), ref['zs'])
    for o in (out, via_method):
        I = (o.Jss + o.Jpp).numpy()
        assert np.abs(I - ref['I']).max() < 1e-9 * ref['I'].max()
    zc = out.z.numpy()
    center = I[np.abs(zc) < 0.02 * RN].max()
    outer = I[np.abs(zc) > 0.1 * RN].mean()
    assert center > 5 * outer


def bm_draws(key, nrays, M):
    keys = jax.random.split(key, 10)
    dt = jnp.float64
    k1, k2 = jax.random.split(keys[8])
    d = dict(E=jax.random.uniform(keys[0], (M,), dt),
             theta=jax.random.uniform(keys[1], (M,), dt),
             psi=jax.random.uniform(keys[2], (M,), dt),
             choice=jax.random.uniform(keys[4], (nrays,), dt),
             smear=jax.random.normal(keys[6], (nrays,), dt),
             z=jax.random.normal(k1, (nrays,), dt),
             x=jax.random.normal(k2, (nrays,), dt))
    return {k: np.array(v) for k, v in d.items()}


#: tests/test_baseline_configs.py's configuration 2
C2_P, C2_Q, C2_PITCH = 15000.0, 5000.0, 5e-3
C2_BM = dict(nrays=8000, eE=3.0, eI=0.5, B0=1.7, eEpsilonX=0.0,
             eEpsilonZ=0.0, eMin=E0 - 50, eMax=E0 + 50, xPrimeMax=0.2e-3,
             zPrimeMax=0.1e-3)


def config2_elements(pkg):
    p, q, pitch = C2_P, C2_Q, C2_PITCH
    R = 2 * p * q / (p + q) / math.sin(pitch)
    r = 2 * p * q / (p + q) * math.sin(pitch)
    tor_kw = dict(center=(0, p, 0), pitch=pitch, R=R, r=r,
                  limPhysX=(-15, 15), limPhysY=(-400, 400))
    slit_kw = dict(center=(0, p + 1000.0, 2 * pitch * 1000.0),
                   opening=(-5.0, 5.0, -5.0, 5.0))
    scr_kw = dict(center=(0, p + q, 2 * pitch * q))
    if pkg == 'jax':
        return (JBM.create(**C2_BM), JToroid.create(
            material=jm.Material.create('Rh', rho=12.41), **tor_kw),
            JSlit.create(**slit_kw), JScreen.create(**scr_kw))
    return (BendingMagnet.create(**C2_BM, **CPU), ToroidMirror.create(
        material=tm.Material.create('Rh', rho=12.41, **CPU), **tor_kw),
        RectangularAperture.create(**slit_kw), Screen.create(**scr_kw))


def test_config2_footprint_matches_jax():
    jbm, jtor, jslit, jscr = config2_elements('jax')
    bm, tor, slit, scr = config2_elements('port')
    key = jax.random.PRNGKey(1)

    def jrun(k):
        glo, _ = jtor.reflect(jbm.shine(k))
        glo, _ = jslit.propagate(glo, needNewGlobal=True)
        return glo, jscr.expose(glo)
    jglo, jimg = jax.jit(jrun)(key)
    beam = bm.shine(None, draws=bm_draws(key, 8000, 16000))
    glo, _ = tor.reflect(beam)
    glo, _ = slit.propagate(glo, needNewGlobal=True)
    img = scr.expose(glo)
    np.testing.assert_array_equal(glo.state.numpy(), np.asarray(jglo.state))
    good = glo.state.numpy() == 1
    assert good.sum() > 1000
    for f in ('x', 'z'):
        t, j = getattr(img, f).numpy(), np.asarray(getattr(jimg, f))
        assert np.abs(t - j)[good].max() < 1e-9 * 400.0, f
    for f in ('Jss', 'Jpp'):
        t, j = getattr(img, f).numpy(), np.asarray(getattr(jimg, f))
        assert np.abs(t - j).max() < 1e-8 * np.abs(j).max(), f
    x, z = img.x.numpy()[good], img.z.numpy()[good]
    assert x.std() < 0.3 and z.std() < 0.1


def und_draws(key, nrays, M, dt=jnp.float64):
    """The draws of the JAX package's undulator ``shine`` from *key*."""
    keys = jax.random.split(key, 10)
    k1, k2 = jax.random.split(keys[8])
    d = dict(E=jax.random.uniform(keys[0], (M,), dt),
             theta=jax.random.uniform(keys[1], (M,), dt),
             psi=jax.random.uniform(keys[2], (M,), dt),
             choice=jax.random.uniform(keys[4], (nrays,), dt),
             dtheta=jax.random.normal(keys[5], (nrays,), dt),
             dpsi=jax.random.normal(keys[7], (nrays,), dt),
             x=jax.random.normal(k1, (nrays,), dt),
             z=jax.random.normal(k2, (nrays,), dt))
    return {k: np.array(v) for k, v in d.items()}


def test_config3_undulator_dcm_matches_jax():
    from xrt_tpu.oes.dcm import DCM as JDCM
    from xrt_tpu_torch.oes import DCM
    kw = dict(UND, nrays=3000, eMin=E0 - 40, eMax=E0 + 40)
    dcm_kw = dict(center=(0, 30000.0, 0), alignE=E0, fixedOffset=20.0,
                  limPhysX=(-50, 50), limPhysY=(-500, 500))
    jund = JUndulator.create(**kw)
    jdcm = JDCM.create(material=jm.CrystalSi.create(hkl=(1, 1, 1)),
                       **dcm_kw)
    key = jax.random.PRNGKey(2)

    def jrun(k):
        beam = jund.shine(k)
        return beam, jdcm.double_reflect(beam)[0]
    _, jmono = jax.jit(jrun)(key)
    und = Undulator.create(**kw, **CPU)
    dcm = DCM.create(material=tm.CrystalSi.create(hkl=(1, 1, 1), **CPU),
                     **dcm_kw)
    beam = und.shine(None, draws=und_draws(key, 3000, 3000 *
                                           und.oversample))
    mono = dcm.double_reflect(beam)[0]
    np.testing.assert_array_equal(mono.state.numpy(),
                                  np.asarray(jmono.state))
    for f in ('x', 'z', 'a', 'b', 'c', 'E', 'Jss', 'Jpp'):
        t, j = getattr(mono, f).numpy(), np.asarray(getattr(jmono, f))
        scale = max(float(np.abs(j).max()), 1.0 if f in 'xz' else 1e-300)
        assert np.abs(t - j).max() / scale < 1e-9, f
    I = (mono.Jss + mono.Jpp).numpy()
    good = (mono.state.numpy() == 1) & (I > 1e-3 * I.max())
    assert good.sum() > 100
    E = mono.E.numpy()
    assert np.sqrt(np.cov(E[good], aweights=I[good])) < 10.0
    np.testing.assert_allclose(mono.b.numpy()[good], beam.b.numpy()[good],
                               atol=1e-9)
