"""The SoftiMAX slice as a whole: ``tools/torch_bench_softimax.py`` against
xrt's golden run (``tests/golden/ref_softimax.npz``) and against the JAX
package's chain (``tools/bench_softimax.py``), float64 on the CPU.

* The deterministic chain, fed at every hop with xrt's own receiver
  samples, against xrt's stored fields: overlap > 0.999 at every hop and at
  the focus, per-hop mean amplitude within 5%, focal flux within 15% (the
  assertions of ``tests/test_softimax_chain.py``'s deterministic test).
* The same hops through the JAX package, eagerly (``jax.disable_jit()``:
  under jit XLA contracts products into FMAs and moves the float64 chain
  by ~5e-7), on elements made from the same ``create`` arguments: the
  port's field at each hop to 1e-8 of its largest magnitude.
* The end-to-end chain on the JAX chain's own random receiver samples
  (``bench_softimax.build_chain``'s draws): focal flux within (0.6, 1.6)
  of xrt's, the contrast within 50% of xrt's, the central plane the
  brightest (``tests/test_softimax_chain.py``'s bounds); and the images to
  1e-4 of their peak against the JAX chain's (jitted) images.
* float32 (the plain versions of B1 and B2) against float64 on the same
  float32-representable samples, overlap above the JAX test's floors at
  every hop (pg 0.7; m3, es, m4, m5 0.6; focus 0.55; 0.999 before the
  grating).
"""
import math
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
import bench_softimax as jbs  # noqa: E402
import torch_bench_softimax as tbs  # noqa: E402

GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'ref_softimax.npz')
F64 = torch.float64
HOPS = ('slit', 'wm1', 'm1', 'wm2', 'm2', 'wpg', 'pg', 'wm3', 'm3', 'es',
        'wm4', 'm4', 'wm5', 'm5', 'focus')
FLOORS = {'slit': 0.999, 'm1': 0.999, 'm2': 0.999, 'wpg': 0.999,
          'pg': 0.7, 'm3': 0.6, 'es': 0.6, 'm4': 0.6, 'm5': 0.6,
          'focus': 0.55}


@pytest.fixture(scope='module')
def ref():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope='module')
def port_det(ref):
    return tbs.deterministic_chain(ref, F64, 'cpu')


def overlap(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return abs(np.vdot(a, b)) / math.sqrt(np.vdot(a, a).real *
                                          np.vdot(b, b).real)


def jax_twins(t):
    """The JAX package's SoftiMAX elements made from the same create
    arguments as the port's (the port's placement: centres and yaws)."""
    import xrt_tpu.materials as xm
    from xrt_tpu.apertures import RectangularAperture
    from xrt_tpu.oes import (BlazedGrating, EllipticalMirrorParam,
                             FlatMirror, ToroidMirror)
    from xrt_tpu.screens import Screen
    from xrt_tpu.sources import Undulator
    mAu = xm.Material.create('Au', rho=19.32, kind='mirror')
    P = tbs

    def c(el):
        return tuple(float(v) for v in el.center)
    return dict(
        src=Undulator.create(
            nrays=2000, eE=3.0, eI=0.5, eEspread=0.0, eEpsilonX=0.0,
            eEpsilonZ=0.0, betaX=9.0, betaZ=2.0, period=48.0, n=77,
            targetE=(P.E0, 1), eMin=P.E0 - P.DE, eMax=P.E0 + P.DE,
            xPrimeMax=P.ACCEPT_H / 2 * 1e3, zPrimeMax=P.ACCEPT_V / 2 * 1e3,
            xPrimeMaxAutoReduce=False, zPrimeMaxAutoReduce=False,
            gNodes=402, gIntervals=2),
        slitFE=RectangularAperture.create(center=c(t['slitFE']),
                                          opening=[t['slitFE'].left,
                                                   t['slitFE'].right,
                                                   t['slitFE'].bottom,
                                                   t['slitFE'].top]),
        m1=ToroidMirror.create(center=c(t['m1']), pitch=P.PITCH,
                               positionRoll=math.pi / 2, R=1e22,
                               r=t['m1'].r, material=mAu, limPhysX=(-5, 5),
                               limPhysY=(-150, 150)),
        m2=FlatMirror.create(center=c(t['m2']), pitch=t['m2'].pitch,
                             yaw=t['m2'].yaw, material=mAu,
                             limPhysX=(-5, 5), limPhysY=(-225, 225)),
        pg=BlazedGrating.create(center=c(t['pg']), pitch=t['pg'].pitch,
                                yaw=t['pg'].yaw, positionRoll=math.pi,
                                blaze=P.BLAZE, rho=P.RHO_G, material=mAu,
                                limPhysX=(-2, 2), limPhysY=(-40, 40)),
        m3=ToroidMirror.create(center=c(t['m3']), pitch=P.PITCH,
                               yaw=t['m3'].yaw, positionRoll=-math.pi / 2,
                               R=1e22, r=t['m3'].r, material=mAu,
                               limPhysX=(-10, 10), limPhysY=(-100, 100)),
        exitSlit=RectangularAperture.create(
            center=c(t['exitSlit']),
            opening=[-P.ES_DX / 2, P.ES_DX / 2, -P.ES_DZ / 2, P.ES_DZ / 2],
            x=tuple(float(v) for v in t['exitSlit'].ex)),
        m4=EllipticalMirrorParam.create(
            center=c(t['m4']), p=43000.0, q=P.D_M45 + P.P_EXP,
            pitch=P.PITCH, yaw=t['m4'].yaw, positionRoll=math.pi / 2,
            isCylindrical=True, material=mAu, limPhysX=(-0.5, 0.5),
            limPhysY=(-70, 70)),
        m5=EllipticalMirrorParam.create(
            center=c(t['m5']), p=P.D_M4_ES + P.D_M45, q=P.P_EXP,
            pitch=P.PITCH, yaw=t['m5'].yaw, isCylindrical=True,
            material=mAu, limPhysX=(-0.5, 0.5), limPhysY=(-40, 40)),
        screens=[Screen.create(center=c(s)) for s in t['screens']])


def jax_det_chain(el, ref):
    """xrt's deterministic chain through the JAX package's functions,
    float64, hop by hop as tests/test_softimax_chain.py runs it."""
    from xrt_tpu.waves import (diffract, prepare_wave_on_aperture,
                               prepare_wave_on_oe, prepare_wave_on_screen,
                               reflect_wave)
    key = jax.random.PRNGKey(0)
    out = {}
    wSlit = prepare_wave_on_aperture(el['slitFE'], el['src'], 0,
                                     samples=(ref['slit_x'], ref['slit_z']))
    cur = el['src'].shine_wave(key, wSlit, tbs.E0)
    out['slit'] = cur.Es
    for oe_nm, prev in (('m1', 'slitFE'), ('m2', 'm1'), ('pg', 'm2'),
                        ('m3', 'pg'), ('es', 'm3'), ('m4', 'exitSlit'),
                        ('m5', 'm4')):
        if oe_nm == 'es':
            w = prepare_wave_on_aperture(el['exitSlit'], el[prev], 0,
                                         samples=(ref['es_x'], ref['es_z']))
            cur = diffract(cur, w, monochromatic=True)
            out['es'] = cur.Es
            continue
        w = prepare_wave_on_oe(el[oe_nm], el[prev], 0,
                               samples=(ref['w' + oe_nm + '_x'],
                                        ref['w' + oe_nm + '_y']))
        b = diffract(cur, w, monochromatic=True)
        out['w' + oe_nm] = b.Es
        _, cur = reflect_wave(el[oe_nm], b, key)
        if oe_nm == 'pg':
            x, y = ref['pg_x'], ref['pg_y']
            cur = cur.replace(area=jnp.asarray(
                (x.max() - x.min()) * (y.max() - y.min()) *
                float(ref['areaFraction'])))
        out[oe_nm] = cur.Es
    edges = np.linspace(-50, 50, int(ref['NSCR']) + 1)
    cent = (edges[:-1] + edges[1:]) * 0.5 / 1e3
    wF = prepare_wave_on_screen(el['screens'][1], el['m5'], cent, cent)
    out['focus'] = diffract(cur, wF, monochromatic=True).Es
    return {k: np.asarray(v) for k, v in out.items()}


def test_deterministic_chain_against_xrt(ref, port_det):
    for nm in HOPS:
        assert overlap(ref[nm + '_Es'], port_det[nm]) > 0.999, nm
    for nm in ('m1', 'm2', 'pg', 'm3', 'es'):
        amp = np.abs(port_det[nm]).mean() / np.abs(ref[nm + '_Es']).mean()
        assert abs(amp - 1) < 0.05, (nm, amp)
    assert abs(port_det['focus_J'].sum() / float(ref['flux_focus']) - 1) \
        < 0.15


def test_deterministic_hops_match_jax_f64(ref, port_det):
    el = jax_twins(tbs.beamline(F64, 'cpu'))
    with jax.disable_jit():
        exp = jax_det_chain(el, ref)
    # the port's fields are in absolute units (the rescaling undone), so
    # compare each hop up to one real scale: the JAX chain runs unscaled
    for nm in HOPS:
        g, e = port_det[nm], exp[nm]
        s = np.vdot(e, g).real / np.vdot(e, e).real
        assert abs(s - 1) < 1e-8, (nm, s)
        err = float(np.abs(g - e).max() / np.abs(e).max())
        assert err < 1e-8, (nm, err)


def jax_random_samples(jel, nrays=2000):
    """The receiver samples bench_softimax.build_chain draws (key 7, as its
    prepare() splits it), by receiving element, as numpy arrays."""
    from xrt_tpu.waves import prepare_wave_on_aperture, prepare_wave_on_oe
    ks = jax.random.split(jax.random.PRNGKey(7), 8)
    out = {}
    w = prepare_wave_on_aperture(jel['slitFE'], jel['src'], nrays,
                                 key=ks[0])
    out['slitFE'] = (np.asarray(w.x), np.asarray(w.z))
    prev = 'slitFE'
    for i, nm in enumerate(('m1', 'm2', 'pg', 'm3', 'exitSlit', 'm4', 'm5')):
        if nm == 'exitSlit':
            w = prepare_wave_on_aperture(jel[nm], jel[prev], nrays,
                                         key=ks[i + 1])
            out[nm] = (np.asarray(w.x), np.asarray(w.z))
        else:
            w = prepare_wave_on_oe(jel[nm], jel[prev], nrays, key=ks[i + 1],
                                   sort='y')
            out[nm] = (np.asarray(w.x), np.asarray(w.y), np.asarray(w.z))
        prev = nm
    return out


def test_end_to_end_chain_on_the_jax_draws(ref):
    jrc = jbs.build_chain(nrays=2000, n_scr=16)
    jimgs = jrc()
    rc = tbs.build_chain(nrays=2000, n_scr=16, dtype=F64, device='cpu',
                         samples=jax_random_samples(jrc.elements))
    imgs = rc()
    total = imgs[1].sum()
    assert 0.6 < total / float(ref['flux_focus']) < 1.6
    contrast = imgs[1].max() / imgs[1].mean()
    assert abs(contrast / (ref['img'].max() / ref['img'].mean()) - 1) < 0.5
    assert imgs[1].max() >= 0.7 * max(imgs[0].max(), imgs[2].max())
    assert float(np.abs(imgs - jimgs).max() / jimgs.max()) < 1e-4


def test_float32_against_float64_deterministic(ref):
    a = tbs.deterministic_chain(ref, F64, 'cpu', f32_samples=True)
    b = tbs.deterministic_chain(ref, torch.float32, 'cpu', f32_samples=True)
    for nm, floor in FLOORS.items():
        assert overlap(a[nm], b[nm]) > floor, nm
    assert np.isfinite(b['focus_J'].sum()) and b['focus_J'].sum() > 0
