"""The port's wave geometry, diffract and reflect_wave against the JAX
package's, in float64 on the same receiver samples.

The Gaussian -> slit -> toroid geometry of the JAX package's sharded
chain test.  The JAX samplers draw the receiver samples; the port takes
them through ``prepare_wave_on_*(samples=...)``.  JAX runs with jit
disabled, so both sides execute the same IEEE float64 operations one by
one (a compiled XLA body contracts a*a + b*b into FMAs, which moves a
1e9-1e10 rad phase by ~1e-7 rad).  Tolerance 1e-10, relative to each
field's largest value (measured ~1e-15).
"""
import math

import numpy as np
import pytest
import torch
import jax

import xrt_tpu.materials as jm
from xrt_tpu import waves as jw
from xrt_tpu.apertures import RectangularAperture as JSlit
from xrt_tpu.oes import ToroidMirror as JToroid
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu.sources import GaussianBeam as JGauss
from xrt_tpu_torch import config, interop
from xrt_tpu_torch import waves as tw
from xrt_tpu_torch.apertures import RectangularAperture
from xrt_tpu_torch.materials import Material
from xrt_tpu_torch.oes import ToroidMirror
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import GaussianBeam
from xrt_tpu_torch.wavechain import WaveChain

E0 = 500.0
P, Q, PITCH = 5000.0, 1000.0, 6e-3
R = 2 * P * Q / (P + Q) / math.sin(PITCH)
r = 2 * P * Q / (P + Q) * math.sin(PITCH)
SCR = dict(center=(0, P + Q * math.cos(2 * PITCH), Q * math.sin(2 * PITCH)),
           z=(0, -math.sin(2 * PITCH), math.cos(2 * PITCH)))
SRC = dict(w0=0.05, distE='lines', energies=(E0,), polarization='horizontal')
SLIT = dict(center=(0, 0, 0), opening=(-0.3, 0.3, -0.15, 0.15))
TOR = dict(center=(0, P, 0), pitch=PITCH, R=R, r=r, limPhysX=(-3, 3),
           limPhysY=(-40, 40))
ZS = np.linspace(-0.02, 0.02, 21)
XS = np.linspace(-0.01, 0.01, 5)
NRAYS = 401
F64 = torch.float64


def port_elements(dtype=F64):
    mat = Material.create('Au', rho=19.3, kind='mirror', dtype=dtype,
                          device='cpu')
    return (GaussianBeam.create(**SRC), RectangularAperture.create(**SLIT),
            ToroidMirror.create(material=mat, **TOR), Screen.create(**SCR))


@pytest.fixture(scope='module')
def jax_side():
    mat = jm.Material.create('Au', rho=19.3, kind='mirror')
    src, slit = JGauss.create(**SRC), JSlit.create(**SLIT)
    tor, scr = JToroid.create(material=mat, **TOR), JScreen.create(**SCR)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    w0 = jw.prepare_wave_on_aperture(slit, src, NRAYS, key=k1)
    w1 = jw.prepare_wave_on_oe(tor, slit, NRAYS, key=k2)
    w2 = jw.prepare_wave_on_screen(scr, tor, XS, ZS)
    key = jax.random.PRNGKey(0)
    with jax.disable_jit():
        s0 = src.shine(key, w0)
        b1 = jw.diffract(s0, w1, phase_mode='recentred', monochromatic=True)
        g1, l1 = jw.reflect_wave(tor, b1, key)
        b2 = jw.diffract(l1, w2, phase_mode='recentred', monochromatic=True)
    return dict(w=(w0, w1, w2), s0=s0, b1=b1, g1=g1, l1=l1, b2=b2,
                els=(src, slit, tor, scr))


def port_waves(jx, dtype=F64):
    src, slit, tor, scr = port_elements(dtype)
    w0, w1, w2 = jx['w']
    a = tw.prepare_wave_on_aperture(
        slit, src, 0, samples=(np.asarray(w0.x), np.asarray(w0.z)),
        dtype=dtype, device='cpu')
    b = tw.prepare_wave_on_oe(
        tor, slit, 0, samples=(np.asarray(w1.x), np.asarray(w1.y),
                               np.asarray(w1.z)), dtype=dtype, device='cpu')
    c = tw.prepare_wave_on_screen(scr, tor, XS, ZS, dtype=dtype,
                                  device='cpu')
    return (a, b, c), (src, slit, tor, scr)


#: the s and p parts are measured against the larger of the pair (the
#: chain's field is horizontally polarized: Ep and Jpp are rounding noise)
PARTNER = {'Ep': 'Es', 'Jpp': 'Jss', 'Jsp': 'Jss', 'EpAcc': 'EsAcc'}


def assert_fields_close(t, j, fields, tol=1e-10):
    for f in fields:
        x = getattr(t, f)
        y = getattr(j, f)
        assert (x is None) == (y is None), f
        if x is None:
            continue
        x = x.numpy()
        y = np.asarray(y)
        scale = max(float(np.abs(y).max()), 1e-300)
        if f in PARTNER:
            scale = max(scale, float(np.abs(np.asarray(
                getattr(j, PARTNER[f]))).max()))
        err = float(np.abs(x - y).max()) / scale
        assert err < tol, (f, err)


GEOM = ('x', 'y', 'z', 'xDiffr', 'yDiffr', 'zDiffr', 'rDiffr', 'a', 'b',
        'c', 'dS', 'area', 'state')
FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'Es', 'Ep', 'Jss', 'Jpp',
          'Jsp', 'state')


def test_prepare_waves_f64_match(jax_side):
    (a, b, c), _ = port_waves(jax_side)
    w0, w1, w2 = jax_side['w']
    assert_fields_close(a, w0, GEOM)
    assert_fields_close(b, w1, GEOM + ('areaNormal',))
    assert_fields_close(c, w2, GEOM)


def test_shine_diffract_reflect_f64_match(jax_side):
    (a, b, c), (src, slit, tor, scr) = port_waves(jax_side)
    s0 = src.shine(None, a)
    assert_fields_close(s0, jax_side['s0'], FIELDS + ('path',))
    b1 = tw.diffract(s0, b, phase_mode='recentred', monochromatic=True)
    assert_fields_close(b1, jax_side['b1'], FIELDS + (
        'EsAcc', 'EpAcc', 'aEacc', 'bEacc', 'cEacc', 'aGlo', 'bGlo', 'cGlo',
        'EsGlo', 'JssGlo', 'beamReflSumJ', 'beamReflSumJnl'))
    g1, l1 = tw.reflect_wave(tor, b1)
    assert_fields_close(l1, jax_side['l1'], FIELDS + ('theta',))
    assert_fields_close(g1, jax_side['g1'], FIELDS)
    b2 = tw.diffract(l1, c, phase_mode='recentred', monochromatic=True)
    assert_fields_close(b2, jax_side['b2'], FIELDS + ('EsAcc', 'cEacc'))


def test_choose_kirchhoff_mode_matches(jax_side):
    (a, b, c), _ = port_waves(jax_side)
    kv = E0 / 1973.269788 * 1e7
    for dst, src in ((b, a), (c, b)):
        d = (dst.xDiffr, dst.yDiffr, dst.zDiffr)
        s = (src.x, src.y, src.z)
        dn = tuple(v.numpy() for v in d)
        sn = tuple(v.numpy() for v in s)
        for budget in (None, 3.0 / math.sqrt(NRAYS), 1e-4):
            assert tw.choose_kirchhoff_mode(d, s, k=kv,
                                            error_budget=budget) == \
                jw.choose_kirchhoff_mode(dn, sn, k=kv, error_budget=budget)
    # far outside the recentred envelope: the per-pair 'fast' phase
    rng = np.random.RandomState(1)
    ys = rng.uniform(-300, 300, 200)
    d = (rng.uniform(-1, 1, 50), np.full(50, 100.0), rng.uniform(3, 5, 50))
    s = (np.zeros(200), ys, ys * 0.004)
    assert tw.choose_kirchhoff_mode(d, s) == jw.choose_kirchhoff_mode(d, s) \
        == ('fast', 'vpu')


def test_wave_frame_rotation_and_tile_bounds_match(jax_side):
    _, (src, slit, tor, scr) = port_waves(jax_side)
    jsrc, jslit, jtor, jscr = jax_side['els']
    np.testing.assert_allclose(tw.wave_frame_rotation(tor, slit),
                               jw.wave_frame_rotation(jtor, jslit),
                               rtol=0, atol=1e-15)
    for N, n in ((601, 5), (100, 10), (7, 3)):
        assert tw._tile_bounds(N, n) == jw._tile_bounds(N, n)


def test_rescale_field_matches(jax_side):
    s0 = jax_side['s0']
    t = interop.beam_from_numpy(
        {f: np.asarray(getattr(s0, f)) for f in ('x', 'y', 'z', 'a', 'b',
                                                 'c', 'E', 'state', 'path',
                                                 'Jss', 'Jpp', 'Jsp', 'Es',
                                                 'Ep')},
        device='cpu', dtype=F64)
    tb, tl = tw.rescale_field(t)
    jb, jl = jw.rescale_field(s0)
    assert float(tl) == pytest.approx(float(jl), rel=1e-14)
    assert_fields_close(tb, jb, ('Es', 'Ep', 'Jss', 'Jpp', 'Jsp'), 1e-14)


def test_interop_wave_round_trip(jax_side):
    (a, b, c), (src, slit, tor, scr) = port_waves(jax_side)
    arrays = interop.to_numpy(b)
    b2 = interop.wave_from_numpy(arrays, device='cpu', dtype=F64,
                                 fromOE=slit, toOE=tor)
    assert b2.fromOE is slit and b2.toOE is tor
    for f, v in arrays.items():
        assert torch.equal(getattr(b2, f), getattr(b, f)), f


def test_estimate_footprint_area_matches():
    rng = np.random.RandomState(2)
    x, y = rng.uniform(-1, 2, 300), rng.uniform(-3, 1, 300)
    good = rng.uniform(0, 1, 300) > 0.2
    assert tw.estimate_footprint_area(torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      torch.from_numpy(good)) == \
        pytest.approx(jw.estimate_footprint_area(x, y, good), rel=1e-14)


def test_entry_points_run_on_the_card_unless_asked_for_cpu():
    """Without CUDA, an entry point called without device='cpu' raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device works')
    src, slit, tor, scr = port_elements()
    with pytest.raises(RuntimeError, match='CUDA'):
        tw.prepare_wave_on_screen(scr, tor, XS, ZS)
    with pytest.raises(RuntimeError, match='CUDA'):
        Material.create('Au', rho=19.3)
    with pytest.raises(RuntimeError, match='CUDA'):
        WaveChain(src, nrays=10).through_aperture(slit).build()
    assert config.resolve_device('cpu').type == 'cpu'


def test_unported_options_raise_naming_the_roadmap(jax_side):
    (a, b, c), (src, slit, tor, scr) = port_waves(jax_side)
    s0 = src.shine(None, a)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tw.diffract(s0, b, mesh=object())
    chain = WaveChain(src, nrays=10).through_aperture(slit)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        chain.build(mesh=object(), device='cpu')
    # figure errors and voxel-volume (TXM) materials are ported too
    # (tests/test_torch_figure_error.py, tests/test_torch_txm.py): an OE
    # takes a figure error
    fe = object()
    assert ToroidMirror.create(figure_error=fe).figure_error is fe
