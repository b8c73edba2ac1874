"""The port's remaining apertures against the JAX package.

* Beam stops, the double slit and its stop, polygonal, grid and Siemens
  star openings (with a vortex and a turned frame), a soft-edged slit, a
  tilted slit, and the windows of ``SetOfRectangularAperturesOnZActuator``:
  ``propagate`` of the same numpy rays, the state of every ray equal and
  every field to 1e-9 in float64.
* ``RectangularAperture.get_divergence``, ``set_divergence`` and
  ``touch_beam`` against the JAX package's to 1e-12.
* ``tests/test_apertures.py``'s nine checks on the port.
"""
import torch_harness  # noqa: F401

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import xrt_tpu.apertures as ja
from xrt_tpu.sources import GeometricSource as JGeometricSource
from xrt_tpu_torch import apertures as ta
from xrt_tpu_torch.sources import GeometricSource
from test_torch_dcm import compare, jax_beam, port_beam

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
E0, P, HALF = 9000.0, 1000.0, 2.0
FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'path', 'Jss', 'Jpp', 'Jsp')


def _rays(n=6000, seed=1):
    """A uniform 4 x 4 mm beam about +y with some divergence."""
    rng = np.random.RandomState(seed)
    a, c = rng.normal(0, 2e-4, n), rng.normal(0, 2e-4, n)
    return dict(x=rng.uniform(-HALF, HALF, n), y=np.zeros(n),
                z=rng.uniform(-HALF, HALF, n), a=a,
                b=np.sqrt(1 - a ** 2 - c ** 2), c=c, E=np.full(n, E0),
                state=np.ones(n, np.int32), path=np.zeros(n),
                Jss=np.ones(n), Jpp=np.zeros(n), Jsp=np.zeros(n, complex))


C = (0, P, 0)
CASES = {
    'rect_stop': ('RectangularBeamStop', dict(opening=(-0.8, 1.0, -0.5,
                                                       0.7))),
    'round_stop': ('RoundBeamStop', dict(r=1.2)),
    'double_slit': ('DoubleSlit.create', dict(opening=(-1, 1, -1.5, 1),
                                              shadeFraction=(0.3, 0.7))),
    'double_stop': ('DoubleBeamStop', dict(opening=(-1, 1, -1, 1),
                                           shadeFraction=(0.2, 0.5))),
    'polygon': ('PolygonalAperture.create',
                dict(opening=[(-1.5, -1.0), (1.5, -1.0), (0.3, 0.4),
                              (0.0, 1.4)])),
    'polygon_stop': ('PolygonalBeamStop',
                     dict(opening=[(-1.5, -1.0), (1.5, -1.0), (0.0, 1.4)])),
    'grid': ('GridAperture.create', dict(dx=0.1, dz=0.15, px=0.5, pz=0.4,
                                         nx=3, nz=2)),
    'grid_stop': ('GridBeamStop', dict(dx=0.1, dz=0.1, px=0.5, pz=0.5,
                                       nx=3, nz=3)),
    'star': ('SiemensStar.create', dict(nSpokes=8, r=1.5, phi0=0.2)),
    'star_vortex': ('SiemensStar.create', dict(nSpokes=5, r=1.7, vortex=2,
                                               x=(1, 0, 0.1))),
    'soft_rect': ('RectangularAperture.create',
                  dict(opening=(-1, 1.2, -0.7, 1), softEdge=0.05)),
    'tilted_rect': ('RectangularAperture.create',
                    dict(opening=(-1, 1.2, -0.7, 1), x=(1, 0.05, 0),
                         z=(0, -0.02, 1))),
}


def _make(mod, name, kw):
    obj = mod
    for part in name.split('.'):
        obj = getattr(obj, part)
    return obj(center=C, **kw)


@pytest.mark.parametrize('case', sorted(CASES))
def test_aperture_propagate_matches_jax(case):
    name, kw = CASES[case]
    d = _rays()
    jo = _make(ja, name, kw).propagate(jax_beam(d))
    to = _make(ta, name, kw).propagate(port_beam(d))
    compare(to, jo, fields=FIELDS)
    passed = torch.where(to.state > 0, to.Jss, 0.0).mean()
    assert 0.02 < float(passed) < 0.98, case


def test_actuator_windows_match_jax():
    kw = dict(center=C, apertures=['a', 'b', 'top-edge'],
              centerZs=[-1.0, 0.5, 1.2], dXs=[1.0, 2.0], dZs=[0.5, 0.8])
    js = ja.SetOfRectangularAperturesOnZActuator(**kw)
    ts = ta.SetOfRectangularAperturesOnZActuator(**kw)
    d = _rays()
    for name, tz in (('a', None), ('b', 0.3), ('top-edge', None),
                     ('top-edge', 0.9)):
        jw, tw = js.select_aperture(name, tz), ts.select_aperture(name, tz)
        assert ts.zActuator == js.zActuator and \
            ts.curAperture == js.curAperture
        np.testing.assert_array_equal(
            np.asarray([float(v) for v in tw.opening]),
            np.asarray([float(v) for v in jw.opening]))
        compare(tw.propagate(port_beam(d)), jw.propagate(jax_beam(d)),
                fields=FIELDS)


def test_divergence_and_touch_beam_match_jax():
    src = dict(center=(0, 0, 0))
    jap = ja.RectangularAperture.create(center=C, opening=(-1, 1.5, -0.5,
                                                           0.7))
    tap = ta.RectangularAperture.create(center=C, opening=(-1, 1.5, -0.5,
                                                           0.7))
    jsrc = JGeometricSource.create(**src)
    tsrc = GeometricSource.create(**src, **KW)
    np.testing.assert_allclose(tap.get_divergence(tsrc),
                               jap.get_divergence(jsrc), rtol=1e-12)
    div = (-2e-3, 1e-3, -5e-4, 8e-4)
    np.testing.assert_allclose(
        [float(v) for v in tap.set_divergence(tsrc, div).opening],
        [float(v) for v in jap.set_divergence(jsrc, div).opening],
        rtol=1e-12)
    d = _rays(3000, seed=2)
    d['state'][:100] = 0
    d['x'][:100] = 50.0       # dead rays do not count
    jt = jap.touch_beam(jax_beam(d))
    tt = tap.touch_beam(port_beam(d))
    np.testing.assert_allclose([float(v) for v in tt.opening],
                               [float(v) for v in jt.opening], rtol=1e-12)
    assert float(tt.right) < HALF + 1.0      # not the dead rays' 50


# ---- tests/test_apertures.py on the port --------------------------------

@pytest.fixture(scope='module')
def beam():
    src = GeometricSource.create(
        nrays=200000, distx='flat', dx=2 * HALF, distz='flat', dz=2 * HALF,
        distxprime=None, distzprime=None, dxprime=0.0, dzprime=0.0,
        distE='lines', energies=(E0,), polarization='horizontal', **KW)
    return src.shine(torch.Generator().manual_seed(0))


AREA_BEAM = (2 * HALF) ** 2


def frac(ap, beam):
    return float((ap.propagate(beam).state == 1).double().mean())


def test_rectangular_and_stop(beam):
    opening = (-0.8, 1.0, -0.5, 0.7)
    ap = ta.RectangularAperture.create(center=C, opening=opening)
    stop = ta.RectangularBeamStop(center=C, opening=opening)
    area = (opening[1] - opening[0]) * (opening[3] - opening[2])
    np.testing.assert_allclose(frac(ap, beam), area / AREA_BEAM, rtol=2e-2)
    np.testing.assert_allclose(frac(ap, beam) + frac(stop, beam), 1.0,
                               atol=1e-12)


def test_round_and_stop(beam):
    r = 1.2
    ap = ta.RoundAperture.create(center=C, r=r)
    stop = ta.RoundBeamStop(center=C, r=r)
    np.testing.assert_allclose(frac(ap, beam), math.pi * r ** 2 / AREA_BEAM,
                               rtol=2e-2)
    np.testing.assert_allclose(frac(ap, beam) + frac(stop, beam), 1.0,
                               atol=1e-12)


def test_polygonal_triangle(beam):
    ap = ta.PolygonalAperture.create(
        center=C, opening=[(-1.5, -1.0), (1.5, -1.0), (0.0, 1.4)])
    np.testing.assert_allclose(frac(ap, beam), 0.5 * 3.0 * 2.4 / AREA_BEAM,
                               rtol=2e-2)


def test_double_slit_shade(beam):
    opening = (-1.0, 1.0, -1.0, 1.0)
    ds = ta.DoubleSlit.create(center=C, opening=opening,
                              shadeFraction=(0.3, 0.7))
    np.testing.assert_allclose(frac(ds, beam), 4.0 * 0.6 / AREA_BEAM,
                               rtol=2e-2)
    stop = ta.DoubleBeamStop(center=C, opening=opening,
                             shadeFraction=(0.3, 0.7))
    np.testing.assert_allclose(frac(ds, beam) + frac(stop, beam), 1.0,
                               atol=1e-12)


def test_grid_beamstop_complements_grid(beam):
    kw = dict(center=C, dx=0.1, dz=0.1, px=0.5, pz=0.5, nx=3, nz=3)
    np.testing.assert_allclose(
        frac(ta.GridAperture.create(**kw), beam) +
        frac(ta.GridBeamStop(**kw), beam), 1.0, atol=1e-12)


def test_grid_fill_factor(beam):
    g = ta.GridAperture.create(center=C, dx=0.1, dz=0.1, px=0.5, pz=0.5,
                               nx=3, nz=3)
    np.testing.assert_allclose(frac(g, beam), 49 * 0.04 / AREA_BEAM,
                               rtol=5e-2)


def test_siemens_star_spokes(beam):
    st = ta.SiemensStar.create(center=C, nSpokes=8, r=1.5)
    np.testing.assert_allclose(frac(st, beam),
                               0.5 * math.pi * 1.5 ** 2 / AREA_BEAM,
                               rtol=3e-2)


def test_propagate_advances_to_plane(beam):
    ap = ta.RectangularAperture.create(center=C, opening=(-5, 5, -5, 5))
    out = ap.propagate(beam)
    good = (out.state == 1).numpy()
    np.testing.assert_allclose(out.y.numpy()[good], 0.0, atol=1e-9)
    np.testing.assert_allclose(out.path.numpy()[good], P, rtol=1e-6)


def test_soft_edge_conserves_total_flux_shape():
    hard = ta.RectangularAperture.create(center=C, opening=(-1, 1, -1, 1))
    soft = ta.RectangularAperture.create(center=C, opening=(-1, 1, -1, 1),
                                         softEdge=0.05)
    x = torch.linspace(-2, 2, 2001, dtype=F64)
    z = torch.zeros_like(x)
    Th, Ts = hard.transmission(x, z), soft.transmission(x, z)
    np.testing.assert_allclose(float(Ts.sum()), float(Th.sum()), rtol=1e-3)
    assert float(Ts[1000]) > 0.999
    assert float(Ts[0]) < 1e-6
    # the JAX package's soft edge on the same points
    jT = ja.RectangularAperture.create(
        center=C, opening=(-1, 1, -1, 1), softEdge=0.05).transmission(
        jnp.asarray(x.numpy()), jnp.asarray(z.numpy()))
    np.testing.assert_allclose(Ts.numpy(), np.asarray(jT), rtol=0,
                               atol=1e-12)
