"""The port's SoftiMAX optics against the JAX package's: the blazed grating
and the parametric elliptical mirror.

Both sides run the same operations eagerly on the same seeded inputs:

* surfaces (``local_z``/``local_n``, ``local_r``, ``xyz_to_param``,
  ``param_to_xyz``), the grating's ``analytic_intersect`` (facet edges
  included) and ``get_grating_area_fraction``: float64 to 1e-12 of each
  quantity's largest magnitude; float32 (the JAX elements' parameters cast
  to float32, as the JAX package stores them in a float32 run) to 2 ulp of
  each value (transcendental functions may differ in the last ulp);
* ``reflect`` with the search (the grating: its analytic intersection) and
  without it, on the same beams, float64 to 1e-10 (after a search the
  fields to 1e-7 with their propagation phase k t taken out: both
  searches stop at |dz| < 1e-12 mm, which leaves ~1e-5 rad in k t at
  280 eV);
* the elements placed by the port's SoftiMAX layout (pilot rays through
  its own ``reflect``) equal the JAX layout to 1e-9 mm / rad;
* ``prepare_wave_on_oe`` with the golden's ``samples=`` on M4, M5 and PG:
  the receiving points, ``s``, ``phi``, ``dS`` and the area to 1e-10.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from xrt_tpu.beam import Beam as JBeam
from xrt_tpu.waves import prepare_wave_on_oe as j_prepare_oe
from xrt_tpu_torch import interop
from xrt_tpu_torch import waves as tw
from xrt_tpu_torch.physconsts import CHBAR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
import bench_softimax as jbs  # noqa: E402
import torch_bench_softimax as tbs  # noqa: E402

F64 = torch.float64
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'ref_softimax.npz')


@pytest.fixture(scope='module')
def els():
    """(port elements, JAX elements) of the SoftiMAX beamline, float64."""
    t = tbs.beamline(F64, 'cpu')
    j = jbs.build_chain(nrays=2000, n_scr=16).elements
    return t, j


def close(t, j, tol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    fin = np.isfinite(j)
    scale = max(float(np.abs(j[fin]).max()), 1e-300)
    err = float(np.abs(t[fin] - j[fin]).max()) / scale
    assert err < tol, err


def close_ulp(t, j, n=2, scale=0.0):
    """|t - j| <= n ulp of j, elementwise (float32); where the last step
    adds a figure offset to a nearly opposite value (param_to_xyz adds y0
    and z0), n ulp of that offset, *scale*."""
    t = t.numpy()
    j = np.asarray(j)
    assert t.dtype == j.dtype == np.float32
    ulp = np.spacing(np.maximum(np.abs(j), np.float32(abs(scale))))
    bad = np.abs(t.astype(np.float64) - j.astype(np.float64)) > n * ulp
    assert not bad.any(), (t[bad][:5], j[bad][:5])


def f32_twin(jel):
    """The JAX element with its array parameters in float32."""
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.float32)
        if jnp.issubdtype(jnp.asarray(v).dtype, jnp.floating) else v, jel)


def grating_points(pg, seed=0, n=600):
    """y over the grating with a third of the points at facet edges (at a
    period boundary, just below and just above it, and at the corner
    between the two facets)."""
    rng = np.random.RandomState(seed)
    rho_1 = 1.0 / pg.rho
    k = rng.randint(-1000, 1000, n // 3)
    edge = np.concatenate([k * rho_1 + d for d in (0.0, -1e-9, 1e-9)])
    y = np.concatenate([rng.uniform(-40, 40, n - edge.size), edge])
    x = rng.uniform(-2, 2, y.size)
    return x, y


def test_layout_matches_jax(els):
    t, j = els
    for name in ('m1', 'm2', 'pg', 'm3', 'exitSlit', 'm4', 'm5'):
        np.testing.assert_allclose(np.array(t[name].center, float),
                                   np.asarray(j[name].center, float),
                                   atol=1e-9, rtol=0, err_msg=name)
        if hasattr(t[name], 'pitch'):
            for ang in ('pitch', 'yaw', 'positionRoll'):
                assert getattr(t[name], ang) == pytest.approx(
                    float(getattr(j[name], ang)), abs=1e-12), (name, ang)
    for a, b in zip(t['screens'], j['screens']):
        np.testing.assert_allclose(np.array(a.center, float),
                                   np.asarray(b.center, float), atol=1e-9)


def test_grating_surface_f64(els):
    tpg, jpg = els[0]['pg'], els[1]['pg']
    x, y = grating_points(tpg)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    close(tpg.local_z(tx, ty), jpg.local_z(jnp.asarray(x), jnp.asarray(y)))
    for a, b in zip(tpg.local_n(tx, ty),
                    jpg.local_n(jnp.asarray(x), jnp.asarray(y))):
        close(a, b)
    assert tpg.get_grating_area_fraction() == pytest.approx(
        float(jpg.get_grating_area_fraction()), rel=1e-12)


def test_grating_surface_f32(els):
    tpg, jpg = els[0]['pg'], f32_twin(els[1]['pg'])
    x, y = grating_points(tpg, seed=1)
    x, y = x.astype(np.float32), y.astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    assert jpg.local_z(jx, jy).dtype == jnp.float32
    close_ulp(tpg.local_z(tx, ty), jpg.local_z(jx, jy))
    for a, b in zip(tpg.local_n(tx, ty), jpg.local_n(jx, jy)):
        close_ulp(a, b)


def ray_batch(seed, n, dtype=np.float64):
    """Rays from 100-400 mm above the grating plane aimed at its surface
    at grazing angles, float *dtype*."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-1.5, 1.5, n)
    y0 = rng.uniform(-30, 30, n)
    ang = rng.uniform(0.05, 0.3, n)
    d = rng.uniform(100, 400, n)
    a = rng.uniform(-1e-3, 1e-3, n)
    b, c = np.cos(ang), -np.sin(ang)
    x, y, z = x0 - a * d, y0 - b * d, -c * d
    return [v.astype(dtype) for v in (x, y, z, a, b, c)]


@pytest.mark.parametrize('f32', [False, True], ids=['f64', 'f32'])
def test_grating_analytic_intersect(els, f32):
    tpg = els[0]['pg']
    jpg = f32_twin(els[1]['pg']) if f32 else els[1]['pg']
    ray = ray_batch(2, 500, np.float32 if f32 else np.float64)
    t_out = tpg.analytic_intersect(None, None,
                                   *(torch.from_numpy(v) for v in ray))
    j_out = jpg.analytic_intersect(None, None,
                                   *(jnp.asarray(v) for v in ray))
    for a, b in zip(t_out[:4], j_out[:4]):
        if f32:
            close_ulp(a, b)
        else:
            close(a, b)
    assert not bool(t_out[4].any())


def ellipse_points(el, seed, n=500, dtype=np.float64):
    """Surface points of a parametric mirror (s, phi, local_r) and points
    off it, in its local frame."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(el.limPhysX[0], el.limPhysX[1], n)
    y = rng.uniform(el.limPhysY[0], el.limPhysY[1], n)
    z = rng.uniform(-1e-3, 1e-3, n)
    return [v.astype(dtype) for v in (x, y, z)]


@pytest.mark.parametrize('name', ['m4', 'm5'])
def test_ellipse_surface_f64(els, name):
    tm, jm = els[0][name], els[1][name]
    x, y, z = ellipse_points(tm, 3)
    tp = tm.xyz_to_param(*(torch.from_numpy(v) for v in (x, y, z)))
    jp = jm.xyz_to_param(*(jnp.asarray(v) for v in (x, y, z)))
    for a, b in zip(tp, jp):
        close(a, b)
    s, phi, r = (v.numpy() for v in tp)
    ts, tphi = torch.from_numpy(s), torch.from_numpy(phi)
    close(tm.local_r(ts, tphi), jm.local_r(jnp.asarray(s), jnp.asarray(phi)))
    for a, b in zip(tm.local_n(ts, tphi),
                    jm.local_n(jnp.asarray(s), jnp.asarray(phi))):
        close(a, b)
    for a, b in zip(tm.param_to_xyz(*tp),
                    jm.param_to_xyz(*(jnp.asarray(v) for v in (s, phi, r)))):
        close(a, b)
    # the round trip lands where it started
    back = tm.param_to_xyz(*tp)
    for a, v in zip(back, (x, y, z)):
        np.testing.assert_allclose(a.numpy(), v, atol=1e-9)


@pytest.mark.parametrize('name', ['m4', 'm5'])
def test_ellipse_surface_f32(els, name):
    tm, jm = els[0][name], f32_twin(els[1][name])
    x, y, z = ellipse_points(tm, 4, dtype=np.float32)
    tp = tm.xyz_to_param(*(torch.from_numpy(v) for v in (x, y, z)))
    jp = jm.xyz_to_param(*(jnp.asarray(v) for v in (x, y, z)))
    for a, b in zip(tp, jp):
        close_ulp(a, b)
    s, phi, r = (np.array(v) for v in jp)
    ts, tphi = torch.from_numpy(s), torch.from_numpy(phi)
    close_ulp(tm.local_r(ts, tphi),
              jm.local_r(jnp.asarray(s), jnp.asarray(phi)))
    for a, b in zip(tm.local_n(ts, tphi),
                    jm.local_n(jnp.asarray(s), jnp.asarray(phi))):
        close_ulp(a, b)
    for a, b, off in zip(tm.param_to_xyz(*(torch.from_numpy(v)
                                           for v in (s, phi, r))),
                         jm.param_to_xyz(*(jnp.asarray(v)
                                           for v in (s, phi, r))),
                         (0.0, tm.y0, tm.z0)):
        close_ulp(a, b, scale=off)


def beams_onto(el, seed, n=300):
    """Global rays from 500 mm upstream of *el* aimed at random points of
    its surface, as numpy arrays (float64)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.8 * el.limPhysX[0], 0.8 * el.limPhysX[1], n)
    y = rng.uniform(0.8 * el.limPhysY[0], 0.8 * el.limPhysY[1], n)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if el.isParametric:
        z = torch.zeros_like(tx)
        for _ in range(3):
            s, phi, _ = el.xyz_to_param(tx, ty, z)
            z = el.param_to_xyz(s, phi, el.local_r(s, phi))[2]
    else:
        z = el.local_z(tx, ty)
    gx, gy, gz = tw._np_local_to_global64(el, x, y, z.numpy())
    c = np.array(el.center, float)
    # incoming along the beamline axis into the element, from 500 mm
    d = np.stack([gx, gy, gz]) - (c - 500.0 * np.array(
        [-math.sin(el.yaw), math.cos(el.yaw), 0.0]))[:, None]
    d /= np.linalg.norm(d, axis=0)
    start = np.stack([gx, gy, gz]) - 50.0 * d
    Es = np.exp(1j * rng.uniform(0, 2 * np.pi, n))
    return dict(x=start[0], y=start[1], z=start[2], a=d[0], b=d[1],
                c=d[2], E=np.full(n, 280.0), state=np.ones(n, np.int32),
                path=np.zeros(n), Jss=np.abs(Es) ** 2,
                Jpp=np.zeros(n) + 0.09, Jsp=Es * 0.3, Es=Es,
                Ep=0.3 * np.ones(n, complex))


FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'Es', 'Ep', 'Jss', 'Jpp', 'path')


@pytest.mark.parametrize('name', ['pg', 'm4', 'm5'])
def test_reflect_with_and_without_search(els, name):
    tel, jel = els[0][name], els[1][name]
    arrays = beams_onto(tel, 5)
    tb = interop.beam_from_numpy(arrays, device='cpu', dtype=F64)
    jb = JBeam(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tglo, tloc = tel.reflect(tb)
    jglo, jloc = jel.reflect(jb, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(tloc.state.numpy(), np.asarray(jloc.state))
    assert int((tloc.state == 1).sum()) > 250
    # the fields carry exp(i k t): the searches stop at |dz| < 1e-12 mm,
    # so t agrees to ~1e-11 mm, k t to ~1e-5 rad; the fields are compared
    # with each side's own propagation phase taken out, to 1e-7 (k t is
    # ~7e7 rad, rounded in float64 to ~1e-8 rad)
    k = 280.0 / CHBAR * 1e7
    for f in FIELDS:
        for tb_, jb_ in ((tglo, jglo), (tloc, jloc)):
            tv, jv = getattr(tb_, f), np.asarray(getattr(jb_, f))
            tol = 1e-10
            if f in ('Es', 'Ep'):
                tv = tv.numpy() * np.exp(-1j * k * tb_.path.numpy())
                jv = jv * np.exp(-1j * k * np.asarray(jb_.path))
                tol = 1e-7
            close(tv, jv, tol)
    if tel.isParametric:
        for f in ('s', 'phi', 'r'):
            close(getattr(tloc, f), getattr(jloc, f), 1e-10)
    # without the search: the rays already on the surface
    on = dict(arrays, x=tglo.x.numpy(), y=tglo.y.numpy(), z=tglo.z.numpy())
    tb2 = interop.beam_from_numpy(on, device='cpu', dtype=F64)
    jb2 = JBeam(**{k: jnp.asarray(v) for k, v in on.items()})
    tglo2, tloc2 = tel.reflect(tb2, noIntersectionSearch=True)
    jglo2, jloc2 = jel.reflect(jb2, jax.random.PRNGKey(0),
                               noIntersectionSearch=True)
    np.testing.assert_array_equal(tloc2.state.numpy(),
                                  np.asarray(jloc2.state))
    for f in FIELDS:
        close(getattr(tglo2, f), getattr(jglo2, f), 1e-10)
        close(getattr(tloc2, f), getattr(jloc2, f), 1e-10)


@pytest.mark.parametrize('oe_nm,wnm,prev', [('pg', 'wpg', 'm2'),
                                            ('m4', 'wm4', 'exitSlit'),
                                            ('m5', 'wm5', 'm4')])
def test_prepare_wave_on_oe_with_samples(els, oe_nm, wnm, prev):
    ref = np.load(GOLDEN)
    t, j = els
    samples = (ref[wnm + '_x'], ref[wnm + '_y'])
    got = tw.prepare_wave_on_oe(t[oe_nm], t[prev], 0, samples=samples,
                                dtype=F64, device='cpu')
    exp = j_prepare_oe(j[oe_nm], j[prev], 0, samples=samples)
    for f in ('xDiffr', 'yDiffr', 'zDiffr', 'z', 'dS', 'area',
              'areaNormal'):
        close(getattr(got, f), getattr(exp, f), 1e-10)
    np.testing.assert_array_equal(got.state.numpy(), np.asarray(exp.state))
    if t[oe_nm].isParametric:
        for f in ('s', 'phi'):
            close(getattr(got, f), getattr(exp, f), 1e-10)
