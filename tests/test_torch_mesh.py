"""The port's STL mesh OE against the JAX package.

* ``read_stl`` of a binary and an ASCII file equals the JAX package's
  bit for bit, and so do ``_top_surface_vertices`` and the host fits of
  ``MeshOE`` ('quad' coefficients, the 'spline' height and slope maps and
  their grid, the limits), all float64 numpy.
* ``local_z``, ``local_n`` and ``reflect`` of 'flat', 'quad' and 'spline'
  mesh OEs at a grazing pitch: every field to 1e-9 in float64 (the JAX
  package under ``jit``).
* ``tests/test_mesh_oe.py``'s four checks on the port.
"""
import torch_harness  # noqa: F401

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
from xrt_tpu.oes import MeshOE as JMeshOE, read_stl as jread_stl
from xrt_tpu.oes.mesh3d import _top_surface_vertices as jtop
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch.oes import MeshOE, read_stl
from xrt_tpu_torch.oes.mesh3d import _top_surface_vertices
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import GeometricSource
from test_mesh_oe import (R_SPHERE, _make_surface_mesh, _sphere_sag,
                          _write_ascii_stl, _write_binary_stl)
from test_torch_dcm import compare, jax_beam, port_beam, rays_np

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'path', 'Jss', 'Jpp', 'Jsp')


def T(v):
    return torch.as_tensor(np.asarray(v, float), dtype=F64)


def _wavy_sphere(x, y):
    return 0.5 * _sphere_sag(x, y) + 2e-3 * np.sin(2 * np.pi * x / 5.0) * \
        np.cos(2 * np.pi * y / 7.0)


@pytest.fixture(scope='module')
def stl(tmp_path_factory):
    d = tmp_path_factory.mktemp('stl')
    vec, nor = _make_surface_mesh(_wavy_sphere, nx=24, ny=30, lx=16.0,
                                  ly=40.0)
    paths = dict(binary=str(d / 'm.stl'), ascii=str(d / 'm_ascii.stl'))
    _write_binary_stl(paths['binary'], vec, nor)
    _write_ascii_stl(paths['ascii'], vec, nor)
    return paths


@pytest.mark.parametrize('kind', ['binary', 'ascii'])
def test_reader_and_top_surface_match_jax(stl, kind):
    vt, nt = read_stl(stl[kind])
    vj, nj = jread_stl(stl[kind])
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(nt, nj)
    for a, b in zip(_top_surface_vertices(vt, nt), jtop(vj, nj)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('hint', ['flat', 'quad', 'spline'])
def test_mesh_oe_fits_and_reflect_match_jax(stl, hint):
    kw = dict(fileName=stl['binary'], center=(0, 5000.0, 0), pitch=5e-3,
              surfaceHint=hint, gridPointsPerMM=4.0)
    j = JMeshOE.create(material=jm.Material.create('Rh', rho=12.41), **kw)
    t = MeshOE.create(material=tm.Material.create('Rh', rho=12.41, **KW),
                      **kw, **KW)
    assert t.limPhysX == tuple(j.limPhysX) and \
        t.limPhysY == tuple(j.limPhysY)
    for f in ('cpoly', 'zmap', 'dzdx', 'dzdy', 'gx0', 'gy0', 'gdx', 'gdy'):
        if getattr(j, f) is None:
            assert getattr(t, f) is None, f
        else:
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), f)
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-9, 9, 3000), rng.uniform(-22, 22, 3000)
    np.testing.assert_allclose(
        t.local_z(T(x), T(y)).numpy(),
        np.asarray(j.local_z(jnp.asarray(x), jnp.asarray(y))),
        rtol=0, atol=1e-12)
    for a, b in zip(t.local_n(T(x), T(y)),
                    j.local_n(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    d = rays_np(1500, seed=4, dE=0.0, div=2e-5, size=(2.0, 0.03))
    jr = jax.jit(lambda b: j.reflect(b))(jax_beam(d))
    tr = t.reflect(port_beam(d))
    assert (tr[0].state == 1).float().mean() > 0.5
    for a, b in zip(tr, jr):
        compare(a, b, fields=FIELDS)


# ---- tests/test_mesh_oe.py on the port ----------------------------------

def test_read_binary_and_ascii_equal(tmp_path):
    vec, nor = _make_surface_mesh(_sphere_sag, nx=8, ny=8)
    pb, pa = str(tmp_path / 'm.stl'), str(tmp_path / 'm_ascii.stl')
    _write_binary_stl(pb, vec, nor)
    _write_ascii_stl(pa, vec, nor)
    vb, _ = read_stl(pb)
    va, _ = read_stl(pa)
    assert vb.shape == vec.shape
    assert np.allclose(vb, va, atol=1e-5)
    assert np.allclose(vb, vec, rtol=1e-6)


def test_quad_fit_recovers_sphere_radius(tmp_path):
    vec, nor = _make_surface_mesh(_sphere_sag)
    path = str(tmp_path / 'sph.stl')
    _write_binary_stl(path, vec, nor)
    oe = MeshOE.create(fileName=path, center=(0, 1000, 0),
                       surfaceHint='quad', **KW)
    Rmer, Rsag = oe.fitted_radii()
    assert abs(float(Rmer) - R_SPHERE) / R_SPHERE < 0.01
    assert abs(float(Rsag) - R_SPHERE) / R_SPHERE < 0.01
    z = oe.local_z(T([0.0, 5.0]), T([0.0, -5.0])).numpy()
    assert abs(z[0]) < 1e-3
    assert np.isclose(z[1], _sphere_sag(5.0, -5.0), atol=2e-3)


def test_spline_fit_wavy_surface(tmp_path):
    amp, per = 0.01, 5.0
    vec, nor = _make_surface_mesh(
        lambda x, y: amp * np.sin(2 * np.pi * x / per), nx=80, ny=10)
    path = str(tmp_path / 'wavy.stl')
    _write_binary_stl(path, vec, nor)
    oe = MeshOE.create(fileName=path, center=(0, 1000, 0),
                       surfaceHint='spline', **KW)
    x = np.linspace(-8.0, 8.0, 33)
    z = oe.local_z(T(x), T(np.zeros_like(x))).numpy()
    zexp = amp * np.sin(2 * np.pi * x / per) + amp
    assert np.allclose(z, zexp, atol=2e-3)
    n = oe.local_n(T(x), T(np.zeros_like(x)))
    slope = -n[0].numpy() / n[2].numpy()
    sexp = amp * 2 * np.pi / per * np.cos(2 * np.pi * x / per)
    assert np.allclose(slope, sexp, atol=3e-3)


def test_mesh_oe_traces_and_focuses(tmp_path):
    """A spherical MeshOE at grazing incidence focuses like a spherical
    mirror of the fitted radius."""
    vec, nor = _make_surface_mesh(
        lambda x, y: 10000.0 - np.sqrt(10000.0**2 - x**2 - y**2),
        nx=30, ny=30, lx=30.0, ly=30.0)
    path = str(tmp_path / 'sph2.stl')
    _write_binary_stl(path, vec, nor)
    pitch, p, R = math.radians(1.0), 2000.0, 10000.0
    q = 1.0 / (2.0 / (R * math.sin(pitch)) - 1.0 / p)
    oe = MeshOE.create(fileName=path, center=(0, p, 0), pitch=pitch,
                       surfaceHint='quad', **KW)
    src = GeometricSource.create(nrays=2000, dzprime=2e-5,
                                 energies=(9000.0,), distE='lines', **KW)
    glo, _ = oe.reflect(src.shine(torch.Generator().manual_seed(0)))
    scr = Screen.create(center=(0, p + q * math.cos(2 * pitch),
                                q * math.sin(2 * pitch)),
                        z=(0, -math.sin(2 * pitch), math.cos(2 * pitch)))
    img = scr.expose(glo)
    good = (glo.state == 1).numpy()
    assert good.mean() > 0.9
    z = img.z.numpy()[good]
    assert z.std() < 0.1 * 2e-5 * (p + q)
