"""The port's TXM voxel volume against the JAX package.

* ``TXMMaterial``: voxel lookup, refractive index, the chord integrals
  of ``volume_integrals`` (a Python loop over the z slabs) and
  ``get_amplitude`` on numpy-seeded rays through a random water / gold
  grid, float64, against the JAX package's: indices equal, the rest to
  1e-9 relative.
* A ``Plate`` carrying the volume (the TXM branch of ``_interact``):
  ``double_refract`` of the same rays, every field of the three beams to
  1e-9 (the JAX package under ``jit``).
* ``tests/test_txm_volume.py``'s six checks on the port (the HDF5 round
  trip skips where ``h5py`` is not installed).
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
import xrt_tpu.oes as jo
from xrt_tpu_torch import materials as tm, oes as to
from xrt_tpu_torch.physconsts import CHBAR
from xrt_tpu_torch.sources import GeometricSource
from test_torch_dcm import compare, jax_beam, port_beam

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'path', 'Jss', 'Jpp', 'Jsp')


def T(v):
    return torch.as_tensor(np.asarray(v, float), dtype=F64)


def _mats(mod, **kw):
    water = mod.Material.create(('H', 'O'), quantities=(2, 1), rho=1.0,
                                kind='plate', **kw)
    gold = mod.Material.create('Au', rho=19.3, kind='plate', **kw)
    return water, gold


def _random(mod, **kw):
    grid = (np.random.default_rng(1).uniform(size=(12, 7, 9)) <
            0.3).astype(np.uint8)
    lim = {'x': (-1.0, 1.0), 'y': (-1.0, 1.0), 'z': (0.0, 0.1)}
    return mod.TXMMaterial.create(
        indexGrid=grid, limits=lim, materialsIndex=_mats(mod, **kw),
        **({'device': 'cpu'} if kw else {}))


def test_volume_matches_jax():
    j, t = _random(jm), _random(tm, **KW)
    rng = np.random.default_rng(2)
    n = 4000
    E = rng.uniform(8000, 12000, n)
    x, y = rng.uniform(-1.1, 1.1, n), rng.uniform(-1.1, 1.1, n)
    z = rng.uniform(-0.01, 0.02, n)
    a, b = rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n)
    c = np.sqrt(1 - a ** 2 - b ** 2)
    c[:20] = 0.0                                   # along the slabs
    tMax = rng.uniform(-0.01, 0.2, n)
    J = [jnp.asarray(v) for v in (E, x, y, z, a, b, c, tMax)]
    P = [T(v) for v in (E, x, y, z, a, b, c, tMax)]
    np.testing.assert_array_equal(
        t.get_material_indices(*P[1:4]).numpy(),
        np.asarray(j.get_material_indices(*J[1:4])))
    for got, ref in zip(
            (t.get_refractive_index(*P[:4]),
             t.get_refractive_index(P[0]),
             t.get_absorption_coefficient(*P[:4])),
            (j.get_refractive_index(*J[:4]), j.get_refractive_index(J[0]),
             j.get_absorption_coefficient(*J[:4]))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-12)
    mu_t, nk_t = t.volume_integrals(*P)
    mu_j, nk_j = jax.jit(j.volume_integrals)(*J)
    for g, r in ((mu_t, mu_j), (nk_t, nk_j)):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-9,
                                   atol=1e-12 * np.abs(r).max())
    bidn = T(-np.abs(c))
    for fv, extra in ((True, ()), (False, (3, 4, 5, 6))):
        gt = t.get_amplitude(P[0], bidn, fv, *P[1:4],
                             *[P[i + 1] for i in extra])
        gj = j.get_amplitude(J[0], jnp.asarray(bidn.numpy()), fv, *J[1:4],
                             *[J[i + 1] for i in extra])
        for g, r in zip(gt, gj):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=1e-9, atol=1e-15)


def _plates(grid, t=0.1):
    lim = {'x': (-1.0, 1.0), 'y': (-1.0, 1.0), 'z': (0.0, t)}
    kw = dict(center=(0, 1000.0, 0), pitch=math.pi / 2, t=t,
              limPhysX=(-2, 2), limPhysY=(-2, 2))
    return tuple(
        oes.Plate.create(material=mats.TXMMaterial.create(
            indexGrid=grid, limits=lim, materialsIndex=_mats(mats, **mk),
            **({'device': 'cpu'} if mk else {})),
            **kw) for oes, mats, mk in ((jo, jm, {}), (to, tm, KW)))


def _plate_rays(n, seed, div=0.0):
    """Rays starting 1 mm before the plate, about +y."""
    rng = np.random.RandomState(seed)
    a = rng.normal(0, div, n)
    c = rng.normal(0, div, n)
    return dict(x=rng.uniform(-0.8, 0.8, n), y=np.full(n, 999.0),
                z=rng.uniform(-0.25, 0.25, n), a=a,
                b=np.sqrt(1 - a ** 2 - c ** 2), c=c,
                E=rng.uniform(8500, 9500, n), state=np.ones(n, np.int32),
                path=np.zeros(n), Jss=np.ones(n), Jpp=np.zeros(n),
                Jsp=np.zeros(n, complex))


def test_txm_plate_matches_jax():
    grid = (np.random.default_rng(4).uniform(size=(8, 8, 8)) <
            0.4).astype(np.uint8)
    jp, tp = _plates(grid)
    d = _plate_rays(1500, seed=5, div=0.2)
    jr = jax.jit(lambda b: jp.double_refract(b))(jax_beam(d))
    tr = tp.double_refract(port_beam(d))
    assert (tr[0].state == 1).float().mean() > 0.5
    for a, b in zip(tr, jr):
        compare(a, b, fields=FIELDS)
    assert float((tr[0].Jss + tr[0].Jpp).std()) > 1e-3   # the voxels show


# ---- tests/test_txm_volume.py on the port --------------------------------

def _two_layer():
    water, gold = _mats(tm, **KW)
    grid = np.zeros((10, 4, 4), np.uint8)
    grid[5:] = 1
    lim = {'x': (-0.025, 0.025), 'y': (-0.025, 0.025), 'z': (0.0, 0.050)}
    return water, gold, tm.TXMMaterial.create(
        indexGrid=grid, limits=lim, materialsIndex=(water, gold),
        device='cpu')


def _n(m, E):
    return complex(m.get_refractive_index(T([E]))[0])


def test_voxel_lookup_and_refractive_index():
    water, gold, txm = _two_layer()
    E = T([9000.0] * 3)
    x = y = T(np.zeros(3))
    z = T([0.01, 0.04, 0.049])
    assert txm.get_material_indices(x, y, z).tolist() == [0, 1, 1]
    n = txm.get_refractive_index(E, x, y, z).numpy()
    assert np.isclose(n[0], _n(water, 9000.0)) and \
        np.isclose(n[1], _n(gold, 9000.0))
    assert np.isclose(complex(txm.get_refractive_index(T([9000.0]))[0]),
                      _n(water, 9000.0))


def test_volume_integrals_two_layers():
    water, gold, txm = _two_layer()
    zero, one = T([0.0]), T([1.0])
    mu, nk = txm.volume_integrals(T([9000.0]), zero, zero, zero, zero, zero,
                                  one, T([0.050]))
    mu_w = float(water.get_absorption_coefficient(T([9000.0]))[0])
    mu_g = float(gold.get_absorption_coefficient(T([9000.0]))[0])
    assert np.isclose(float(mu[0]), 0.5 * (mu_w + mu_g), rtol=1e-9)
    nk_exp = 0.5 * (_n(water, 9000.0).real + _n(gold, 9000.0).real) * \
        9000.0 / float(CHBAR) * 1e8
    assert np.isclose(float(nk[0]), nk_exp, rtol=1e-9)


def test_volume_integrals_partial_chord():
    water, _, txm = _two_layer()
    zero, one = T([0.0]), T([1.0])
    mu, _ = txm.volume_integrals(T([9000.0]), zero, zero, zero, zero, zero,
                                 one, T([0.025]))
    mu_w = float(water.get_absorption_coefficient(T([9000.0]))[0])
    assert np.isclose(float(mu[0]), mu_w, rtol=1e-9)


def test_amplitude_exit_attenuation_matches_uniform():
    water, _ = _mats(tm, **KW)
    txm = tm.TXMMaterial.create(
        indexGrid=np.zeros((8, 8, 8), np.uint8),
        limits={'x': (-1.0, 1.0), 'y': (-1.0, 1.0), 'z': (0.0, 0.1)},
        materialsIndex=(water,), device='cpu')
    E, bidn, z4 = T([12000.0] * 4), T([-1.0] * 4), T(np.zeros(4))
    rs, rp, mu, nk = txm.get_amplitude(
        E, bidn, fromVacuum=False, x=z4, y=z4, z=z4, a=z4, b=z4,
        c=T(np.ones(4)), tMax=T([0.1] * 4))
    mu_w = float(water.get_absorption_coefficient(T([12000.0]))[0])
    assert np.allclose(mu.numpy(), mu_w, rtol=1e-9)
    rs_ref = water.get_amplitude(E, bidn, fromVacuum=False)[0]
    assert np.allclose(rs.numpy(), rs_ref.numpy(), rtol=1e-9)


def test_h5_roundtrip(tmp_path):
    h5py = pytest.importorskip('h5py')
    water, gold = _mats(tm, **KW)
    grid = np.zeros((6, 5, 4), np.uint8)
    grid[3:] = 1
    path = str(tmp_path / 'sample.h5')
    with h5py.File(path, 'w') as h5:
        ds = h5.create_dataset('indexGrid', data=grid, dtype='u1')
        ds.attrs['axisOrder'] = 'zyx'
        ds.attrs['backgroundIndex'] = 0
        limits = h5.create_group('limits')
        limits.create_dataset('x', data=[-0.025, 0.025])
        limits.create_dataset('y', data=[-0.025, 0.025])
        limits.create_dataset('z', data=[0.0, 0.050])
    txm = tm.TXMMaterial.create(fileName=path,
                                materialsIndex={0: water, 1: gold},
                                device='cpu')
    assert txm.grid_shape == (6, 5, 4)
    assert txm.backgroundIndex == 0
    assert txm.get_material_indices(
        T(np.zeros(2)), T(np.zeros(2)), T([0.01, 0.04])).tolist() == [0, 1]


def test_txm_through_plate_e2e():
    """A Plate carrying the voxel material attenuates each ray by its
    chord: water on one side, gold on the other."""
    water, gold = _mats(tm, **KW)
    grid = np.zeros((8, 8, 8), np.uint8)
    grid[:, :, 4:] = 1
    txm = tm.TXMMaterial.create(
        indexGrid=grid,
        limits={'x': (-1.0, 1.0), 'y': (-1.0, 1.0), 'z': (0.0, 0.1)},
        materialsIndex=(water, gold), device='cpu')
    plate = to.Plate.create(center=(0, 1000.0, 0), pitch=math.pi / 2,
                            material=txm, t=0.1, limPhysX=(-2, 2),
                            limPhysY=(-2, 2))
    src = GeometricSource.create(
        nrays=1000, distx='flat', dx=1.6, distz='flat', dz=0.5,
        distxprime=None, distzprime=None, dxprime=0.0, dzprime=0.0,
        energies=(9000.0,), distE='lines', **KW)
    beam = src.shine(torch.Generator().manual_seed(0))
    glo, _, _ = plate.double_refract(beam)
    good = (glo.state == 1).numpy()
    assert good.mean() > 0.9
    I = (glo.Jss + glo.Jpp).numpy()
    x0 = beam.x.numpy()
    water_side, gold_side = good & (x0 < -0.1), good & (x0 > 0.1)
    assert water_side.sum() > 100 and gold_side.sum() > 100
    mu_w = float(water.get_absorption_coefficient(T([9000.0]))[0])
    mu_g = float(gold.get_absorption_coefficient(T([9000.0]))[0])
    assert np.allclose(I[water_side], np.exp(-mu_w * 0.01), rtol=1e-6)
    assert np.allclose(I[gold_side], np.exp(-mu_g * 0.01), rtol=1e-5)
