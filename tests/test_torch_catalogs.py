"""The port's material catalogs against the JAX package's.

* The five tests of ``tests/test_catalogs.py`` on the port (counts, Ge,
  elemental Au against the direct material, a compound, the attribute
  namespaces) at their tolerances.
* Catalog materials against the JAX package's, float64: crystals' d and
  the structure factors (F0, Fh, Fhbar) and chi's of ``get_F_chi`` to
  1e-12 of |F0| (a forbidden reflection's Fh is rounding noise of ~1e-14
  in both), elemental and compound mirrors' amplitudes at 5 mrad to 1e-12
  of the largest, off absorption edges (at an edge the table
  interpolation's last bits differ: Mo at its K edge, 20 keV, 3e-11).
"""
import torch_harness  # noqa: F401

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xrt_tpu.materials import catalogs as jc
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch.materials import catalogs

CPU = dict(dtype=torch.float64, device='cpu')
E = np.linspace(5000.0, 19000.0, 7)


def test_catalog_counts():
    assert len(catalogs.list_crystals()) == 38
    assert len(catalogs.list_elemental()) == 92
    assert len(catalogs.list_compounds()) == 76


def test_catalog_crystal_ge():
    ge = catalogs.crystal('Ge', hkl=(1, 1, 1), **CPU)
    np.testing.assert_allclose(float(ge.d), 5.6578 / np.sqrt(3), rtol=2e-3)
    E = torch.tensor([10000.0], dtype=torch.float64)
    theta = ge.get_Bragg_angle(E) - ge.get_dtheta(E)
    rs, rp = ge.get_amplitude(E, -torch.sin(theta))
    assert 0.5 < float(torch.abs(rs[0]) ** 2) <= 1.0


def test_catalog_elemental_matches_direct():
    au_cat = catalogs.elemental('Au', kind='mirror', **CPU)
    au_dir = tm.Material.create('Au', rho=au_cat.rho, kind='mirror',
                                table=au_cat.table, **CPU)
    E = torch.linspace(1000, 20000, 20, dtype=torch.float64)
    cos = torch.full_like(E, 5e-3)
    rs1 = au_cat.get_amplitude(E, cos)[0]
    rs2 = au_dir.get_amplitude(E, cos)[0]
    np.testing.assert_allclose(rs1.numpy(), rs2.numpy(), rtol=1e-12)


def test_catalog_compound():
    names = catalogs.list_compounds()
    assert len(names) > 0
    mat = catalogs.compound(names[0], kind='plate', **CPU)
    n = mat.get_refractive_index(torch.tensor([9000.0],
                                              dtype=torch.float64))
    assert 0.9 < float(n.real[0]) < 1.0


def test_catalog_attribute_namespaces():
    from xrt_tpu_torch.materials.catalogs import crystals, elements
    si = crystals.Si(hkl=(1, 1, 1), **CPU)
    assert abs(float(si.d) - 3.1354) < 1e-3
    au = elements.Au(kind='mirror', **CPU)
    assert abs(float(au.rho) - 19.32) < 0.1
    assert 'Si' in dir(crystals)
    with pytest.raises(AttributeError):
        crystals.NotACrystal


@pytest.mark.parametrize('name', ['Si', 'Ge', 'Diamond', 'Sapphire',
                                  'Beryl', 'PET', 'InSb'])
def test_catalog_crystal_matches_jax(name):
    j = jc.crystal(name, hkl=(1, 1, 1))
    t = catalogs.crystal(name, hkl=(1, 1, 1), **CPU)
    assert float(t.d) == pytest.approx(float(j.d), rel=1e-12)
    sto = 0.5 / float(j.d)
    got = [g.numpy() for g in t.get_F_chi(torch.from_numpy(E), sto)]
    want = [np.asarray(w) for w in j.get_F_chi(jnp.asarray(E), sto)]
    F0, chi0 = np.abs(want[0]), np.abs(want[3])
    for k, (g, w) in enumerate(zip(got, want)):
        scale = F0 if k < 3 else chi0
        assert (np.abs(g - w) < 1e-12 * scale).all(), (name, k)


@pytest.mark.parametrize('kind,name', [
    ('elemental', 'Au'), ('elemental', 'Rh'), ('elemental', 'Be'),
    ('elemental', 'Mo'), ('compounds', 'Air'), ('compounds', 'BoronCarbide'),
    ('compounds', 'MolybdenumSilicide')])
def test_catalog_mirror_matches_jax(kind, name):
    factory = 'elemental' if kind == 'elemental' else 'compound'
    j = getattr(jc, factory)(name, kind='mirror')
    t = getattr(catalogs, factory)(name, kind='mirror', **CPU)
    assert (t.rho, t.table, t.quantities) == (j.rho, j.table,
                                              tuple(j.quantities))
    want = np.asarray(j.get_amplitude(jnp.asarray(E), 5e-3)[0])
    got = t.get_amplitude(torch.from_numpy(E),
                          torch.full((len(E),), 5e-3,
                                     dtype=torch.float64))[0].numpy()
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()
