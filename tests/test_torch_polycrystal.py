"""The port's powder, crystal harmonics and monocrystal against the JAX
package.

* The d-spacing tables and reflex tables equal the JAX package's.
* ``reflect_multi_hkl`` of a powder (crystallite normals from
  ``random_orientation``), a monocrystal and the harmonics on the same
  rays, with the JAX package's Gumbel draws injected, to 1e-9 (float64):
  directions, amplitudes, the chosen reflex.
* A powder layer on a flat sample through ``reflect`` (orientation, depth
  and Gumbel draws injected) to 1e-9, and ``run_ray_tracing`` of
  ``examples/15_xrd_powder.py``'s rings in both packages: the same
  histograms to 1e-9 of their totals.
* ``tests/test_polycrystal.py``'s checks on the port's own draws: the
  harmonics pick the fundamental and the third harmonic at their Bragg
  angles, Bragg-matched powder crystallites scatter onto the 111 cone with
  the plateau reflectivity, random crystallites cluster on it, the chi
  window, the monocrystal's symmetric cut.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
import xrt_tpu.oes as jo
from xrt_tpu.materials.polycrystal import _d_spacing_table as j_dtab
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu_torch import materials as tm, oes as to
from xrt_tpu_torch.materials.polycrystal import _d_spacing_table as t_dtab
from xrt_tpu_torch.physconsts import CH
from xrt_tpu_torch.screens import Screen
from test_torch_dcm import compare, jax_beam, port_beam, rays_np
from test_torch_materials import trace_both

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
A_SI = 5.430710
CU_KA = 8047.8


def T(v):
    return torch.from_numpy(np.asarray(v, np.float64))


MATERIALS = {
    'powder': lambda mod, kw: mod.Powder.create(hkl=(3, 3, 3), a=A_SI,
                                                name='Si', **kw),
    'powder_chi': lambda mod, kw: mod.Powder.create(
        hkl=(2, 2, 2), chi=(0.2, 1.0), a=A_SI, t=0.1, name='Si', **kw),
    'harmonics': lambda mod, kw: mod.CrystalHarmonics.create(
        Nmax=3, hkl=(1, 1, 1), a=A_SI, name='Si', **kw),
    'monocrystal': lambda mod, kw: mod.MonoCrystal.create(
        Nmax=2, hkl=(1, 1, 1), a=A_SI, name='Si', **kw),
    'monocrystal_laue': lambda mod, kw: mod.MonoCrystal.create(
        Nmax=1, hkl=(1, 0, 0), a=A_SI, name='Si', t=0.05,
        geom='Laue reflected', **kw),
}


def pair(name):
    return MATERIALS[name](jm, {}), MATERIALS[name](tm, KW)


@pytest.mark.parametrize('name', sorted(MATERIALS))
def test_reflex_tables_match_jax(name):
    j, t = pair(name)
    assert t.resolved_kind() == j.resolved_kind()
    for a, b in zip(t.reflex_tables(), j.reflex_tables()):
        np.testing.assert_array_equal(a, b)
    tab = np.array([[1, 1, 1], [2, 2, 0], [4, 0, 0], [1, 2, 3]], np.int32)
    for cell in ((5.43, 5.43, 5.43, 90, 90, 90),
                 (4.9, 4.9, 5.4, 90, 90, 120), (5.0, 6.0, 7.0, 80, 95, 100)):
        np.testing.assert_array_equal(t_dtab(*cell, tab), j_dtab(*cell, tab))


def gumbels(key, n, nchunks):
    """The JAX package's Gumbel draws of reflect_multi_hkl(key, ...)."""
    kg = jax.random.fold_in(key, 7)
    return [T(jax.random.gumbel(jax.random.fold_in(kg, ic), (n, 16),
                                jnp.float64)) for ic in range(nchunks)]


def _nchunks(mat):
    return (mat.reflex_tables()[0].shape[0] + 15) // 16


@pytest.mark.parametrize('name', sorted(MATERIALS))
def test_reflect_multi_hkl_matches_jax(name):
    j, t = pair(name)
    n = 500
    rng = np.random.RandomState(11)
    E = rng.uniform(7000.0, 20000.0, n)
    a, c = rng.normal(0, 0.02, n), rng.normal(0, 0.02, n)
    b = np.sqrt(1 - a * a - c * c)
    key = jax.random.PRNGKey(5)
    if name.startswith('powder'):
        k1, k2 = jax.random.split(jax.random.PRNGKey(2))
        u = [jax.random.uniform(k, (n,), jnp.float64) for k in (k1, k2)]
        nb_j = j.random_orientation(jax.random.PRNGKey(2), n, jnp.float64)
        nb_t = t.random_orientation(None, n, F64, 'cpu',
                                    draws=[T(v) for v in u])
        for x, y in zip(nb_t, nb_j):
            np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                       rtol=1e-13, atol=1e-15)
        nb = tuple(np.asarray(v) for v in nb_j)
        ns = nb
    else:
        tilt = rng.normal(0, 0.3, (3, n)) + np.array([[0.], [0.], [1.]])
        tilt /= np.linalg.norm(tilt, axis=0)
        nb = tuple(tilt)
        ns = (np.zeros(n), np.zeros(n), np.ones(n))
    ref = j.reflect_multi_hkl(key, jnp.asarray(E),
                              tuple(jnp.asarray(v) for v in (a, b, c)),
                              tuple(jnp.asarray(v) for v in nb),
                              tuple(jnp.asarray(v) for v in ns))
    got = t.reflect_multi_hkl(None, T(E), tuple(T(v) for v in (a, b, c)),
                              tuple(T(v) for v in nb),
                              tuple(T(v) for v in ns),
                              gumbel=gumbels(key, n, _nchunks(t)))
    # a ray whose chosen amplitude is infinite in the JAX package is left
    # out: at a singular point of the two-beam formula XLA's complex
    # division gives inf, which the JAX package keeps (and picks), and
    # PyTorch's NaN, which the port zeroes; one of 500 in the thin Laue
    # monocrystal
    ok = np.isfinite(np.abs(np.asarray(ref[3])))
    assert ok.mean() > 0.99
    for g, r in zip(got[:3], ref[:3]):
        assert np.abs(g.numpy() - np.asarray(r))[ok].max() < 1e-9
    peak = max(np.abs(np.asarray(r))[ok].max() for r in ref[3:])
    assert peak > 1e-2
    for g, r in zip(got[3:], ref[3:]):
        assert np.abs(g.numpy() - np.asarray(r))[ok].max() < 1e-9 * peak


def powder_sample(mod, **kw):
    return (jo if mod is jm else to).FlatMirror.create(
        center=(0, 1000.0, 0), pitch=math.pi / 4,
        material=mod.Powder.create(hkl=(3, 3, 3), a=A_SI, t=0.1, name='Si',
                                   **kw),
        limPhysX=(-2, 2), limPhysY=(-3, 3))


def powder_draws(key, n, nchunks):
    """The JAX package's draws of a powder reflect with *key*: the
    crystallites' orientation, the depth and the Gumbel draws."""
    kp1, kp2, k3 = jax.random.split(key, 3)
    k1, k2 = jax.random.split(kp1)
    _, kmat = jax.random.split(k3)
    return dict(
        orientation=[T(jax.random.uniform(k, (n,), jnp.float64))
                     for k in (k1, k2)],
        depth=T(jax.random.uniform(kp2, (n,), jnp.float64)),
        gumbel=gumbels(kmat, n, nchunks))


def pencil_rays(n, seed):
    d = rays_np(n, seed=seed, dE=0.0, div=0.0, size=(0.1, 0.1))
    d.update(E=np.full(n, CU_KA), a=np.zeros(n), b=np.ones(n),
             c=np.zeros(n))
    return d


def test_powder_reflect_matches_jax():
    n = 400
    d = pencil_rays(n, 12)
    j, t = powder_sample(jm), powder_sample(tm, **KW)
    key = jax.random.PRNGKey(8)
    jg, jl = jax.jit(lambda b: j.reflect(b, key))(jax_beam(d))
    tg, tl = t.reflect(port_beam(d), draws=powder_draws(
        key, n, _nchunks(t.material)))
    compare(tg, jg)
    compare(tl, jl)
    assert float((tg.Jss + tg.Jpp).max()) > 1e-4


def test_powder_rings_trace_matches_jax():
    """``examples/15_xrd_powder.py``: Si powder (hkl up to 333), Cu K-alpha,
    a flat detector 150 mm behind the sample."""
    n = 600
    d = pencil_rays(n, 13)
    j, t = powder_sample(jm), powder_sample(tm, **KW)
    key = jax.random.PRNGKey(9)
    draws = powder_draws(key, n, _nchunks(t.material))
    scr = dict(center=(0, 1150.0, 0))
    jscr, tscr = JScreen.create(**scr), Screen.create(**scr)

    def jproc(bl, k):
        return {'screen': jscr.expose(j.reflect(jax_beam(d), key)[0])}

    def tproc(bl, rng):
        return {'screen': tscr.expose(t.reflect(port_beam(d),
                                                draws=draws)[0])}
    trace_both(jproc, tproc, (
        dict(label='x', unit='mm', bins=16, limits=[-150, 150]),
        dict(label='z', unit='mm', bins=16, limits=[-150, 150]),
        dict(label='theta', unit='deg', data='theta',
             factor=180 / math.pi, bins=16, limits=[0, 90])))


# ---- tests/test_polycrystal.py's physical checks, the port alone ----------

def _plateau_angle(crystal, E):
    return float(crystal.get_Bragg_angle(E) - crystal.get_dtheta(E))


def _beam_at(theta, n, E):
    Et = torch.full((n,), E, dtype=F64)
    a = torch.zeros_like(Et)
    b = torch.full_like(Et, math.cos(theta))
    c = torch.full_like(Et, -math.sin(theta))
    nb = (torch.zeros_like(Et), torch.zeros_like(Et), torch.ones_like(Et))
    return Et, (a, b, c), nb


@pytest.mark.parametrize('hkl,E', [((1, 1, 1), 9000.0),
                                   ((3, 3, 3), 27000.0)])
def test_harmonics_pick_the_bragg_matched_reflex(hkl, E):
    mat = tm.CrystalHarmonics.create(Nmax=3, hkl=(1, 1, 1), a=A_SI,
                                     name='Si', **KW)
    plain = tm.CrystalFromCell.create(hkl=hkl, a=A_SI, name='Si', **KW)
    theta = _plateau_angle(plain, E)
    Et, abc, nb = _beam_at(theta, 16, E)
    aO, bO, cO, rs, rp = mat.reflect_multi_hkl(None, Et, abc, nb, nb)
    assert np.allclose(cO.numpy(), math.sin(theta), atol=1e-5)
    ref_s, _ = plain.get_amplitude(Et, -math.sin(theta) *
                                   torch.ones_like(Et))
    assert float(rs.abs()[0]) > 0.5
    np.testing.assert_allclose(rs.abs().numpy(), ref_s.abs().numpy(),
                               rtol=1e-6)


def test_powder_bragg_matched_crystallites():
    mat = tm.Powder.create(hkl=(1, 1, 1), a=A_SI, name='Si', **KW)
    plain = tm.CrystalFromCell.create(hkl=(1, 1, 1), a=A_SI, name='Si',
                                      **KW)
    theta = _plateau_angle(plain, CU_KA)
    n = 256
    E = torch.full((n,), CU_KA, dtype=F64)
    phi = torch.rand(n, generator=torch.Generator().manual_seed(5),
                     dtype=F64) * 2 * math.pi
    nrm = (torch.cos(phi) * math.cos(theta),
           torch.full_like(E, -math.sin(theta)),
           torch.sin(phi) * math.cos(theta))
    abc = (torch.zeros_like(E), torch.ones_like(E), torch.zeros_like(E))
    aO, bO, cO, rs, rp = mat.reflect_multi_hkl(
        torch.Generator().manual_seed(6), E, abc, nrm, nrm)
    assert np.allclose(bO.numpy(), math.cos(2 * theta), atol=1e-6)
    ref_s, _ = plain.get_amplitude(E, -math.sin(theta) * torch.ones_like(E))
    np.testing.assert_allclose(rs.abs().numpy(), ref_s.abs().numpy(),
                               rtol=1e-6)
    assert float(rs.abs()[0]) > 0.8


def test_powder_random_cone_clustering_and_chi_window():
    mat = tm.Powder.create(hkl=(1, 1, 1), a=A_SI, name='Si', **KW)
    n = 20000
    E = torch.full((n,), CU_KA, dtype=F64)
    g = torch.Generator().manual_seed(2)
    r = mat.random_orientation(g, n, F64, 'cpu')
    abc = (torch.zeros_like(E), torch.ones_like(E), torch.zeros_like(E))
    aO, bO, cO, rs, rp = mat.reflect_multi_hkl(g, E, abc, r, r)
    I = (rs.abs() ** 2 + rp.abs() ** 2).numpy()
    assert I.sum() > 0
    two_theta = np.arccos(np.clip(bO.numpy(), -1, 1))
    tt111 = 2 * math.asin(CH / CU_KA / (2 * A_SI / math.sqrt(3)))
    assert abs(float((I * two_theta).sum() / I.sum()) - tt111) < 0.05
    win = tm.Powder.create(hkl=(1, 1, 1), chi=(0.0, 0.1), a=A_SI, name='Si',
                           **KW)
    rx, ry, rz = (v.numpy() for v in win.random_orientation(
        torch.Generator().manual_seed(3), 2000, F64, 'cpu'))
    chi = np.arctan2(ry, rx)
    ok = rx ** 2 + ry ** 2 > 1e-12
    assert np.all(chi[ok] >= -1e-9) and np.all(chi[ok] <= 0.1 + 1e-9)
    assert np.all(rz >= 0)


def test_monocrystal_symmetric_cut_matches_plain_crystal():
    mat = tm.MonoCrystal.create(Nmax=1, hkl=(1, 1, 1), a=A_SI, name='Si',
                                **KW)
    plain = tm.CrystalFromCell.create(hkl=(1, 1, 1), a=A_SI, name='Si',
                                      **KW)
    theta = _plateau_angle(plain, 9000.0)
    Et, abc, nb = _beam_at(theta, 128, 9000.0)
    aO, bO, cO, rs, rp = mat.reflect_multi_hkl(
        torch.Generator().manual_seed(4), Et, abc, nb, nb)
    sel = np.isclose(cO.numpy(), math.sin(theta), atol=1e-5)
    assert sel.mean() > 0.95
    ref_s, _ = plain.get_amplitude(Et[:1], -torch.full((1,), math.sin(theta),
                                                       dtype=F64))
    np.testing.assert_allclose(rs.abs().numpy()[sel],
                               float(ref_s.abs()[0]), rtol=1e-3)


def test_powder_on_flat_plate_e2e():
    """tests/test_polycrystal.py: a powder sample at normal incidence
    through ``reflect``, the port's own draws: the scattered intensity
    concentrates on the 111 cone."""
    from xrt_tpu_torch.sources import GeometricSource
    plate = to.FlatMirror.create(
        center=(0, 1000.0, 0), pitch=math.pi / 2,
        material=tm.Powder.create(hkl=(1, 1, 1), a=A_SI, t=0.1, name='Si',
                                  **KW),
        limPhysX=(-20, 20), limPhysY=(-20, 20))
    src = GeometricSource.create(nrays=5000, dx=0.5, dz=0.5,
                                 energies=(CU_KA,), distE='lines', **KW)
    glo, _ = plate.reflect(src.shine(torch.Generator().manual_seed(7)),
                           torch.Generator().manual_seed(8))
    good = glo.state.numpy() == 1
    assert good.mean() > 0.95
    I = (glo.Jss + glo.Jpp).numpy()[good]
    two_theta = np.arccos(np.clip(glo.b.numpy()[good], -1, 1))
    tt111 = 2 * math.asin(CH / CU_KA / (2 * A_SI / math.sqrt(3)))
    assert abs(float((I * two_theta).sum() / max(I.sum(), 1e-30)) -
               tt111) < 0.1


def test_reflect_makes_a_stream_only_when_it_draws(monkeypatch):
    """A reflect with no generator makes one seed-0 stream, at its first
    draw: none for a mirror, one for a powder's three draws (orientation,
    depth, reflex), which then equal those of an explicit seed-0
    generator."""
    from xrt_tpu_torch.oes import base
    from xrt_tpu_torch.sources import GeometricSource
    made = []
    rng = base._rng
    monkeypatch.setattr(base, '_rng', lambda g, like: made.append(g) or
                        rng(g, like))
    src = GeometricSource.create(nrays=200, dx=0.5, dz=0.5,
                                 energies=(CU_KA,), distE='lines', **KW)
    beam = src.shine(torch.Generator().manual_seed(7))
    geo = dict(center=(0, 1000.0, 0), pitch=math.pi / 2,
               limPhysX=(-20, 20), limPhysY=(-20, 20))
    to.FlatMirror.create(material=tm.Material.create('Si', rho=2.33, **KW),
                         **geo).reflect(beam)
    assert made == []
    plate = to.FlatMirror.create(
        material=tm.Powder.create(hkl=(1, 1, 1), a=A_SI, t=0.1, name='Si',
                                  **KW), **geo)
    glo = plate.reflect(beam)[0]
    assert made == [None]
    ref = plate.reflect(beam, torch.Generator().manual_seed(0))[0]
    for k in ('x', 'y', 'z', 'a', 'b', 'c', 'Jss', 'Jpp'):
        assert torch.equal(getattr(glo, k), getattr(ref, k)), k
