"""The port's gratings, zone plates and transmitting materials against the
JAX package.

* ``reflect`` of the 'grating' and 'FZP' kinds on the same numpy rays as
  the JAX package, float64 (JAX eagerly, under ``jax.disable_jit()``: its
  jit folds the constants of k t, one ulp of ~5e9 rad), every field and
  the recorded order to 1e-9 (the fields with each side's propagation
  phase k t taken out): a ruled ``Grating`` (a 'grating' Fresnel
  material, an ``EmptyMaterial``, tabulated efficiencies, one order and a
  per-ray order), a VLS grating, a ``gratingDensity`` on a flat mirror,
  ``NormalFZP`` and ``GeneralFZPin0YZ``; the grating equation and the
  share of several orders (``tests/test_gratings.py``); a zone plate that
  focuses.
* The surfaces and grating vectors (``local_g``, ``local_z``, ``local_n``,
  ``analytic_intersect``, ``rays_good``) of every class of
  ``oes/gratings.py`` against the JAX package on grids that cross groove
  and zone edges, to 1e-12.
* ``Material.get_amplitude`` of the transmitting kinds ('plate', 'lens'
  with the tf factor, 'FZP' unit amplitudes) from vacuum and into it, and
  ``EmptyMaterial``, to 1e-12; grating efficiencies from a constant and
  an energy table.
* ROADMAP C14: the JAX package's float32 ``NormalFZP`` (run in a
  subprocess with x64 off) finds one zone index (60 in float64) and no
  open sample at BASELINE configuration 5's zone plate (f = 2000 mm,
  9 keV, N = 60); the port's cancellation-free zone index gives the
  float64 open fraction (0.501 of the plate's area) in float32 within
  1e-3, and its float64 mask equals the JAX package's except within 1e-9
  zones of an edge.
"""
import torch_harness  # noqa: F401

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
import xrt_tpu.oes as joes
from xrt_tpu import beam as jbeam
from xrt_tpu.physconsts import CH, CHBAR
from xrt_tpu_torch import interop
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch import oes as toes
from xrt_tpu_torch.screens import Screen

F64 = torch.float64
CPU = dict(dtype=F64, device='cpu')
E_SOFT, P = 100.0, 10000.0
FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'path', 'Jss', 'Jpp', 'Jsp',
          'Es', 'Ep', 'theta', 'order')


def rays_np(n=600, seed=1, E=E_SOFT, dE=0.0, div=2e-5, size=(0.5, 0.3)):
    rng = np.random.RandomState(seed)
    a = rng.normal(0, div, n)
    c = rng.normal(0, div, n)
    Es = np.exp(1j * rng.uniform(0, 6, n))
    return dict(x=rng.normal(0, size[0], n), y=np.zeros(n),
                z=rng.normal(0, size[1], n), a=a, b=np.sqrt(1 - a**2 - c**2),
                c=c, E=E + dE * rng.uniform(-1, 1, n),
                state=np.ones(n, np.int32), path=np.zeros(n),
                Jss=np.ones(n), Jpp=np.zeros(n), Jsp=np.zeros(n, complex),
                Es=Es, Ep=np.zeros(n, complex))


def jax_beam(d):
    return jbeam.Beam(**{k: jnp.asarray(v) for k, v in d.items()})


def port_beam(d, dtype=F64):
    return interop.beam_from_numpy(d, device='cpu', dtype=dtype)


def _without_kt(beam, v):
    """A field with the propagation phase k t of its own path taken out:
    the path after a search is ~1e4 mm, where one ulp is ~1e-6 rad of
    k t at 100 eV."""
    arg = 1e7 * np.asarray(beam.E) / CHBAR * np.asarray(beam.path)
    return v * np.exp(-1j * arg)


def compare(t, j, tol=1e-9):
    pos = max(1.0, max(float(np.abs(np.asarray(getattr(j, f))).max())
                       for f in 'xyz'))
    for f in FIELDS:
        jv = getattr(j, f)
        if jv is None:
            assert getattr(t, f) is None, f
            continue
        jv = np.asarray(jv)
        tv = getattr(t, f).numpy()
        if f in ('Es', 'Ep'):
            tv, jv = _without_kt(t, tv), _without_kt(j, jv)
        scale = pos if f in 'xyz' else \
            1.0 if f in 'abc' else max(float(np.abs(jv).max()), 1e-300)
        assert np.abs(tv - jv).max() / scale < tol, f
    np.testing.assert_array_equal(t.state.numpy(), np.asarray(j.state))


def materials(kind):
    """(port, JAX) materials of a kind: 'empty', 'au_grating', 'eff',
    'au_fzp'."""
    if kind == 'empty':
        return tm.EmptyMaterial(kind='grating'), \
            jm.EmptyMaterial(kind='grating')
    kw = dict(rho=19.3)
    if kind == 'eff':
        kw.update(kind='grating', efficiency=[(1, 0.36), (0, 0.04),
                                              (-1, 0.09)])
    else:
        kw['kind'] = 'grating' if kind == 'au_grating' else 'FZP'
    return tm.Material.create('Au', **kw, **CPU), \
        jm.Material.create('Au', **kw)


GR = dict(center=(0, P, 0), pitch=math.radians(5.0), limPhysX=(-20, 20),
          limPhysY=(-100, 100))
FZP_E, FZP_F = 1000.0, 50.0
REFLECT_CASES = {
    'grating_empty': ('Grating', dict(GR, rho=300.0), 'empty', E_SOFT),
    'grating_fresnel_order2': ('Grating', dict(GR, rho=300.0, order=2),
                               'au_grating', E_SOFT),
    'grating_vls': ('Grating', dict(GR, rho=600.0,
                                    vlsCoeffs=(2e-4, 3e-7, -1e-9)),
                    'au_grating', E_SOFT),
    'grating_efficiency_order1': ('Grating', dict(GR, rho=600.0,
                                                  pitch=0.1),
                                  'eff', E_SOFT),
    'density_on_flat_mirror': ('FlatMirror',
                               dict(GR, gratingDensity=['y', 400.0, 1.0,
                                                        3e-4, 2e-7]),
                               'au_grating', E_SOFT),
    'density_along_x': ('FlatMirror',
                        dict(GR, gratingDensity=['x', 50.0]),
                        'au_grating', E_SOFT),
    'normal_fzp': ('NormalFZP', dict(f=FZP_F, E=FZP_E, N=500,
                                     center=(0, P, 0), pitch=math.pi / 2),
                   'au_fzp', FZP_E),
    'general_fzp': ('GeneralFZPin0YZ',
                    dict(f1=(0, 0, -P), f2=(0, 0, 80.0), E=FZP_E,
                         center=(0, P, 0), pitch=math.pi / 2,
                         limPhysX=(-1, 1), limPhysY=(-1, 1)),
                    'au_fzp', FZP_E),
}


@pytest.mark.parametrize('case', sorted(REFLECT_CASES))
def test_reflect_matches_jax(case):
    cls, kw, mat, E = REFLECT_CASES[case]
    tmat, jmat = materials(mat)
    t = getattr(toes, cls).create(material=tmat, **kw)
    j = getattr(joes, cls).create(material=jmat, **kw)
    fzp = 'fzp' in case
    rays = rays_np(E=E, dE=0.02 * E, size=(0.05, 0.05) if fzp else (0.5, 0.3),
                   div=2e-6 if fzp else 2e-5)
    with jax.disable_jit():
        jg, jl = j.reflect(jax_beam(rays))
    tg, tl = t.reflect(port_beam(rays))
    compare(tg, jg)
    compare(tl, jl)
    good = tg.state.numpy() == 1
    assert good.sum() > 100
    if case == 'normal_fzp':
        assert 0.2 < good.mean() < 0.8


def test_per_ray_orders_match_jax():
    tmat, jmat = materials('eff')
    t = toes.Grating.create(material=tmat, **dict(GR, rho=600.0))
    j = joes.Grating.create(material=jmat, **dict(GR, rho=600.0))
    orders = np.resize([1.0, 0.0, -1.0, 2.0], 600)
    t = t.replace(order=torch.from_numpy(orders))
    j = j.replace(order=jnp.asarray(orders))
    rays = rays_np(dE=2.0)
    with jax.disable_jit():
        jg, _ = j.reflect(jax_beam(rays))
    tg, _ = t.reflect(port_beam(rays))
    compare(tg, jg)
    I = (tg.Jss + tg.Jpp).numpy()
    np.testing.assert_allclose(I[orders == 1], 0.36, rtol=1e-12)
    np.testing.assert_allclose(I[orders == 2], 0.0, atol=1e-30)


def _plane_source_rays(n, E):
    rays = rays_np(n=n, E=E, div=0.0, size=(0.0, 0.0))
    rays['x'] = np.zeros(n)
    rays['z'] = np.zeros(n)
    return rays


def test_grating_equation_and_orders():
    """sin(beta) = sin(alpha) - m rho lambda, the order on the beam, and
    rays shared evenly among a tuple of orders."""
    pitch, rho = math.radians(5.0), 300.0
    for order in (1, -1, 2):
        gr = toes.Grating.create(rho=rho, material=tm.EmptyMaterial(
            kind='grating'), order=order, **dict(GR, pitch=pitch))
        glo, _ = gr.reflect(port_beam(_plane_source_rays(50, E_SOFT)))
        assert bool((glo.state == 1).all())
        beta = math.atan2(float(glo.c[0]), float(glo.b[0])) - pitch
        lam = CH / E_SOFT * 1e-7
        sinBeta = math.sin(math.pi / 2 - pitch) - order * rho * lam
        np.testing.assert_allclose(beta, math.pi / 2 - math.asin(sinBeta),
                                   rtol=1e-9)
        np.testing.assert_array_equal(glo.order.numpy(), order)
    gr = toes.Grating.create(rho=rho, material=tm.EmptyMaterial(
        kind='grating'), order=(0, 1, 2), **GR)
    glo, _ = gr.reflect(port_beam(_plane_source_rays(3000, E_SOFT)),
                        torch.Generator().manual_seed(7))
    counts = [int((glo.order == m).sum()) for m in (0, 1, 2)]
    assert min(counts) > 850 and sum(counts) == 3000


def test_zone_plate_focuses():
    f, E, N = FZP_F, FZP_E, 500
    fzp = toes.NormalFZP.create(f=f, E=E, N=N, center=(0, P, 0),
                                pitch=math.pi / 2,
                                material=materials('au_fzp')[0])
    rN = math.sqrt(N * f * CH / E * 1e-7)
    rng = np.random.RandomState(3)
    rays = _plane_source_rays(20000, E)
    rays['x'] = rng.uniform(-0.9 * rN, 0.9 * rN, 20000)
    rays['z'] = rng.uniform(-0.9 * rN, 0.9 * rN, 20000)
    glo, _ = fzp.reflect(port_beam(rays))
    good = (glo.state == 1).numpy()
    assert 0.3 < good.mean() < 0.7
    img = Screen.create(center=(0, P + f, 0)).expose(glo)
    r = np.hypot(img.x.numpy(), img.z.numpy())[good]
    assert r.mean() < 0.1 * rN


def _grid(lim, n=257):
    x = np.linspace(-lim, lim, n)
    X, Y = np.meshgrid(x, x * 1.3)
    return X.ravel(), Y.ravel()


SURFACE_CASES = {
    'grating_vls': ('Grating', dict(rho=600.0, vlsCoeffs=(2e-4, 3e-7)),
                    3.0),
    'normal_fzp': ('NormalFZP', dict(f=FZP_F, E=FZP_E, N=500), 0.25),
    'normal_fzp_white_centre': ('NormalFZP', dict(f=FZP_F, E=FZP_E, N=100,
                                                  isCentralZoneBlack=False),
                                0.12),
    'general_fzp_virtual': ('GeneralFZPin0YZ',
                            dict(f1=(0.1, 0, -500.0), f2=(0, 0.2, 90.0),
                                 E=FZP_E, f2isVirtual=True), 0.5),
    'laminar': ('LaminarGrating', dict(rho=500.0, aspect=0.4, depth=2e-3),
                0.02),
    'vls_laminar': ('VLSLaminarGrating', dict(rho=500.0, aspect=0.3,
                                              depth=1e-3,
                                              coeffs=(1.0, 2e-3, 1e-5)),
                    0.02),
    'flat_density': ('FlatMirror', dict(gratingDensity=['y', 300.0, 1.0,
                                                        1e-3]), 5.0),
}


@pytest.mark.parametrize('case', sorted(SURFACE_CASES))
def test_surfaces_and_grating_vectors_match_jax(case):
    cls, kw, lim = SURFACE_CASES[case]
    t = getattr(toes, cls).create(**kw)
    j = getattr(joes, cls).create(**kw)
    xn, yn = _grid(lim)
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    jx, jy = jnp.asarray(xn), jnp.asarray(yn)
    if hasattr(j, 'local_g') and cls not in ('LaminarGrating',
                                             'VLSLaminarGrating'):
        for tg, jg in zip(t.local_g(x, y), j.local_g(jx, jy)):
            jg = np.broadcast_to(np.asarray(jg), xn.shape)
            scale = max(np.abs(jg).max(), 1e-300)
            assert np.abs(tg.numpy() - jg).max() / scale < 1e-12
    for tv, jv in zip([t.local_z(x, y)] + list(t.local_n(x, y)),
                      [j.local_z(jx, jy)] + list(j.local_n(jx, jy))):
        np.testing.assert_allclose(tv.numpy(), np.broadcast_to(
            np.asarray(jv), xn.shape), rtol=1e-12, atol=1e-15)
    state = np.ones(xn.shape, np.int32)
    np.testing.assert_array_equal(
        t.rays_good(x, y, torch.from_numpy(state)).numpy(),
        np.asarray(j.rays_good(jx, jy, jnp.asarray(state))))
    if hasattr(j, 'analytic_intersect'):
        rng = np.random.RandomState(2)
        n = xn.size
        a = rng.normal(0, 1e-3, n)
        b = np.full(n, math.cos(0.02))
        c = -np.full(n, math.sin(0.02))
        z0 = np.full(n, 0.5)
        args = (np.full(n, -1.0), np.full(n, 1e3), xn, yn, z0, a, b, c)
        got = t.analytic_intersect(*(torch.from_numpy(v) for v in args))
        ref = j.analytic_intersect(*(jnp.asarray(v) for v in args))
        for g, r in zip(got[:4], ref[:4]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('kind', ['plate', 'lens', 'FZP'])
@pytest.mark.parametrize('fromVacuum', [True, False])
def test_transmitting_amplitudes_match_jax(kind, fromVacuum):
    E = np.linspace(5000.0, 15000.0, 41)
    cosA = np.linspace(-1.0, -0.05, 41)
    t = tm.Material.create(['Be', 'O'], quantities=[1, 1], rho=3.01,
                           kind=kind, **CPU)
    j = jm.Material.create(['Be', 'O'], quantities=[1, 1], rho=3.01,
                           kind=kind)
    got = t.get_amplitude(torch.from_numpy(E), torch.from_numpy(cosA),
                          fromVacuum)
    ref = j.get_amplitude(jnp.asarray(E), jnp.asarray(cosA), fromVacuum)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                   atol=1e-15 * max(np.abs(r).max(), 1.0))
    if kind == 'FZP':
        np.testing.assert_array_equal(got[0].numpy(), 1.0)
    else:
        # a plate's transmittivity is just under 1 at normal incidence
        assert 0.9 < float(torch.abs(got[0][0])) <= 1.0 + 1e-12
    with pytest.raises(ValueError):
        tm.Material.create('Be', rho=1.85, kind='prism', **CPU).get_amplitude(
            torch.from_numpy(E), torch.from_numpy(cosA))


def test_empty_material_and_grating_efficiency(tmp_path):
    E = torch.linspace(5000.0, 9000.0, 5, dtype=F64)
    em = tm.EmptyMaterial()
    assert em.resolved_kind('grating') == 'mirror'
    assert tm.EmptyMaterial(kind='auto').resolved_kind('grating') == \
        'grating'
    rs, rp, mu, ph = em.get_amplitude(E, -0.5 * torch.ones_like(E))
    assert bool((rs == 1).all() and (rp == 1).all() and (mu == 0).all())
    assert bool((em.get_refractive_index(E) == 1).all())
    assert bool((em.get_absorption_coefficient(E) == 0).all())
    tab = np.array([[8000.0, 0.10, 0.50], [10000.0, 0.30, 0.20]])
    f = str(tmp_path / 'eff.dat')
    np.savetxt(f, tab)
    mat = tm.Material.create('Au', rho=19.3, kind='grating',
                             efficiency=[(1, 2), (0, 1)], efficiencyFile=f,
                             **CPU)
    jmat = jm.Material.create('Au', rho=19.3, kind='grating',
                              efficiency=[(1, 2), (0, 1)], efficiencyFile=f)
    Eq = np.array([7000.0, 9000.0, 9000.0, 9500.0, 11000.0])
    order = np.array([1.0, 1.0, 0.0, 3.0, 0.0])
    ampS, ampP = mat.get_grating_efficiency(torch.from_numpy(Eq),
                                            torch.from_numpy(order))
    np.testing.assert_allclose(ampS.numpy() ** 2,
                               [0.5, 0.35, 0.2, 0.0, 0.3], rtol=1e-12)
    jS, _ = jmat.get_grating_efficiency(jnp.asarray(Eq), jnp.asarray(order))
    np.testing.assert_allclose(ampS.numpy(), np.asarray(jS), rtol=1e-14)
    assert torch.equal(ampS, ampP)


def test_local_g_needs_a_grating_density():
    with pytest.raises(NotImplementedError, match='gratingDensity'):
        toes.FlatMirror.create().local_g(torch.zeros(3, dtype=F64),
                                         torch.zeros(3, dtype=F64))


#: BASELINE configuration 5's zone plate
C5_FZP = dict(f=2000.0, E=9000.0, N=60)
C14_N = 200_000

JAX_F32_FZP = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
from xrt_tpu.oes import NormalFZP
d = np.load(IN)
fzp = NormalFZP.create(**ARGS)
x, y = jnp.asarray(d['x']), jnp.asarray(d['y'])
st = fzp.rays_good(x, y, jnp.ones(x.shape, jnp.int32))
n = fzp._n_of_r(jnp.sqrt(x ** 2 + y ** 2))
np.savez(OUT, state=np.asarray(st), zones=np.asarray(jnp.floor(n)))
print('OK')
'''


def test_c14_float32_zone_index_repaired(clean_env_runner, tmp_path):
    """ROADMAP C14 at configuration 5's zone plate."""
    fzp64 = toes.NormalFZP.create(**C5_FZP)
    rN = fzp64.limPhysX[1]
    rng = np.random.default_rng(14)
    xy = rng.uniform(-rN, rN, (2, C14_N))
    inside = np.hypot(*xy) < rN
    np.savez(tmp_path / 'in.npz', x=xy[0].astype(np.float32),
             y=xy[1].astype(np.float32))
    stdout, _ = clean_env_runner(
        f'IN = {str(tmp_path / "in.npz")!r}\n'
        f'OUT = {str(tmp_path / "out.npz")!r}\nARGS = {C5_FZP!r}\n' +
        JAX_F32_FZP)
    assert 'OK' in stdout
    jax32 = np.load(tmp_path / 'out.npz')
    # the JAX package's float32: one zone index inside the plate, nothing
    # open
    assert len(np.unique(jax32['zones'][inside])) == 1
    assert np.mean(jax32['state'] == 1) == 0.0

    ones = torch.ones(C14_N, dtype=torch.int32)
    x64, y64 = (torch.from_numpy(v) for v in xy)
    st64 = fzp64.rays_good(x64, y64, ones).numpy()
    zones64 = np.floor(fzp64._n_of_r(torch.hypot(x64, y64)).numpy())
    assert len(np.unique(zones64[inside])) == 60     # zones 0 to 59
    open64 = np.mean(st64[inside] == 1)
    assert 0.49 < open64 < 0.51      # equal-area zones, every other open
    # the port's float32 on the same (float32) radii
    x32, y32 = (torch.from_numpy(v.astype(np.float32)) for v in xy)
    st32 = fzp64.rays_good(x32, y32, ones).numpy()
    assert abs(np.mean(st32[inside] == 1) - open64) < 1e-3
    # the port's float64 against the JAX package's float64, away from the
    # zone edges
    jfzp = joes.NormalFZP.create(**C5_FZP)
    jx, jy = jnp.asarray(xy[0]), jnp.asarray(xy[1])
    jst = np.asarray(jfzp.rays_good(jx, jy, jnp.ones(C14_N, jnp.int32)))
    jn = np.asarray(jfzp._n_of_r(jnp.sqrt(jx ** 2 + jy ** 2)))
    far = np.abs(jn - np.round(jn)) > 1e-9
    assert far.mean() > 0.999
    np.testing.assert_array_equal(st64[far], jst[far])
