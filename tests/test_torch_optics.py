"""The port's optics of the wave chain against the JAX package's, float64.

Interpolation, materials (refractive index and Fresnel amplitudes of the
toroid's gold coating), the toroid surface, the OE frames and its
reflection without intersection search, coordinate rotations
and the analytic Gaussian sources (plain, astigmatic, vortex and
Hermite-Gaussian).  Both sides run the same float64 operations eagerly on
the same inputs; tolerance 1e-12 relative to each quantity's largest
value (transcendental functions may differ in the last ulp), 1e-10 for
the Fresnel amplitudes, where complex division and square roots of
nearly cancelling terms enter (the two libraries evaluate them by
different algorithms).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import xrt_tpu.materials as jm
from xrt_tpu import beam as jbeam, transforms as jtr
from xrt_tpu import waves as jw
from xrt_tpu.oes import ToroidMirror as JToroid
from xrt_tpu.ops.interp import fast_interp as j_interp
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu.sources import GaussianBeam as JGauss
from xrt_tpu.sources import polarization_matrix as j_pol
from xrt_tpu_torch import beam as tbeam, interop, transforms as ttr
from xrt_tpu_torch import waves as tw
from xrt_tpu_torch.materials import Material
from xrt_tpu_torch.oes import ToroidMirror
from xrt_tpu_torch.ops.interp import fast_interp
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import (GaussianBeam, make_energy,
                                   polarization_matrix)

F64 = torch.float64
TOL = 1e-12


def close(t, j, tol=TOL):
    """max|t - j| / max|j| < tol; non-finite values must coincide."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    fin = np.isfinite(j)
    np.testing.assert_array_equal(np.isfinite(t), fin)
    t, j = t[fin], j[fin]
    scale = max(float(np.abs(j).max()), 1e-300)
    err = float(np.abs(t - j).max()) / scale
    assert err < tol, err


def T(v):
    return torch.from_numpy(np.ascontiguousarray(v))


def _beam_np(seed, n=257):
    """A random float64 beam as numpy arrays (directions near +y)."""
    rng = np.random.RandomState(seed)
    a, c = rng.uniform(-1e-3, 1e-3, (2, n))
    b = np.sqrt(1 - a ** 2 - c ** 2)
    Es = rng.uniform(0.5, 1, n) * np.exp(1j * rng.uniform(0, 6.28, n))
    Ep = 0.3 * Es * np.exp(0.7j)
    return dict(x=rng.uniform(-2, 2, n), y=rng.uniform(-30, 30, n),
                z=rng.uniform(-0.5, 0.5, n), a=a, b=b, c=c,
                E=rng.uniform(480, 520, n), state=np.ones(n, np.int32),
                path=np.zeros(n), Jss=np.abs(Es) ** 2, Jpp=np.abs(Ep) ** 2,
                Jsp=Es * np.conj(Ep), Es=Es, Ep=Ep)


def _jbeam(d):
    return jbeam.Beam(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_fast_interp_matches_jnp_interp(dtype):
    rng = np.random.RandomState(0)
    xp = np.sort(rng.uniform(10, 3e4, 200))
    fp = rng.uniform(-5, 80, 200)
    x = np.concatenate([rng.uniform(0, 4e4, 1000), xp[:5], [xp[-1]]])
    npdt = np.float64 if dtype == torch.float64 else np.float32
    xp, fp, x = xp.astype(npdt), fp.astype(npdt), x.astype(npdt)
    got = fast_interp(T(x), T(xp), T(fp)).numpy()
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                jnp.asarray(fp)))
    tol = 1e-14 if dtype == torch.float64 else 2e-6
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * 80)
    np.testing.assert_allclose(
        got, np.asarray(j_interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp))), rtol=0, atol=tol * 80)


def test_material_amplitudes_match():
    jmat = jm.Material.create('Au', rho=19.3, kind='mirror')
    tmat = Material.create('Au', rho=19.3, kind='mirror', dtype=F64,
                           device='cpu')
    E = np.linspace(100.0, 3e4, 301)
    close(tmat.get_refractive_index(T(E)),
          jmat.get_refractive_index(jnp.asarray(E)))
    bidn = -np.sin(np.linspace(1e-3, 0.05, 301))
    for fromVacuum in (True, False):
        tr = tmat.get_amplitude(T(E), T(bidn), fromVacuum)
        jr = jmat.get_amplitude(jnp.asarray(E), jnp.asarray(bidn),
                                fromVacuum)
        for a, b in zip(tr, jr):
            close(a, b, 1e-10)
    for kind in ('thin mirror', 'grating'):      # a 20 nm layer
        jk = jm.Material.create('C', rho=2.2, kind=kind, t=2e-5)
        tk_ = Material.create('C', rho=2.2, kind=kind, t=2e-5, dtype=F64,
                              device='cpu')
        for a, b in zip(tk_.get_amplitude(T(E), T(bidn)),
                        jk.get_amplitude(jnp.asarray(E),
                                         jnp.asarray(bidn))):
            close(a, b, 1e-10)


def _toroids():
    R, r = 2.8e5, 10.0
    kw = dict(center=(0, 5000, 0), pitch=6e-3, R=R, r=r, limPhysX=(-3, 3),
              limPhysY=(-40, 40), roll=0.1, yaw=-0.02, positionRoll=0.05)
    jmat = jm.Material.create('Au', rho=19.3, kind='mirror')
    tmat = Material.create('Au', rho=19.3, kind='mirror', dtype=F64,
                           device='cpu')
    return JToroid.create(material=jmat, **kw), \
        ToroidMirror.create(material=tmat, **kw)


def test_toroid_surface_and_frames_match():
    jt, tt = _toroids()
    d = _beam_np(1)
    x, y = d['x'], d['y']
    close(tt.local_z(T(x), T(y)), jt.local_z(jnp.asarray(x),
                                             jnp.asarray(y)))
    for a, b in zip(tt.local_n(T(x), T(y)),
                    jt.local_n(jnp.asarray(x), jnp.asarray(y))):
        close(a, b)
    tb = interop.beam_from_numpy(d, device='cpu', dtype=F64)
    tg = tt.local_to_global(tb)
    jg = jt.local_to_global(_jbeam(d))
    for f in ('x', 'y', 'z', 'a', 'b', 'c', 'Jss', 'Jpp', 'Jsp', 'Es',
              'Ep'):
        close(getattr(tg, f), getattr(jg, f))
    st = tt.rays_good(T(np.linspace(-4, 4, 50)), T(np.linspace(-50, 50, 50)),
                      torch.ones(50, dtype=torch.int32))
    sj = jt.rays_good(jnp.linspace(-4, 4, 50), jnp.linspace(-50, 50, 50),
                      jnp.ones(50, jnp.int32))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_reflect_without_search_matches():
    """Rays placed on the toroid's surface, reflected at t = 0 (the wave
    hops' reflect_wave path)."""
    jt, tt = _toroids()
    d = _beam_np(2)
    d['z'] = np.asarray(jt.local_z(jnp.asarray(d['x']),
                                   jnp.asarray(d['y'])))
    d['b'], d['c'] = d['c'] + 6e-3, -np.sqrt(1 - d['a'] ** 2 -
                                             (d['c'] + 6e-3) ** 2)
    d['a'], d['b'], d['c'] = d['a'], -d['c'], d['b']
    glo = jt.local_to_global(_jbeam(d))
    jg, jl = jt.reflect(glo, noIntersectionSearch=True)
    tglo = interop.beam_from_numpy(
        {f: np.asarray(getattr(glo, f)) for f in d}, device='cpu',
        dtype=F64)
    tg, tl = tt.reflect(tglo, noIntersectionSearch=True)
    for f in ('x', 'y', 'z', 'a', 'b', 'c', 'Jss', 'Jpp', 'Jsp', 'Es', 'Ep',
              'state'):
        close(getattr(tg, f), getattr(jg, f), 1e-11)
        close(getattr(tl, f), getattr(jl, f), 1e-11)
    close(tl.theta, jl.theta, 1e-11)


def test_rotations_and_coherency_match():
    d = _beam_np(4)
    for seq in ('RzRyRx', '-RxRyRz', 'RyRzRx'):
        tr = ttr.rotate_xyz(T(d['x']), T(d['y']), T(d['z']), seq,
                            pitch=0.01, roll=-0.3, yaw=0.2)
        jr = jtr.rotate_xyz(jnp.asarray(d['x']), jnp.asarray(d['y']),
                            jnp.asarray(d['z']), seq, pitch=0.01,
                            roll=-0.3, yaw=0.2)
        for a, b in zip(tr, jr):
            close(a, b)
    roll = np.linspace(-1, 1, d['x'].size)
    tr = tbeam.rotate_coherency_matrix(T(d['Jss']), T(d['Jpp']),
                                       T(d['Jsp']), T(roll))
    jr = jbeam.rotate_coherency_matrix(jnp.asarray(d['Jss']),
                                       jnp.asarray(d['Jpp']),
                                       jnp.asarray(d['Jsp']),
                                       jnp.asarray(roll))
    for a, b in zip(tr, jr):
        close(a, b)


@pytest.mark.parametrize('kind', ['plain', 'astigmatic', 'vortex', 'TEM'])
def test_gaussian_shine_matches(kind):
    kw = dict(center=(0, 0, 0), distE='lines', energies=(500.0,),
              polarization='horizontal', w0=0.05)
    if kind == 'astigmatic':
        kw['w0'] = (0.05, 0.02)
    elif kind == 'vortex':
        kw['vortex'] = (1, 1)
    elif kind == 'TEM':
        kw['TEM'] = (1, 2)
    jsrc, tsrc = JGauss.create(**kw), GaussianBeam.create(**kw)
    jscr = JScreen.create(center=(0, 2000.0, 0))
    tscr = Screen.create(center=(0, 2000.0, 0))
    g = np.linspace(-0.2, 0.2, 15)
    jwv = jw.prepare_wave_on_screen(jscr, jsrc, g, g)
    twv = tw.prepare_wave_on_screen(tscr, tsrc, g, g, dtype=F64,
                                    device='cpu')
    import jax
    jo = jsrc.shine(jax.random.PRNGKey(0), jwv)
    to = tsrc.shine(torch.Generator().manual_seed(0), twv)
    for f in ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'Es', 'Ep', 'Jss', 'Jpp',
              'Jsp', 'path'):
        close(getattr(to, f), getattr(jo, f), 1e-11)


def test_source_helpers():
    for pol in ('horizontal', 'vertical', 'right', 'left', 'unpolarized',
                None, 30.0, (0.7, 0.3, 0.1, -0.2)):
        assert polarization_matrix(pol) == j_pol(pol)
    g = torch.Generator().manual_seed(1)
    E = make_energy(g, 'lines', (500.0,), 7)
    assert torch.equal(E, torch.full((7,), 500.0))
    E = make_energy(g, 'lines', (400.0, 600.0), 2000, (1.0, 3.0),
                    dtype=F64)
    assert set(E.tolist()) == {400.0, 600.0}
    assert 0.7 < float((E == 600.0).double().mean()) < 0.8
    E = make_energy(g, 'flat', (400.0, 600.0), 1000, dtype=F64)
    assert 400.0 <= float(E.min()) and float(E.max()) < 600.0
