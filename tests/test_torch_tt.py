"""The port's Takagi-Taupin solver against the JAX package and pyTTE.

* ``compute_tt_params(_full)`` (the host side, float64 numpy) against the
  JAX package to 1e-12, isotropic (a Poisson ratio) and anisotropic (the
  elastic constants), Bragg and Laue, cylindrical and 2D-bent, for a
  ``CrystalSi``, a ``CrystalFromCell`` and a d-spacing-only crystal.
* ``tt_amplitudes`` in Bragg, Laue reflected and Laue transmitted, bent
  and flat, symmetric and asymmetric, with and without the
  reflectivity window, against the JAX package (under ``jit``, float64)
  to 1e-9 of the peak amplitude at nsteps 800-4000.
* ``tests/golden/ref_tt.npz`` (pyTTE) at ``tests/test_tt.py``'s limits:
  Bragg (atol 1e-4) and Laue (nsteps 8000, atol 1e-2), sigma and pi,
  cylindrical, spherical and anticlastic.
* The gradient of an integrated reflectivity with respect to 1/R by
  autograd against the JAX package's ``jax.grad`` to 1e-8 (nsteps 800),
  and against a central difference (2%).
* ``tests/test_tt.py``'s physical checks: an unbent crystal's
  amplitudes equal the two-beam ones, bending broadens the curve and
  raises its integral, thick crystals stay stable (the Lawson step).
* float32 against float64 (ROADMAP C17): the port's error no worse than
  the JAX package's own float32 error plus 1e-3 of the peak, the JAX
  side in a subprocess with x64 off.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
from xrt_tpu.materials import tt as jtt
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch.materials import tt as ttt

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
GOLD = 'tests/golden/ref_tt.npz'


def crystals(geom='Bragg reflected', t=0.1, hkl=(1, 1, 1), **kw):
    return (jm.CrystalSi.create(hkl=hkl, t=t, geom=geom, **kw),
            tm.CrystalSi.create(hkl=hkl, t=t, geom=geom, **kw, **KW))


PARAM_CASES = {
    'bragg_cyl': (dict(), dict(alphaAsym=0.0, Rm=2000.0, Rs=np.inf)),
    'laue_cyl': (dict(geom='Laue reflected'),
                 dict(alphaAsym=0.0, Rm=2000.0, Rs=np.inf)),
    'bragg_2d_asym': (dict(hkl=(3, 3, 3)),
                      dict(alphaAsym=0.05, Rm=1000.0, Rs=-4000.0)),
    'laue_sph_rot': (dict(geom='Laue reflected', t=0.3),
                     dict(alphaAsym=-0.1, Rm=3000.0, Rs=3000.0,
                          inPlaneRotation=0.3)),
    'isotropic': (dict(nu=0.22), dict(alphaAsym=0.0, Rm=2000.0, Rs=5000.0)),
}


@pytest.mark.parametrize('case', sorted(PARAM_CASES))
def test_compute_tt_params_match_jax(case):
    ckw, pkw = PARAM_CASES[case]
    j, t = crystals(**ckw)
    a = jtt.compute_tt_params_full(j, **pkw)
    b = ttt.compute_tt_params_full(t, **pkw)
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-24)
    np.testing.assert_allclose(ttt.compute_tt_params(t, **pkw), a[:3],
                               rtol=1e-12, atol=1e-24)


def test_compute_tt_params_other_crystals():
    """A crystal from its cell (alpha-quartz axes) and a d-spacing-only
    crystal (the cubic assumption), against the JAX package."""
    kw = dict(a=5.430710, atoms=[14] * 8)
    j = jm.CrystalFromCell.create('Si', (2, 2, 0), t=0.2, **kw)
    t = tm.CrystalFromCell.create('Si', (2, 2, 0), t=0.2, **kw, **KW)
    pkw = dict(alphaAsym=0.02, Rm=1500.0, Rs=-6000.0)
    np.testing.assert_allclose(ttt.compute_tt_params_full(t, **pkw),
                               jtt.compute_tt_params_full(j, **pkw),
                               rtol=1e-12, atol=1e-24)
    j = jm.CrystalDiamond.create(hkl=(1, 1, 1), d=3.13562, t=0.1,
                                 elements='Si', rho=2.33, name='Si')
    t = tm.CrystalDiamond.create(hkl=(1, 1, 1), d=3.13562, t=0.1,
                                 elements='Si', rho=2.33, name='Si', **KW)
    np.testing.assert_allclose(ttt.compute_tt_params_full(t, **pkw),
                               jtt.compute_tt_params_full(j, **pkw),
                               rtol=1e-12, atol=1e-24)
    assert ttt.isotropic_plate_params(2e6, math.inf, 0.22) == \
        jtt.isotropic_plate_params(2e6, math.inf, 0.22)


def scan_args(geom, thetaB, dth, asym=0.0):
    """(bIn, bOut, bInH) of a rocking scan, float64 numpy; Bragg takes the
    reference's defaults for the last two when symmetric."""
    th = thetaB + dth
    if geom.startswith('Bragg'):
        if asym == 0.0:
            return -np.sin(th), None, None
        return (-np.sin(th + asym), np.sin(th - asym), -np.sin(th))
    return -np.cos(th + asym), -np.cos(th - asym), np.sin(th)


AMP_CASES = {
    # geom, t, Rm, Rs, alphaAsym, nsteps, autoLimits
    'bragg_bent': ('Bragg reflected', 0.1, 2000.0, np.inf, 0.0, 2000, True),
    'bragg_flat_window': ('Bragg reflected', 0.1, None, None, 0.0, 800,
                          True),
    'bragg_asym_2d': ('Bragg reflected', 0.2, 1000.0, -3000.0, 0.03, 1500,
                      False),
    'laue_bent': ('Laue reflected', 0.1, 2000.0, np.inf, 0.0, 2000, True),
    'laue_transmitted': ('Laue transmitted', 0.1, 2000.0, 5000.0, 0.0, 800,
                         True),
    'laue_flat': ('Laue reflected', 0.05, None, None, 0.0, 800, False),
    'bragg_thick_4000': ('Bragg reflected', 0.3, 2000.0, np.inf, 0.0, 4000,
                         False),
}
_JIT = {}


@pytest.mark.parametrize('case', sorted(AMP_CASES))
def test_tt_amplitudes_match_jax(case):
    geom, t, Rm, Rs, asym, nsteps, auto = AMP_CASES[case]
    j, c = crystals(geom=geom, t=t)
    if Rm is None:
        c1 = c2 = ir1 = 0.0
    else:
        c1, c2, ir1 = jtt.compute_tt_params(j, asym, Rm=Rm, Rs=Rs)
    thetaB = float(j.get_Bragg_angle(9000.0))
    dth = np.linspace(-60e-6, 160e-6, 51)
    args = scan_args(geom, thetaB, dth, asym)
    E = np.full(dth.shape, 9000.0)

    def jfn(E, *a):
        return jtt.tt_amplitudes(E, *a, j, c1, c2, ir1, alphaAsym=asym,
                                 nsteps=nsteps, autoLimits=auto)
    ref = jax.jit(jfn)(jnp.asarray(E), *(None if a is None else
                                           jnp.asarray(a) for a in args))
    got = ttt.tt_amplitudes(torch.from_numpy(E),
                            *(None if a is None else torch.from_numpy(a)
                              for a in args), c, c1, c2, ir1,
                            alphaAsym=asym, nsteps=nsteps, autoLimits=auto)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        peak = np.abs(r).max()
        assert peak > 1e-2
        assert np.abs(g.numpy() - r).max() < 1e-9 * peak, case


@pytest.fixture(scope='module')
def gold():
    return np.load(GOLD)


GOLDEN_CASES = [(geom, tag, sign) for geom in ('bragg', 'laue')
                for tag, sign in (('', 0.0), ('_sph', 1.0), ('_acl', -1.0))]


@pytest.mark.parametrize('geom,tag,Rs_sign', GOLDEN_CASES)
def test_pytte_goldens(gold, geom, tag, Rs_sign):
    scan = gold['scan']
    thetaB = float(gold['thetaB'])
    Rm = float(gold['Rm_mm'])
    E = torch.full(scan.shape, float(gold['E0']), dtype=F64)
    th = torch.from_numpy(thetaB + scan)
    Rx = None if Rs_sign == 0 else Rs_sign * Rm
    if geom == 'bragg':
        si = tm.CrystalSi.create(hkl=(1, 1, 1), t=float(gold['t_mm']), **KW)
        rs, rp = si.get_amplitude_pytte(E, -torch.sin(th), Ry=Rm, Rx=Rx,
                                        alphaAsym=0.0, nsteps=4000)
        atol = 1e-4
    else:
        si = tm.CrystalSi.create(hkl=(1, 1, 1), t=float(gold['t_mm']),
                                 geom='Laue reflected', **KW)
        rs, rp = si.get_amplitude_pytte(E, -torch.cos(th), -torch.cos(th),
                                        torch.sin(th), Ry=Rm, Rx=Rx,
                                        alphaAsym=0.0, nsteps=8000)
        atol = 1e-2     # rapid Pendelloesung fringes
    for pol, r in (('sigma', rs), ('pi', rp)):
        np.testing.assert_allclose(r.abs().numpy() ** 2,
                                   gold[f'{geom}_{pol}{tag}_R'].real,
                                   atol=atol)


def _integrated_jax(si, E, bIn, c1_0, c2_0, nsteps):
    def f(invR):
        rs, _ = jtt.tt_amplitudes(E, bIn, None, None, si,
                                  c1_0 * invR * 2e6, c2_0 * invR * 2e6,
                                  invR, nsteps=nsteps, autoLimits=False)
        return jnp.sum(jnp.abs(rs) ** 2)
    return f


def test_gradient_wrt_curvature_matches_jax():
    """d(integrated R) / d(1/R) through 800 Lawson steps by autograd,
    against ``jax.grad`` (1e-8) and a central difference (2%, the step is
    coarse on this oscillatory functional, as in tests/test_tt.py)."""
    j, t = crystals(t=0.05)
    thetaB = float(j.get_Bragg_angle(9000.0))
    dth = np.linspace(0, 60e-6, 21)
    bIn = -np.sin(thetaB + dth)
    c1_0, c2_0, _ = jtt.compute_tt_params(j, 0.0, Rm=2000.0, Rs=np.inf)
    # a strongly typed float64 energy: jnp.full(n, E) would take f1, f2 in
    # the tables' float32 (ROADMAP C11)
    f = _integrated_jax(j, jnp.asarray(np.full(21, 9000.0)),
                        jnp.asarray(bIn), c1_0, c2_0, 800)
    gj = float(jax.jit(jax.grad(f))(5e-7))

    def g(invR):
        rs, _ = ttt.tt_amplitudes(
            torch.full((21,), 9000.0, dtype=F64), torch.from_numpy(bIn),
            None, None, t, c1_0 * invR * 2e6, c2_0 * invR * 2e6, invR,
            nsteps=800, autoLimits=False)
        return torch.sum(rs.abs() ** 2)
    invR = torch.tensor(5e-7, dtype=F64, requires_grad=True)
    g(invR).backward()
    gt = float(invR.grad)
    print(f'd(integrated R)/d(1/R): port {gt:.12e}, JAX package {gj:.12e}')
    assert np.isfinite(gt) and gt != 0.0
    assert abs(gt - gj) < 1e-8 * abs(gj)
    h = 1e-9
    with torch.no_grad():
        fd = (float(g(5e-7 + h)) - float(g(5e-7 - h))) / (2 * h)
    assert np.isclose(gt, fd, rtol=2e-2)


def test_unbent_crystal_gives_two_beam_amplitudes():
    """Without a bending radius (or with infinite ones) the TT entry is the
    two-beam amplitude, and the integration of an unbent crystal agrees
    with it to 1e-4 (tests/test_tt.py)."""
    _, si = crystals()
    E = torch.full((101,), 9000.0, dtype=F64)
    thetaB = float(si.get_Bragg_angle(9000.0))
    bIn = -torch.sin(thetaB + torch.linspace(-50e-6, 100e-6, 101,
                                             dtype=F64))
    ref = si.get_amplitude(E, bIn)
    for Ry, Rx in ((None, None), (math.inf, None), (math.inf, math.inf)):
        got = si.get_amplitude_pytte(E, bIn, Ry=Ry, Rx=Rx)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
    got = ttt.tt_amplitudes(E, bIn, None, None, si, 0.0, 0.0, 0.0,
                            nsteps=3000)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.abs().numpy(), r.abs().numpy(),
                                   atol=1e-4)


def test_bending_broadens_and_boosts_integrated_reflectivity():
    _, si = crystals()
    E = torch.full((151,), 9000.0, dtype=F64)
    thetaB = float(si.get_Bragg_angle(9000.0))
    bIn = -torch.sin(thetaB + torch.linspace(-50e-6, 150e-6, 151,
                                             dtype=F64))
    I_flat = si.get_amplitude_pytte(E, bIn, Ry=math.inf)[0].abs() ** 2
    I_bent = si.get_amplitude_pytte(E, bIn, Ry=1000.0,
                                    nsteps=4000)[0].abs() ** 2
    assert I_bent.sum() > 1.3 * I_flat.sum()
    assert (I_bent > I_bent.max() / 2).sum() > \
        (I_flat > I_flat.max() / 2).sum()


def test_thick_bent_crystals_are_stable():
    """The Lawson step keeps thick bent crystals finite: Bragg saturates
    at the thick-crystal reflectivity (to 1e-3 from 0.15 to 1 mm), Laue
    stays finite (tests/test_tt.py)."""
    scan = torch.tensor([0.0, 15e-6, 30e-6], dtype=F64)
    R = {}
    for t_mm in (0.15, 0.3, 1.0):
        _, si = crystals(t=t_mm)
        thetaB = float(si.get_Bragg_angle(9000.0))
        c1, c2, ir1 = ttt.compute_tt_params(si, 0.0, Rm=2000.0, Rs=np.inf)
        rs, _ = ttt.tt_amplitudes(torch.full((3,), 9000.0, dtype=F64),
                                  -torch.sin(thetaB + scan), None, None,
                                  si, c1, c2, ir1, nsteps=4000,
                                  autoLimits=False)
        R[t_mm] = (rs.abs() ** 2).numpy()
        assert np.all(np.isfinite(R[t_mm])) and R[t_mm].max() > 0.9
    np.testing.assert_allclose(R[0.3], R[0.15], atol=1e-3)
    np.testing.assert_allclose(R[1.0], R[0.15], atol=1e-3)
    _, si = crystals(geom='Laue reflected', t=0.3)
    thetaB = float(si.get_Bragg_angle(9000.0))
    th = thetaB + torch.linspace(-100e-6, 100e-6, 5, dtype=F64)
    c1, c2, ir1 = ttt.compute_tt_params(si, 0.0, Rm=2000.0, Rs=np.inf)
    rs, _ = ttt.tt_amplitudes(torch.full((5,), 9000.0, dtype=F64),
                              -torch.cos(th), -torch.cos(th), torch.sin(th),
                              si, c1, c2, ir1, nsteps=8000,
                              autoLimits=False)
    R = (rs.abs() ** 2).numpy()
    assert np.all(np.isfinite(R)) and R.max() > 1e-3


JAX_F32 = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
from xrt_tpu.materials import CrystalSi
a = dict(np.load(IN))
out = {}
for geom in ('Bragg reflected', 'Laue reflected'):
    si = CrystalSi.create(hkl=(1, 1, 1), t=THICK, geom=geom)
    args = [jnp.asarray(a[geom[:5] + str(i)]) for i in range(3)]
    E = jnp.full(args[0].shape, ENERGY, jnp.float32)
    rs, rp = si.get_amplitude_pytte(E, *args, Ry=RADIUS, alphaAsym=0.0,
                                    nsteps=4000)
    out[geom[:5] + 's'] = np.asarray(rs)
    out[geom[:5] + 'p'] = np.asarray(rp)
np.savez(OUT, **out)
print('OK')
'''


def test_float32_no_worse_than_jax_float32(gold, clean_env_runner,
                                           tmp_path):
    """The golden's bent Si(111) curves in float32 against float64 on the
    same float32 angles.  Measured: Bragg 0.14% / 0.13% of the peak
    (sigma / pi), Laue sigma 0.25%, Laue pi 32% (integrated 3.5%) in both
    packages alike: the Laue pi curve of this crystal is ill-conditioned
    (float64 moves by 0.7% of its peak for a 1e-9 relative change of d,
    and by 4.7% from 4000 to 8000 steps).  ROADMAP C17."""
    th = float(gold['thetaB']) + gold['scan']
    E0, t, Rm = float(gold['E0']), float(gold['t_mm']), float(gold['Rm_mm'])
    arrays = {}
    for i, v in enumerate((-np.sin(th), np.sin(th), -np.sin(th))):
        arrays[f'Bragg{i}'] = v.astype(np.float32)
    for i, v in enumerate((-np.cos(th), -np.cos(th), np.sin(th))):
        arrays[f'Laue {i}'] = v.astype(np.float32)
    np.savez(tmp_path / 'in.npz', **arrays)
    code = JAX_F32.replace('IN', repr(str(tmp_path / 'in.npz'))).replace(
        'OUT', repr(str(tmp_path / 'out.npz'))).replace(
        'ENERGY', repr(E0)).replace('RADIUS', repr(Rm)).replace(
        'THICK', repr(t))
    out, _ = clean_env_runner(code, timeout=300, f32=True)
    assert 'OK' in out
    jax32 = np.load(tmp_path / 'out.npz')
    for geom in ('Bragg reflected', 'Laue reflected'):
        res = {}
        for dt in (torch.float32, torch.float64):
            si = tm.CrystalSi.create(hkl=(1, 1, 1), t=t, geom=geom,
                                     dtype=dt, device='cpu')
            args = [torch.from_numpy(arrays[geom[:5] + str(i)]
                                     .astype(np.float64)).to(dt)
                    for i in range(3)]
            res[dt] = si.get_amplitude_pytte(
                torch.full(args[0].shape, E0, dtype=dt), *args, Ry=Rm,
                alphaAsym=0.0, nsteps=4000)
        for i, pol in enumerate('sp'):
            R64 = res[F64][i].abs().numpy() ** 2
            R32 = res[torch.float32][i].abs().numpy().astype(float) ** 2
            Rj = np.abs(jax32[geom[:5] + pol]).astype(float) ** 2
            port = np.abs(R32 - R64).max() / R64.max()
            ref = np.abs(Rj - R64).max() / R64.max()
            print(f'{geom} {pol}: float32 max|dR|/R_peak port {port:.3e}, '
                  f'JAX package {ref:.3e}')
            assert port <= ref + 1e-3, (geom, pol, port, ref)
