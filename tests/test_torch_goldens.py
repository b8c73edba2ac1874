"""The port against the reference goldens that its other tests do not
read, at the limits of the JAX package's own tests of them.

* ``tests/golden/ref_waves_oe.npz``: slit field -> Kirchhoff onto a
  toroid's mesh samples -> reflection at the samples -> Kirchhoff to the
  focal screen, float64, at ``tests/test_waves_oe.py``'s limits.
* ``tests/golden/ref_trace_dcm.npz``: a Si(111) DCM at a fixed Bragg
  angle on a flat 16 eV band, the transmitted flux per ray and the
  weighted energy mean and spread at ``tests/test_trace_parity.py``'s
  limits, on the golden's 1e5 rays (the limits are counting statistics
  of that many rays).
* The XOP curves that ``tests/test_materials.py`` reads (Pt at 4 mrad,
  xf1f2; thick Si(111), XCrystal) at its loose limits.
"""
import gzip
import math
import os

import numpy as np
import pytest
import torch

from xrt_tpu_torch import materials as tm
from xrt_tpu_torch.apertures import RectangularAperture
from xrt_tpu_torch.beam import Beam
from xrt_tpu_torch.oes import DCM, ToroidMirror
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import GeometricSource
from xrt_tpu_torch.waves import (diffract, prepare_wave_on_oe,
                                 prepare_wave_on_screen, wave_to_global)
from test_torch_crystal import rocking_geometry

F64 = torch.float64
KW = dict(dtype=F64, device='cpu')
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')


def T(v):
    return torch.as_tensor(np.asarray(v), dtype=F64)


# ---- ref_waves_oe.npz ---------------------------------------------------

@pytest.fixture(scope='module')
def chain():
    ref = np.load(os.path.join(GOLDEN, 'ref_waves_oe.npz'))
    E0, P, Q = float(ref['E0']), float(ref['P']), float(ref['Q'])
    pitch = float(ref['pitch'])
    toroid = ToroidMirror.create(
        center=(0, P, 0), pitch=pitch, R=float(ref['R']), r=float(ref['r']),
        material=tm.Material.create('Au', rho=19.3, kind='mirror', **KW),
        limPhysX=tuple(float(v) for v in ref['limX']),
        limPhysY=tuple(float(v) for v in ref['limY']))
    slit = RectangularAperture.create(
        center=(0, 0, 0), opening=tuple(float(v)
                                        for v in ref['slit_opening']))
    screen = Screen.create(
        center=(0, P + Q * math.cos(2 * pitch), Q * math.sin(2 * pitch)),
        z=(0, -math.sin(2 * pitch), math.cos(2 * pitch)))
    X, Y = np.meshgrid(ref['xx'], ref['yy'])
    waveT = prepare_wave_on_oe(toroid, slit, None,
                               samples=(X.ravel(), Y.ravel()), **KW)
    waveT = waveT.replace(E=torch.full_like(waveT.E, E0))
    n = len(ref['src_x'])
    zero = torch.zeros(n, dtype=F64)
    Es = torch.as_tensor(ref['src_Es'], dtype=torch.complex128)
    Ep = torch.as_tensor(ref['src_Ep'], dtype=torch.complex128)
    src = Beam(x=T(ref['src_x']), y=zero, z=T(ref['src_z']), a=zero,
               b=torch.ones(n, dtype=F64), c=zero,
               E=torch.full((n,), E0, dtype=F64),
               state=torch.ones(n, dtype=torch.int32), path=zero,
               Jss=Es.abs() ** 2, Jpp=Ep.abs() ** 2, Jsp=Es * Ep.conj(),
               Es=Es, Ep=Ep, area=T(float(ref['src_area'])))
    waveT = diffract(src, waveT)
    _, retLoc = toroid.reflect(wave_to_global(waveT),
                               noIntersectionSearch=True)
    retLoc = retLoc.replace(area=waveT.area)
    waveS = prepare_wave_on_screen(screen, toroid, ref['xs'], ref['zs'],
                                   **KW)
    return ref, waveT, retLoc, diffract(retLoc, waveS)


def test_waves_oe_geometry_matches_golden(chain):
    ref, waveT, _, _ = chain
    for f in ('x', 'y', 'z', 'xDiffr', 'yDiffr', 'zDiffr'):
        np.testing.assert_allclose(getattr(waveT, f).numpy(),
                                   ref['wT_' + f], atol=1e-9, err_msg=f)
    for f in 'abc':
        np.testing.assert_allclose(getattr(waveT, f).numpy(),
                                   ref['wT_' + f], atol=5e-7, err_msg=f)
    np.testing.assert_allclose(float(waveT.area), float(ref['wT_area']),
                               rtol=1e-12)
    np.testing.assert_allclose(float(waveT.areaNormal),
                               float(ref['wT_areaNormal']), rtol=1e-9)


def test_waves_oe_fields_match_golden(chain):
    ref, waveT, retLoc, waveS = chain
    for f in ('Es', 'Ep'):
        r = ref['wT_' + f]
        np.testing.assert_allclose(getattr(waveT, f).numpy(), r, rtol=1e-3,
                                   atol=2e-5 * np.abs(r).max(), err_msg=f)
    good = ref['rT_state'] == 1
    assert (retLoc.state.numpy()[good] == 1).all()
    for f in 'abc':
        np.testing.assert_allclose(getattr(retLoc, f).numpy()[good],
                                   ref['rT_' + f][good], atol=5e-7)
    for f in ('Es', 'Ep'):
        r = ref['rT_' + f]
        np.testing.assert_allclose(getattr(retLoc, f).numpy()[good],
                                   r[good], rtol=1e-3,
                                   atol=2e-5 * np.abs(r).max(), err_msg=f)
    for f in ('xDiffr', 'yDiffr', 'zDiffr'):
        np.testing.assert_allclose(getattr(waveS, f).numpy(),
                                   ref['wS_' + f], atol=1e-9, err_msg=f)
    scale = np.abs(ref['wS_Es']).max()
    np.testing.assert_allclose(waveS.Es.numpy(), ref['wS_Es'], rtol=0,
                               atol=5e-3 * scale)


# ---- ref_trace_dcm.npz ---------------------------------------------------

def test_dcm_parity_energy_band():
    gold = np.load(os.path.join(GOLDEN, 'ref_trace_dcm.npz'))
    nrays = int(gold['nrays'])
    src = GeometricSource.create(
        nrays=nrays, dx=0.1, dz=0.05, dxprime=1e-5, dzprime=1e-5,
        distE='flat', energies=(9000.0 - 8, 9000.0 + 8),
        polarization='horizontal', **KW)
    dcm = DCM.create(center=(0, 30000.0, 0),
                     material=tm.CrystalSi.create(hkl=(1, 1, 1), **KW),
                     bragg=float(gold['thetaB']), fixedOffset=20.0,
                     limPhysX=(-50, 50), limPhysY=(-500, 500))
    glo, _, _ = dcm.double_reflect(
        src.shine(torch.Generator().manual_seed(3)))
    good = (glo.state == 1).numpy()
    I = (glo.Jss + glo.Jpp).numpy()[good]
    E = glo.E.numpy()[good]
    ref = float(gold['flux_per_ray'])
    assert abs(I.sum() / nrays - ref) / ref < 0.02
    Em = np.average(E, weights=I)
    Es = np.sqrt(np.average((E - Em) ** 2, weights=I))
    assert abs(Em - float(gold['E_mean'])) < 0.05
    assert abs(Es - float(gold['E_std'])) / float(gold['E_std']) < 0.03


# ---- the XOP curves of tests/test_materials.py --------------------------

def test_fresnel_vs_xop():
    E = np.logspace(1. + math.log10(3.), 4. + math.log10(5.), 500)
    mat = tm.Material.create('Pt', rho=21.45, kind='mirror', **KW)
    rs = mat.get_amplitude(T(E), T(np.full(E.shape, math.sin(4e-3))))[0]
    x, R2s = np.loadtxt(os.path.join(GOLDEN, 'XOP-Reflectivities',
                                     'Pt4mrad_s.xf1f2.gz'), unpack=True)
    mine = np.interp(x, E, np.abs(rs.numpy()) ** 2)
    sel = (x > 100) & (x < 2e4)
    assert np.sqrt(np.mean((mine[sel] - R2s[sel]) ** 2)) < 0.02


def test_rocking_vs_xop_xcrystal():
    cr = tm.CrystalDiamond.create(hkl=(1, 1, 1), d=3.13562, **KW)
    dth = np.linspace(0, 100, 400) * 1e-6
    args = rocking_geometry(float(cr.d), cr.geom, 0., dth)
    curS, _ = cr.get_amplitude(*(T(a) for a in args))
    with gzip.open(os.path.join(GOLDEN, 'XOP-RockingCurves',
                                'bSi111_thick_0_s.xc.gz')) as f:
        x, R2s = np.loadtxt(f, unpack=True)
    xop = np.interp(dth, x / (180 / math.pi * 3600.), R2s)
    mine = np.abs(curS.numpy()) ** 2
    sel = (dth > 5e-6) & (dth < 60e-6)
    assert np.sqrt(np.mean((mine[sel] - xop[sel]) ** 2)) < 0.03
