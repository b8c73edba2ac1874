"""The port's ``BeamLine.place`` and BASELINE configuration 4 against the
JAX package, float64.

* The undulator -> Si(111) DCM -> elliptical KB -> focus line of
  ``examples/02_undulator_dcm_kb.py`` built with ``place`` in both
  packages: every centre to 1e-9 mm, the extra angles of the deflected
  second KB mirror and the DCM's Bragg angle to 1e-12 rad, the axis point
  and direction after each element; a branch placed ``after`` the DCM, a
  crystal aligned with pitch='auto', and the helpers ``_rot_matrix``,
  ``_axis_extra_angles``.
* Configuration 4 at 2000 rays (gNodes 64) with the undulator's draws
  injected from the JAX package's keys: the focal images (positions,
  coherency, states) to 1e-9 and their 2D histograms to 1e-9 of the
  largest bin, and the focus under 20 um in both planes (the limit of
  ``tests/test_baseline_configs.py``).
* The 3D view ``glow`` of an empty beamline writes a file.
"""
import torch_harness  # noqa: F401

import json
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
from xrt_tpu import beamline as jbl
from xrt_tpu.histogram import hist2d as jhist2d
from xrt_tpu.oes import EllipticalMirrorParam as JEll
from xrt_tpu.oes import FlatMirror as JFlat
from xrt_tpu.oes.dcm import DCM as JDCM
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu.sources import Undulator as JUndulator
from xrt_tpu_torch import beamline as tbl
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch.histogram import hist2d
from xrt_tpu_torch.oes import DCM, EllipticalMirrorParam, FlatMirror
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import Undulator

F64 = torch.float64
E0, PITCH = 9000.0, 3.5e-3
UND = dict(nrays=2000, eE=3.0, eI=0.5, period=18.0, n=111, targetE=(E0, 7),
           eEpsilonX=0.263, eEpsilonZ=0.008, betaX=9.0, betaZ=2.0,
           xPrimeMax=0.02, zPrimeMax=0.02, gNodes=64, eMin=E0 - 40,
           eMax=E0 + 40)
NAMES = ('dcm', 'vfm', 'hfm', 'focus')


def build(bl_mod, mats, und_cls, dcm_cls, ell_cls, scr_cls, flat_cls,
          branch=False, **dk):
    """The line of examples/02_undulator_dcm_kb.py."""
    bl = bl_mod.BeamLine(alignE=E0)
    bl.add('source', und_cls.create(**UND, **dk))
    cr = mats.CrystalSi.create(hkl=(1, 1, 1), **dk)
    bl.place('dcm', dcm_cls, distance=30000.0, material=cr, alignE=E0,
             fixedOffset=20.0, limPhysX=(-50, 50), limPhysY=(-500, 500))
    rh = mats.Material.create('Rh', rho=12.41, **dk)
    bl.place('vfm', ell_cls, distance=3000.0, pitch=PITCH, p=33000.0,
             q=1400.0, isCylindrical=True, material=rh, limPhysX=(-10, 10),
             limPhysY=(-150, 150), deflection='up')
    bl.place('hfm', ell_cls, distance=400.0, pitch=PITCH, p=33400.0,
             q=1000.0, positionRoll=-math.pi / 2, isCylindrical=True,
             material=rh, limPhysX=(-10, 10), limPhysY=(-150, 150),
             deflection='left')
    axes = {'hfm': (bl.axis_point, bl.axis_dir)}
    bl.add('focus', scr_cls.create(center=tuple(bl.axis_point +
                                                bl.axis_dir * 1000.0)))
    if branch:
        # a crystal aligned at alignE on a branch off the DCM
        bl.place('xtal', flat_cls, distance=500.0, pitch='auto',
                 material=cr, after='dcm', limPhysX=(-20, 20),
                 limPhysY=(-50, 50))
        axes['after branch'] = (bl.axis_point, bl.axis_dir)
    return bl, axes


def jax_line(branch=False):
    return build(jbl, jm, JUndulator, JDCM, JEll, JScreen, JFlat, branch)


def port_line(branch=False):
    return build(tbl, tm, Undulator, DCM, EllipticalMirrorParam, Screen,
                 FlatMirror, branch, dtype=F64, device='cpu')


def test_place_matches_jax():
    jb, jaxes = jax_line(branch=True)
    tb, taxes = port_line(branch=True)
    for name in NAMES + ('xtal',):
        jc = np.asarray(jb[name].center, float)
        tc = np.array([float(v) for v in tb[name].center])
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-9)
        for a in ('pitch', 'extraPitch', 'extraRoll', 'extraYaw'):
            jv, tv = getattr(jb[name], a, None), getattr(tb[name], a, None)
            assert (jv is None) == (tv is None), (name, a)
            if jv is not None:
                assert abs(float(tv) - float(jv)) < 1e-12, (name, a)
    assert tb['hfm'].extraYaw != 0.0
    assert tb['dcm'].braggAngle == float(jb['dcm'].braggAngle)
    for k in jaxes:
        for t, j in zip(taxes[k], jaxes[k]):
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-9)
    assert [s[0] for s in tb.flow] == [s[0] for s in jb.flow]
    assert [s[2] for s in tb.flow] == [s[2] for s in jb.flow]
    assert tb.flow[-1][3] == {'_input': 'dcm'}


def test_rotation_helpers_match_jax():
    for angles in ((0.1, -0.2, 0.3), (3.5e-3, -math.pi / 2, 0.0)):
        np.testing.assert_allclose(tbl._rot_matrix('RzRyRx', *angles),
                                   jbl._rot_matrix('RzRyRx', *angles),
                                   rtol=0, atol=1e-15)
    d = np.array([0.002, 0.9999, 0.007])
    np.testing.assert_allclose(tbl._axis_extra_angles(d, 0.01, -0.5, 0.0),
                               jbl._axis_extra_angles(d, 0.01, -0.5, 0.0),
                               rtol=0, atol=1e-14)


def _draws(key, nrays, M, dt=jnp.float64):
    keys = jax.random.split(key, 10)
    k1, k2 = jax.random.split(keys[8])
    d = dict(E=jax.random.uniform(keys[0], (M,), dt),
             theta=jax.random.uniform(keys[1], (M,), dt),
             psi=jax.random.uniform(keys[2], (M,), dt),
             choice=jax.random.uniform(keys[4], (nrays,), dt),
             dtheta=jax.random.normal(keys[5], (nrays,), dt),
             dpsi=jax.random.normal(keys[7], (nrays,), dt),
             x=jax.random.normal(k1, (nrays,), dt),
             z=jax.random.normal(k2, (nrays,), dt))
    return {k: np.array(v) for k, v in d.items()}


def trace(bl, beam):
    mono = bl['dcm'].double_reflect(beam)[0]
    b1 = bl['vfm'].reflect(mono)[0]
    return bl['focus'].expose(bl['hfm'].reflect(b1)[0])


def test_config4_focus_matches_jax():
    jb, _ = jax_line()
    tb, _ = port_line()
    key = jax.random.PRNGKey(0)
    jimg = jax.jit(lambda k: trace(jb, jb['source'].shine(k)))(key)
    timg = trace(tb, tb['source'].shine(None, draws=_draws(key, 2000,
                                                           8000)))
    np.testing.assert_array_equal(timg.state.numpy(), np.asarray(jimg.state))
    for f in ('x', 'z'):
        t, j = getattr(timg, f).numpy(), np.asarray(getattr(jimg, f))
        assert np.abs(t - j).max() < 1e-9, f
    jJ = max(float(np.abs(np.asarray(getattr(jimg, f))).max())
             for f in ('Jss', 'Jpp'))
    for f in ('Jss', 'Jpp', 'Jsp'):
        t, j = getattr(timg, f).numpy(), np.asarray(getattr(jimg, f))
        assert np.abs(t - j).max() / jJ < 1e-9, f
    lim = (-0.02, 0.02)
    wt = torch.where(timg.state == 1, timg.Jss + timg.Jpp,
                     torch.zeros_like(timg.Jss))
    ht = hist2d(timg.x, timg.z, wt, 64, 64, lim, lim).numpy()
    wj = jnp.where(jimg.state == 1, jimg.Jss + jimg.Jpp, 0.0)
    hj = np.asarray(jhist2d(jimg.x, jimg.z, wj, 64, 64, lim, lim))
    assert hj.sum() > 0
    assert np.abs(ht - hj).max() / hj.max() < 1e-9
    I = wt.numpy()
    good = I > 1e-3 * I.max()
    assert good.sum() > 100
    assert timg.x.numpy()[good].std() < 0.02
    assert timg.z.numpy()[good].std() < 0.02


def test_host_layers_raise_naming_the_item(tmp_path):
    # every host layer is ported: the 3D view of an empty beamline is a
    # file with an empty scene (tests/test_torch_glow.py), the flow,
    # alarms and layouts are tested in tests/test_torch_layouts.py
    bl = tbl.BeamLine()
    out = bl.glow(save=str(tmp_path / 'empty.html'))
    html = open(out).read()
    assert html.startswith('<!DOCTYPE html>')
    assert '"elements": [], "segments": []' in html
    assert bl.propagate_flow() == {}
    assert bl.check_alarms({}) == []
    assert json.loads(bl.export_to_json())['elements'] == []
