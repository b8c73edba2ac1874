"""The port's positioning stages and the OEs they orient, against the JAX
package.

* Ports of ``tests/test_kde_stages.py``'s stage tests at their limits:
  the tripod's round trip (pitch, roll to 1e-7, z to 1e-5), its flat
  state, one x stage's stripe selection, two x stages' round trip (1e-12),
  ``MirrorOnTripodWithTwoXStages`` and ``DCMOnTripodWithOneXStage``.
* The port's stages give the JAX package's jack and stage positions and
  orientations exactly (both are host Python floats).
* ``DCMOnTripodWithOneXStage`` at nominal (flat) jacks equals ``DCM`` at
  the same place: the exit beam of 2000 rays to 1e-9, float64.
"""
import torch_harness  # noqa: F401

import numpy as np
import pytest
import torch

from xrt_tpu import stages as jst
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch import interop
from xrt_tpu_torch.oes import (DCM, BentFlatMirror, DCMOnTripodWithOneXStage,
                               MirrorOnTripodWithTwoXStages)
from xrt_tpu_torch.stages import OneXStage, Tripod, TwoXStages

CPU = dict(dtype=torch.float64, device='cpu')
JACKS = [[-200.0, -300.0, 0.0], [200.0, -300.0, 0.0], [0.0, 350.0, 0.0]]


def test_tripod_roundtrip():
    center = [10.0, 20.0, 1400.0]
    t = Tripod(*[list(j) for j in JACKS], center=list(center), height=1400.0)
    pitch0, roll0 = 4e-3, 1.5e-3
    t.set_jacks(pitch=pitch0, roll=roll0)
    pitch, roll, z = t.get_orientation()
    assert abs(pitch - pitch0) < 1e-7
    assert abs(roll - roll0) < 1e-7
    assert abs(z - center[2]) < 1e-5


def test_tripod_flat_is_nominal():
    jacks = [[-100.0, -100.0, 0.0], [100.0, -100.0, 0.0], [0.0, 100.0, 0.0]]
    t = Tripod(*jacks, center=[0.0, 0.0, 1000.0], height=1000.0)
    c1, c2, c3 = t.set_jacks(pitch=0.0, roll=0.0)
    assert abs(t.jack1[2]) < 1e-12 and abs(t.jack3[2]) < 1e-12
    assert c1 == c2 == c3


def test_one_x_stage_select_surface():
    s = OneXStage(surface=('Si', 'Rh', 'Pt'),
                  limPhysX=([-30, -10, 10], [-10, 10, 30]))
    assert s.select_surface('Pt') == -20.0
    assert s.curSurface == 2


def test_two_x_stages_roundtrip():
    st = TwoXStages(tx1=[0.0, -250.0], tx2=[0.0, 250.0], dx=3.0)
    yaw0 = 2e-3
    st.set_x_stages(yaw=yaw0)
    dx, yaw = st.get_orientation()
    assert abs(dx - 3.0) < 1e-12
    assert abs(yaw - yaw0) < 1e-12


def test_stages_equal_jax():
    args = dict(center=[10.0, 20.0, 1400.0], height=1400.0, azimuth=0.3)
    t = Tripod(*[list(j) for j in JACKS], **args)
    j = jst.Tripod(*[list(j) for j in JACKS], **args)
    assert t.set_jacks(4e-3, 1.5e-3, 0.2) == j.set_jacks(4e-3, 1.5e-3, 0.2)
    assert t.get_orientation(0.2) == j.get_orientation(0.2)
    t2 = TwoXStages(tx1=[0.0, -250.0], tx2=[1.0, 250.0], dx=3.0,
                    surface=('a', 'b'), limPhysX=([-5, 1], [-1, 5]))
    j2 = jst.TwoXStages(tx1=[0.0, -250.0], tx2=[1.0, 250.0], dx=3.0,
                        surface=('a', 'b'), limPhysX=([-5, 1], [-1, 5]))
    assert t2.select_surface('b', 2e-3, 0.1) == \
        j2.select_surface('b', 2e-3, 0.1)
    assert t2.get_orientation(0.1) == j2.get_orientation(0.1)


def test_mirror_on_tripod_with_two_x_stages():
    center = [0.0, 20000.0, 1400.0]
    pitch0, roll0, yaw0, dx0 = 4e-3, 1.2e-3, 2e-3, 3.0
    t = Tripod(*[list(j) for j in JACKS], center=list(center), height=1400.0)
    t.set_jacks(pitch=pitch0, roll=roll0)
    st = TwoXStages(tx1=[0.0, -250.0], tx2=[0.0, 250.0], dx=dx0)
    st.set_x_stages(yaw=yaw0)
    oe = MirrorOnTripodWithTwoXStages(
        BentFlatMirror, jack1=t.jack1, jack2=t.jack2, jack3=t.jack3,
        tx1=st.tx1, tx2=st.tx2, center=center, height=1400.0, R=1e6)
    assert isinstance(oe, BentFlatMirror)
    assert abs(float(oe.pitch) - pitch0) < 1e-7
    assert abs(float(oe.roll) - roll0) < 1e-7
    assert abs(float(oe.yaw) - yaw0) < 1e-10
    assert abs(float(oe.center[0]) - dx0) < 1e-10
    assert abs(float(oe.center[2]) - center[2]) < 1e-5


def dcm_on_flat_tripod():
    jacks = [[-100.0, -100.0, 0.0], [100.0, -100.0, 0.0], [0.0, 100.0, 0.0]]
    center = [0.0, 30000.0, 1000.0]
    t = Tripod(*[list(j) for j in jacks], center=list(center), height=1000.0)
    t.set_jacks(pitch=0.0, roll=0.0)
    cr = tm.CrystalSi.create(hkl=(1, 1, 1), **CPU)
    kw = dict(material=cr, alignE=9000.0, fixedOffset=20.0,
              limPhysX=(-50, 50), limPhysY=(-500, 500))
    dcm = DCMOnTripodWithOneXStage(
        jack1=t.jack1, jack2=t.jack2, jack3=t.jack3, dx=2.5,
        center=center, height=1000.0, **kw)
    return dcm, kw


def test_dcm_on_tripod_with_one_x_stage():
    dcm, _ = dcm_on_flat_tripod()
    assert isinstance(dcm, DCM)
    assert abs(float(dcm.center[0]) - 2.5) < 1e-12
    assert abs(float(dcm.center[2]) - 1000.0) < 1e-6
    assert float(dcm.braggAngle) > 0.2


def test_dcm_on_nominal_tripod_equals_dcm():
    tri, kw = dcm_on_flat_tripod()
    ref = DCM.create(center=(2.5, 30000.0, 1000.0), **kw)
    assert (float(tri.pitch), float(tri.roll)) == (0.0, 0.0)
    rng = np.random.default_rng(5)
    n = 2000
    rays = dict(x=2.5 + rng.normal(0, 0.2, n), y=np.zeros(n),
                z=1000.0 + rng.normal(0, 0.1, n),
                a=rng.normal(0, 1e-5, n), c=rng.normal(0, 1e-5, n),
                E=9000.0 + rng.uniform(-3, 3, n),
                state=np.ones(n, np.int32), path=np.zeros(n),
                Jss=np.ones(n), Jpp=np.zeros(n), Jsp=np.zeros(n, complex),
                Es=np.ones(n, complex), Ep=np.zeros(n, complex))
    rays['b'] = np.sqrt(1 - rays['a'] ** 2 - rays['c'] ** 2)
    beam = interop.beam_from_numpy(rays, **CPU)
    got, want = tri.double_reflect(beam)[0], ref.double_reflect(beam)[0]
    assert (got.state == 1).sum() > 100
    assert torch.equal(got.state, want.state)
    for f in ('x', 'y', 'z', 'a', 'b', 'c', 'Jss', 'Jpp'):
        g, w = getattr(got, f), getattr(want, f)
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) < 1e-9 * scale, f
