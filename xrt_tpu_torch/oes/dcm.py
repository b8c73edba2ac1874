"""Double-crystal monochromator.

Port of the reference package's ``oes/dcm.py``: two crystal surfaces
traced one after the other in the same virgin-local frame
(``double_reflect``), the fixed-exit geometry through *fixedOffset*, and
the misalignments cryst1roll, cryst2roll, cryst2pitch, cryst2finePitch,
cryst2longTransl and cryst2perpTransl; ``DCMwithSagittalFocusing`` bends
the second crystal sagittally.  ``DCMOnTripodWithOneXStage`` reads the
orientation off a tripod and one x stage (``stages``).
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..profiler import stage
from ..transforms import global_to_virgin_local, virgin_local_to_global
from .base import OE, _fvec, _merge_by_mask


class DCM(OE):
    """Double crystal monochromator with flat crystals.

    *bragg* is the Bragg angle in rad, an alignment energy ('9000 eV') or
    'auto' (at *alignE*, 9 keV by default): the material's Bragg angle
    less its refraction correction."""

    def __init__(self, braggAngle=0.0, cryst1roll=0.0, cryst2roll=0.0,
                 cryst2pitch=0.0, cryst2finePitch=0.0, cryst2perpTransl=0.0,
                 cryst2longTransl=0.0, dxCryst=0.0, limPhysX2=None,
                 limPhysY2=None, limOptX2=None, limOptY2=None,
                 material2=None, **kwargs):
        super().__init__(**kwargs)
        self.braggAngle = config.number(braggAngle)
        self.cryst1roll = config.number(cryst1roll)
        self.cryst2roll = config.number(cryst2roll)
        self.cryst2pitch = config.number(cryst2pitch)
        self.cryst2finePitch = config.number(cryst2finePitch)
        self.cryst2perpTransl = config.number(cryst2perpTransl)
        self.cryst2longTransl = config.number(cryst2longTransl)
        self.dxCryst = config.number(dxCryst)
        self.limPhysX2, self.limPhysY2 = limPhysX2, limPhysY2
        self.limOptX2, self.limOptY2 = limOptX2, limOptY2
        self.material2 = material2

    @classmethod
    def create(cls, bragg=0.0, braggOffset=0.0, cryst1roll=0.0,
               cryst2roll=0.0, cryst2pitch=0.0, cryst2finePitch=0.0,
               cryst2perpTransl=0.0, cryst2longTransl=0.0, fixedOffset=None,
               limPhysX2=None, limPhysY2=None, limOptX2=None, limOptY2=None,
               material=None, material2=None, alignE=None, **kwargs):
        if isinstance(bragg, str):
            E_al = config.parse_energy(bragg)
            if E_al is not None:
                alignE, bragg = float(E_al), None
            elif 'auto' in bragg.lower():
                bragg = None
            else:
                bragg = config.auto_units_angle(bragg)
        if bragg is None and material is None:
            raise ValueError(
                "DCM with bragg='auto'/energy (or no bragg) needs a "
                'material to resolve the Bragg angle')
        if (bragg is None or alignE is not None) and material is not None:
            if alignE is None:
                alignE = 9000.0
            # taken in the material's dtype, as the reference does: in
            # float32 the angle carries ~1e-8 rad of rounding
            bragg = float(material.get_Bragg_angle(alignE) -
                          material.get_dtheta(alignE))
        bragg = bragg - braggOffset
        if fixedOffset not in (0, None):
            cryst2perpTransl = fixedOffset / 2.0 / math.cos(bragg)
        if material2 is None:
            material2 = material
        return super(DCM, cls).create(
            material=material, braggAngle=bragg, cryst1roll=cryst1roll,
            cryst2roll=cryst2roll, cryst2pitch=cryst2pitch,
            cryst2finePitch=cryst2finePitch,
            cryst2perpTransl=cryst2perpTransl,
            cryst2longTransl=cryst2longTransl, dxCryst=0.0,
            material2=material2, limPhysX2=_fvec(limPhysX2),
            limPhysY2=_fvec(limPhysY2), limOptX2=_fvec(limOptX2),
            limOptY2=_fvec(limOptY2), **kwargs)

    # the surfaces of the two crystals; a subclass overrides them
    def local_z1(self, x, y):
        return self.local_z(x, y)

    def local_n1(self, x, y):
        return self.local_n(x, y)

    def local_z2(self, x, y):
        return torch.zeros_like(x)

    def local_n2(self, x, y):
        return [torch.zeros_like(x), torch.zeros_like(x), torch.ones_like(x)]

    def double_reflect(self, beam, generator=None, needLocal=True,
                       fromVacuum1=True, fromVacuum2=True):
        """(beamGlobal, beamLocal1, beamLocal2): *beam* (global frame) off
        the first crystal, then the second.  A ray keeps its incoming
        values unless both crystals took it; the state is the second
        crystal's.  While the profiler traces, the call is the span
        ``oes.double_reflect``."""
        with stage('oes.double_reflect', device=beam.x):
            good1 = beam.state > 0
            lb = global_to_virgin_local(beam, self.center)
            vlb1, lo1 = self._reflect_local(
                lb, good1, self.pitch + self.braggAngle,
                self.roll + self.positionRoll + self.cryst1roll, self.yaw,
                dx=self.dxCryst, fromVacuum=fromVacuum1,
                local_z=self.local_z1, local_n=self.local_n1,
                material=self.material, generator=generator)
            goodAfter1 = (vlb1.state == 1) | (vlb1.state == 2)
            lim2 = (self.limPhysX2 if self.limPhysX2 is not None
                    else self.limPhysX,
                    self.limPhysY2 if self.limPhysY2 is not None
                    else self.limPhysY,
                    self.limOptX2, self.limOptY2)
            vlb2, lo2 = self._reflect_local(
                vlb1, goodAfter1,
                -self.pitch - self.braggAngle + self.cryst2pitch +
                self.cryst2finePitch,
                self.roll + self.cryst2roll + self.positionRoll, -self.yaw,
                dx=-self.dxCryst, dy=self.cryst2longTransl,
                dz=-self.cryst2perpTransl, fromVacuum=fromVacuum2,
                is2ndXtal=True, local_z=self.local_z2, local_n=self.local_n2,
                material=self.material2, limits=lim2, generator=generator)
            goodAfter2 = (vlb2.state == 1) | (vlb2.state == 2)
            glo = virgin_local_to_global(vlb2, self.center)
            merged = _merge_by_mask(beam, glo, good1 & goodAfter1 & goodAfter2)
            merged = merged.replace(state=glo.state)
        if needLocal:
            return merged, lo1, lo2
        return merged


class DCMwithSagittalFocusing(DCM):
    """A DCM whose second crystal is bent sagittally to the radius *Rs*
    (mm)."""

    def __init__(self, Rs=1000.0, **kwargs):
        super().__init__(**kwargs)
        self.Rs = config.number(Rs)

    @classmethod
    def create(cls, Rs=1000.0, **kwargs):
        return super(DCMwithSagittalFocusing, cls).create(Rs=Rs, **kwargs)

    def local_z2(self, x, y):
        return (x ** 2) / 2.0 / self.Rs

    def local_n2(self, x, y):
        a = -x / self.Rs
        norm = sqrt_rn(a ** 2 + 1)
        return [a / norm, torch.zeros_like(y), 1.0 / norm]


def DCMOnTripodWithOneXStage(dcm_cls=DCM, *, jack1, jack2, jack3, dx,
                             center, height=0.0, positionRoll=0.0,
                             **kwargs):
    """A DCM (or *dcm_cls*) oriented by a tripod and one x stage: the
    stage gives the lateral shift *dx*, the measured jack z's give (pitch,
    roll, centre z).  The tripod is defined horizontal (every jack at z =
    0), so the jack z's are motor readbacks.  Keep the ``stages`` objects
    for motor readouts."""
    from ..stages import Tripod
    tp = Tripod([jack1[0], jack1[1], 0.0], [jack2[0], jack2[1], 0.0],
                [jack3[0], jack3[1], 0.0], center=list(center),
                height=height)
    tp.jack1[2], tp.jack2[2], tp.jack3[2] = jack1[2], jack2[2], jack3[2]
    pitch, roll, cz = tp.get_orientation(positionRoll)
    return dcm_cls.create(center=(center[0] + dx, center[1], cz),
                          pitch=pitch, roll=roll,
                          positionRoll=positionRoll, **kwargs)
