"""Stock mirrors: flat, bent-flat (cylindrical), spherical, toroidal,
sagittally cylindrical, conical and ``DualVFM``, with the Coddington
helpers, and ``MirrorOnTripodWithTwoXStages`` (a mirror oriented by a
tripod and two x stages).

Port of the reference package's ``oes/mirrors.py``.  Radii and angles are
Python floats, or the tensors that were passed in.
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..transforms import sin
from .base import OE


def rmer_from_coddington(p, q, pitch):
    """Meridional radius 2pq/(p+q)/sin(pitch)."""
    return 2 * p * q / (p + q) / sin(abs(pitch))


def rsag_from_coddington(p, q, pitch):
    """Sagittal radius 2pq/(p+q)*sin(pitch)."""
    return 2 * p * q / (p + q) * sin(abs(pitch))


def _resolve_R(R, pitch):
    if isinstance(R, (tuple, list)):
        if len(R) == 3:
            return rmer_from_coddington(R[0], R[1], R[2])
        return rmer_from_coddington(R[0], R[1], pitch)
    if not isinstance(R, torch.Tensor) and R in (0, None):
        return 1e100
    return config.number(R)


def _resolve_r(r, pitch):
    if isinstance(r, (tuple, list)):
        if len(r) == 3:
            return rsag_from_coddington(r[0], r[1], r[2])
        return rsag_from_coddington(r[0], r[1], pitch)
    if not isinstance(r, torch.Tensor) and r in (0, None):
        return 1e100
    return config.number(r)


class FlatMirror(OE):
    """A plane mirror (the plain OE with its default surface)."""


class BentFlatMirror(OE):
    """Meridionally bent parabolic cylinder with fixed ends:
    z = (y^2 - limPhysY[0]^2) / (2R)."""

    def __init__(self, R=5.0e6, **kwargs):
        super().__init__(**kwargs)
        self.R = R

    @classmethod
    def create(cls, R=5.0e6, pitch=0.0, **kwargs):
        return super(BentFlatMirror, cls).create(
            pitch=pitch, R=_resolve_R(R, pitch), **kwargs)

    def local_z(self, x, y):
        return (y ** 2 - self.limPhysY[0] ** 2) / 2.0 / self.R

    def local_n(self, x, y):
        b = -y / self.R
        norm = sqrt_rn(b ** 2 + 1)
        return [torch.zeros_like(x), b / norm, 1.0 / norm]


SimpleVCM = BentFlatMirror
VCM = BentFlatMirror


def MirrorOnTripodWithTwoXStages(oe_cls=FlatMirror, *, jack1, jack2, jack3,
                                 tx1, tx2, center, height=0.0,
                                 positionRoll=0.0, **kwargs):
    """An *oe_cls* mirror oriented by a tripod and two x stages: the stage
    x's give (dx, yaw), the jack z's give (pitch, roll, centre z).  The
    tripod is defined horizontal (every jack at z = 0), so the jack z's
    are motor readbacks.  Keep the ``stages`` objects for motor
    readouts."""
    from ..stages import Tripod, TwoXStages
    dx, yaw = TwoXStages(tx1=list(tx1), tx2=list(tx2)).get_orientation(
        positionRoll)
    tp = Tripod([jack1[0], jack1[1], 0.0], [jack2[0], jack2[1], 0.0],
                [jack3[0], jack3[1], 0.0], center=list(center),
                height=height)
    tp.jack1[2], tp.jack2[2], tp.jack3[2] = jack1[2], jack2[2], jack3[2]
    pitch, roll, cz = tp.get_orientation(positionRoll)
    return oe_cls.create(center=(center[0] + dx, center[1], cz),
                         pitch=pitch, roll=roll, yaw=yaw,
                         positionRoll=positionRoll, **kwargs)


class SphericalMirror(OE):
    """Spherical mirror of radius R: z = R - sqrt(R^2 - x^2 - y^2)."""

    def __init__(self, R=5.0e6, **kwargs):
        super().__init__(**kwargs)
        self.R = R

    @classmethod
    def create(cls, R=5.0e6, pitch=0.0, **kwargs):
        return super(SphericalMirror, cls).create(
            pitch=pitch, R=_resolve_R(R, pitch), **kwargs)

    def local_z(self, x, y):
        rho2 = torch.clamp(self.R ** 2 - x ** 2 - y ** 2, min=0.0)
        return self.R - sqrt_rn(rho2)

    def local_n(self, x, y):
        s = sqrt_rn(torch.clamp(self.R ** 2 - x ** 2 - y ** 2, min=1e-30))
        a = -x / s
        b = -y / s
        norm = sqrt_rn(a ** 2 + b ** 2 + 1)
        return [a / norm, b / norm, 1.0 / norm]


class ToroidMirror(OE):
    """Toroidal mirror with meridional radius R and sagittal radius r."""

    def __init__(self, R=5.0e6, r=50.0, **kwargs):
        super().__init__(**kwargs)
        self.R = R
        self.r = r

    @classmethod
    def create(cls, R=5.0e6, r=50.0, pitch=0.0, **kwargs):
        return super(ToroidMirror, cls).create(
            pitch=pitch, R=_resolve_R(R, pitch), r=_resolve_r(r, pitch),
            **kwargs)

    def local_z(self, x, y):
        rx = torch.clamp(1 - (x / self.r) ** 2, min=0.0)
        return y ** 2 / 2.0 / self.R + self.r * (1 - sqrt_rn(rx))

    def local_n(self, x, y):
        rx = 1 - (x / self.r) ** 2
        ax = torch.where(rx <= 0, torch.zeros_like(rx),
                         1.0 / sqrt_rn(torch.clamp(rx, min=1e-30)))
        a = -x / self.r * ax
        b = -y / self.R
        norm = sqrt_rn(a ** 2 + b ** 2 + 1)
        return [a / norm, b / norm, 1.0 / norm]


SimpleVFM = ToroidMirror
VFM = ToroidMirror


class CylindricalMirror(OE):
    """Sagittal cylinder of radius r (a round pipe along y):
    z = r - sqrt(r^2 - x^2)."""

    def __init__(self, r=50.0, **kwargs):
        super().__init__(**kwargs)
        self.r = r

    @classmethod
    def create(cls, r=50.0, pitch=0.0, **kwargs):
        return super(CylindricalMirror, cls).create(
            pitch=pitch, r=_resolve_r(r, pitch), **kwargs)

    def local_z(self, x, y):
        rx = torch.clamp(1 - (x / self.r) ** 2, min=0.0)
        return self.r * (1 - sqrt_rn(rx))

    def local_n(self, x, y):
        rx = 1 - (x / self.r) ** 2
        ax = torch.where(rx <= 0, torch.zeros_like(rx),
                         1.0 / sqrt_rn(torch.clamp(rx, min=1e-30)))
        a = -x / self.r * ax
        norm = sqrt_rn(a ** 2 + 1)
        return [a / norm, torch.zeros_like(y), 1.0 / norm]


class ConicalMirror(OE):
    """Conical mirror with its base parallel to the cone side.  *L0* is
    the distance from the mirror center to the cone vertex along the
    surface, *theta* the opening angle."""

    def __init__(self, L0=1000.0, theta_c=math.pi / 6, **kwargs):
        super().__init__(**kwargs)
        self.L0 = float(L0)
        self.theta_c = float(theta_c)
        self._tt = math.tan(self.theta_c)
        self._t2t = math.tan(2 * self.theta_c)
        self._redfocus = math.cos(self.theta_c) ** 2 / \
            (1.0 / self._tt - 1.0 / self._t2t)

    @classmethod
    def create(cls, L0=1000.0, theta=math.pi / 6, **kwargs):
        return super(ConicalMirror, cls).create(L0=L0, theta_c=theta,
                                                **kwargs)

    def local_z(self, x, y):
        t2t = self._t2t
        sqroot = sqrt_rn(torch.clamp(
            0.25 * t2t ** 2 * (y - self.L0) ** 2 -
            self._redfocus * t2t * x ** 2, min=0.0))
        return -0.5 * t2t * (y - self.L0) - math.copysign(1.0, t2t) * sqroot

    def local_n(self, x, y):
        t2t = self._t2t
        sqroot = math.copysign(1.0, t2t) * sqrt_rn(torch.clamp(
            0.25 * t2t ** 2 * (y - self.L0) ** 2 -
            self._redfocus * x * x * t2t, min=1e-30))
        a = -x * self._redfocus * t2t / sqroot
        b = 0.5 * t2t + 0.25 * t2t ** 2 * (y - self.L0) / sqroot
        norm = sqrt_rn(a ** 2 + b ** 2 + 1)
        return [a / norm, b / norm, 1.0 / norm]



class DualVFM(OE):
    """A vertically focusing mirror with two sagittal cylinders side by
    side on a meridionally bent (parabolic, fixed-end) substrate;
    ``select_surface`` centres one in the beam.  *xCylinder1/2* are the
    cylinders' axes in x, *hCylinder1/2* their depths under the flat
    reference."""

    def __init__(self, R=5.0e6, r1=70.0, xCylinder1=23.5, hCylinder1=3.7035,
                 r2=35.98, xCylinder2=-25.0, hCylinder2=6.9504, **kwargs):
        super().__init__(**kwargs)
        self.R, self.r1, self.r2 = float(R), float(r1), float(r2)
        self.xCylinder1, self.hCylinder1 = float(xCylinder1), \
            float(hCylinder1)
        self.xCylinder2, self.hCylinder2 = float(xCylinder2), \
            float(hCylinder2)

    @classmethod
    def create(cls, R=5.0e6, r1=70.0, xCylinder1=23.5, hCylinder1=3.7035,
               r2=35.98, xCylinder2=-25.0, hCylinder2=6.9504, **kwargs):
        return super(DualVFM, cls).create(
            R=R, r1=r1, xCylinder1=xCylinder1, hCylinder1=hCylinder1, r2=r2,
            xCylinder2=xCylinder2, hCylinder2=hCylinder2, **kwargs)

    def _cyl(self, x):
        """(z, -dz/dx) of the two-cylinder cross profile, clipped to
        z <= 0."""
        t2 = self.r2 ** 2 - (x - self.xCylinder2) ** 2
        t1 = self.r1 ** 2 - (x - self.xCylinder1) ** 2
        s2 = sqrt_rn(torch.clamp(t2, min=1e-30))
        s1 = sqrt_rn(torch.clamp(t1, min=1e-30))
        zero = torch.zeros_like(x)
        z2 = torch.where(t2 > 0, self.r2 - self.hCylinder2 - s2, zero)
        z1 = torch.where(t1 > 0, self.r1 - self.hCylinder1 - s1, zero)
        a2 = torch.where(t2 > 0, -(x - self.xCylinder2) / s2, zero)
        a1 = torch.where(t1 > 0, -(x - self.xCylinder1) / s1, zero)
        neg = x < 0
        z = torch.where(neg, z2, z1)
        a = torch.where(neg, a2, a1)
        a = torch.where(z > 0, zero, a)
        return torch.clamp(z, max=0.0), a

    def local_z(self, x, y):
        z, _ = self._cyl(x)
        return z + (y ** 2 - self.limPhysY[0] ** 2) / 2.0 / self.R

    def local_n(self, x, y):
        _, a = self._cyl(x)
        b = -y / self.R
        norm = sqrt_rn(a ** 2 + b ** 2 + 1.0)
        return [a / norm, b / norm, 1.0 / norm]

    def select_surface(self, surfaceName_or_index):
        """(the OE with *curSurface* set, the dx that centres that
        cylinder in the beam)."""
        idx = surfaceName_or_index
        if not isinstance(idx, int):
            idx = 0 if str(idx).endswith('1') else 1
        dx = -self.xCylinder1 if idx == 0 else -self.xCylinder2
        return self.replace(curSurface=idx), dx
