"""Parametric mirrors: exact elliptical, parabolic and hyperbolic
figures and capillary surfaces of revolution.

Port of the reference package's ``oes/parametric.py``.  Parameterization:
*s* along the conic's major axis, (*phi*, *r*) polar coordinates in planes
normal to it, polar axis up; the OE centre lies on the surface and the
figure follows from (p, q, pitch) at create time.  The figure parameters
are host float64 (a tensor given through ``replace`` stays a tensor, and
a gradient flows to it through the search's Newton steps).  Capillaries
are surfaces of revolution about the beam axis: s = y, (phi, r) polar in
the planes normal to it (``_RevolutionMethods``).

In float32, ``xyz_to_param`` subtracts y0 = (q - p)/2 cos(pitch), which is
~1e4 mm for a long arm, so s carries one float32 ulp of ~2e-3 mm; the port
keeps the reference's formula (ROADMAP C7).
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..transforms import rotate_x
from ..materials.crystal import _over
from .base import OE

_FAR = 1e20


class _ConicParamMethods:
    """(x, y, z) <-> (s, phi, r) of a conic whose axis is tilted by gamma
    and shifted to (y0, z0) in the local frame."""
    isParametric = True

    def xyz_to_param(self, x, y, z):
        yNew, zNew = rotate_x(y - self.y0, z - self.z0, self.cosGamma,
                              self.sinGamma)
        return yNew, torch.atan2(x, zNew), sqrt_rn(x ** 2 + zNew ** 2)

    def param_to_xyz(self, s, phi, r):
        x = r * torch.sin(phi)
        z = r * torch.cos(phi)
        yNew, zNew = rotate_x(s, z, self.cosGamma, -self.sinGamma)
        return x, yNew + self.y0, zNew + self.z0


class EllipticalMirrorParam(_ConicParamMethods, OE):
    """Ellipsoid of revolution (or elliptical cylinder) with arms *p*, *q*
    (mm) at the grazing angle *pitch* (rad)."""

    def __init__(self, p=1000.0, q=1000.0, isCylindrical=False,
                 isClosed=False, **kwargs):
        super().__init__(**kwargs)
        self.p, self.q = float(p), float(q)
        self.isCylindrical, self.isClosed = bool(isCylindrical), \
            bool(isClosed)
        absPitch = abs(config.host_float(self.pitch))
        p, q = self.p, self.q
        gamma = math.atan2((p - q) * math.sin(absPitch),
                           (p + q) * math.cos(absPitch))
        self.ellipseA = (q + p) / 2.0
        self.ellipseB = math.sqrt(q * p) * math.sin(absPitch)
        self.y0 = (q - p) / 2.0 * math.cos(absPitch)
        self.z0 = (q + p) / 2.0 * math.sin(absPitch)
        self.cosGamma = math.cos(gamma)
        self.sinGamma = math.sin(gamma)

    @classmethod
    def create(cls, p=1000.0, q=1000.0, pitch=0.0, isCylindrical=False,
               isClosed=False, **kwargs):
        return super(EllipticalMirrorParam, cls).create(
            pitch=pitch, p=p, q=q, isCylindrical=isCylindrical,
            isClosed=isClosed, **kwargs)

    def local_r(self, s, phi):
        r = self.ellipseB * sqrt_rn(torch.abs(1 - s ** 2 /
                                              self.ellipseA ** 2))
        if self.isCylindrical:
            r = r / torch.clamp(torch.abs(torch.cos(phi)), min=1e-12)
        if self.isClosed:
            return r
        return torch.where(torch.abs(phi) > math.pi / 2, r,
                           torch.full_like(r, _FAR))

    def local_n(self, s, phi):
        A2s2 = self.ellipseA ** 2 - s ** 2
        A2s2 = torch.where(A2s2 <= 0, torch.full_like(A2s2, 1e22), A2s2)
        nr = -self.ellipseB / self.ellipseA * s / sqrt_rn(A2s2)
        norm = sqrt_rn(nr ** 2 + 1)
        b = nr / norm
        if self.isCylindrical:
            a = torch.zeros_like(phi)
            c = 1.0 / norm
        else:
            a = -torch.sin(phi) / norm
            c = -torch.cos(phi) / norm
        bNew, cNew = rotate_x(b, c, self.cosGamma, -self.sinGamma)
        return [a, bNew, cNew]


EllipticalMirror = EllipticalMirrorParam


class ParabolicalMirrorParam(_ConicParamMethods, OE):
    """Paraboloid of revolution (or parabolic cylinder) with one focal arm:
    collimating (give *p*) or focusing (give *q*)."""

    def __init__(self, p=None, q=None, isCylindrical=False, isClosed=False,
                 **kwargs):
        super().__init__(**kwargs)
        if (p is None) == (q is None):
            raise ValueError('give exactly one of p or q')
        self.p = None if p is None else float(p)
        self.q = None if q is None else float(q)
        self.isCylindrical, self.isClosed = bool(isCylindrical), \
            bool(isClosed)
        absPitch = abs(config.host_float(self.pitch))
        if p is None:
            self.y0 = q * math.cos(absPitch)
            self.z0 = q * math.sin(absPitch)
            self.parabParam = -q * math.sin(absPitch) ** 2
            gamma = absPitch
        else:
            self.y0 = -p * math.cos(absPitch)
            self.z0 = p * math.sin(absPitch)
            self.parabParam = p * math.sin(absPitch) ** 2
            gamma = -absPitch
        self.cosGamma = math.cos(gamma)
        self.sinGamma = math.sin(gamma)

    @classmethod
    def create(cls, p=None, q=None, pitch=0.0, isCylindrical=False,
               isClosed=False, **kwargs):
        return super(ParabolicalMirrorParam, cls).create(
            pitch=pitch, p=p, q=q, isCylindrical=isCylindrical,
            isClosed=isClosed, **kwargs)

    def local_r(self, s, phi):
        r2 = torch.clamp(self.parabParam * s + self.parabParam ** 2,
                         min=0.0)
        r = 2 * sqrt_rn(r2)
        if self.isCylindrical:
            r = r / torch.clamp(torch.abs(torch.cos(phi)), min=1e-12)
        if self.isClosed:
            return r
        return torch.where(torch.abs(phi) > math.pi / 2, r,
                           torch.full_like(r, _FAR))

    def local_n(self, s, phi):
        denom = sqrt_rn(torch.clamp(self.parabParam * s +
                                    self.parabParam ** 2, min=1e-30))
        nr = self.parabParam / denom
        norm = sqrt_rn(nr ** 2 + 1)
        b = nr / norm
        if self.isCylindrical:
            a = torch.zeros_like(phi)
            c = 1.0 / norm
        else:
            a = -torch.sin(phi) / norm
            c = -torch.cos(phi) / norm
        bNew, cNew = rotate_x(b, c, self.cosGamma, -self.sinGamma)
        return [a, bNew, cNew]


ParabolicMirror = ParabolicalMirrorParam


class HyperbolicMirrorParam(_ConicParamMethods, OE):
    """Hyperboloid of revolution (or hyperbolic cylinder); the outer
    surface reflects unless *useInnerSurface*."""

    def __init__(self, p=1000.0, q=1000.0, isCylindrical=False,
                 isClosed=False, useInnerSurface=False, **kwargs):
        super().__init__(**kwargs)
        self.p, self.q = float(p), float(q)
        self.isCylindrical, self.isClosed = bool(isCylindrical), \
            bool(isClosed)
        self.invertNormal = 1 if useInnerSurface else -1
        absPitch = abs(config.host_float(self.pitch))
        p, q = self.p, self.q
        gamma = math.atan2((p + q) * math.sin(absPitch),
                           (p - q) * math.cos(absPitch))
        self.hyperbolaA = abs(p - q) / 2.0
        self.hyperbolaB = math.sqrt(p * q) * math.sin(absPitch)
        self.y0 = -(p + q) / 2.0 * math.cos(absPitch)
        self.z0 = (p - q) / 2.0 * math.sin(absPitch)
        self.cosGamma = math.cos(gamma)
        self.sinGamma = math.sin(gamma)

    @classmethod
    def create(cls, p=1000.0, q=1000.0, pitch=0.0, isCylindrical=False,
               isClosed=False, useInnerSurface=False, **kwargs):
        return super(HyperbolicMirrorParam, cls).create(
            pitch=pitch, p=p, q=q, isCylindrical=isCylindrical,
            isClosed=isClosed, useInnerSurface=useInnerSurface, **kwargs)

    def local_r(self, s, phi):
        r = self.hyperbolaB * sqrt_rn(torch.abs(s ** 2 /
                                                self.hyperbolaA ** 2 - 1))
        if self.isCylindrical:
            r = r / torch.clamp(torch.abs(torch.cos(phi)), min=1e-12)
        if self.isClosed:
            return r
        return torch.where(torch.abs(phi) < math.pi / 2, r,
                           torch.full_like(r, _FAR))

    def local_n(self, s, phi):
        A2s2 = s ** 2 - self.hyperbolaA ** 2
        A2s2 = torch.where(A2s2 <= 0, torch.full_like(A2s2, 1e22), A2s2)
        nr = -self.hyperbolaB / self.hyperbolaA * s / sqrt_rn(A2s2)
        norm = sqrt_rn(nr ** 2 + 1)
        b = nr / norm
        if self.isCylindrical:
            a = torch.zeros_like(phi)
            c = 1.0 / norm
        else:
            a = torch.sin(phi) / norm
            c = torch.cos(phi) / norm
        bNew, cNew = rotate_x(b, c, self.cosGamma, -self.sinGamma)
        return [a, bNew, cNew]


HyperbolicMirror = HyperbolicMirrorParam


class _RevolutionMethods:
    """Cylindrical coordinates about the beam axis: s = y, (phi, r) polar
    in the planes normal to it."""
    isParametric = True

    def xyz_to_param(self, x, y, z):
        return y, torch.atan2(x, z), sqrt_rn(x ** 2 + z ** 2)

    def param_to_xyz(self, s, phi, r):
        return r * torch.sin(phi), s, r * torch.cos(phi)


#: the reference's name of the base of capillary optics: subclass it with
#: :class:`~xrt_tpu_torch.oes.OE` and define ``local_r(s, phi)`` and
#: ``local_n(s, phi)``
SurfaceOfRevolution = _RevolutionMethods


class EllipsoidCapillaryMirror(_RevolutionMethods, OE):
    """Ellipsoid-of-revolution capillary ("mirror lens"), centred on the
    major axis in the middle of the capillary; *workingDistance* runs from
    the end face to the focus."""

    def __init__(self, ellipseA=10000.0, ellipseB=2.5, workingDistance=17.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.ellipseA, self.ellipseB = ellipseA, ellipseB
        self.workingDistance = float(workingDistance)
        c = math.sqrt(config.host_float(ellipseA) ** 2 -
                      config.host_float(ellipseB) ** 2)
        self.ctd = c - self.workingDistance - 0.5 * abs(
            self.limPhysY[-1] - self.limPhysY[0])

    @classmethod
    def create(cls, ellipseA=10000.0, ellipseB=2.5, workingDistance=17.0,
               limPhysY=(-50.0, 50.0), **kwargs):
        return super(EllipsoidCapillaryMirror, cls).create(
            ellipseA=config.number(ellipseA),
            ellipseB=config.number(ellipseB),
            workingDistance=workingDistance, limPhysY=limPhysY, **kwargs)

    def local_r(self, s, phi):
        return self.ellipseB * sqrt_rn(torch.abs(
            1 - (self.ctd + s) ** 2 / self.ellipseA ** 2))

    def local_n(self, s, phi):
        A2s2 = self.ellipseA ** 2 - (self.ctd + s) ** 2
        A2s2 = torch.where(A2s2 <= 0, torch.full_like(A2s2, 1e22), A2s2)
        nr = -self.ellipseB / self.ellipseA * (self.ctd + s) / \
            sqrt_rn(A2s2)
        norm = sqrt_rn(nr ** 2 + 1.0)
        return [-torch.sin(phi) / norm, nr / norm, -torch.cos(phi) / norm]


class ParaboloidCapillaryMirror(_RevolutionMethods, OE):
    """Paraboloid-of-revolution capillary, oriented for focusing: *q* from
    the element's centre to the focus, *r0* the radius at the centre."""

    def __init__(self, q=500.0, r0=2.5, **kwargs):
        super().__init__(**kwargs)
        self.q, self.r0 = float(q), float(r0)
        self.focus = -0.5 * (self.q - math.sqrt(self.q ** 2 + self.r0 ** 2))
        self.s0 = self.focus + self.q

    @classmethod
    def create(cls, q=500.0, r0=2.5, **kwargs):
        return super(ParaboloidCapillaryMirror, cls).create(
            q=q, r0=r0, **kwargs)

    def local_r(self, s, phi):
        return 2 * sqrt_rn(torch.clamp((self.s0 - s) * self.focus,
                                       min=0.0))

    def local_n(self, s, phi):
        a = -torch.sin(phi)
        b = -sqrt_rn(_over(self.focus, torch.clamp(self.s0 - s, min=1e-12)))
        c = -torch.cos(phi)
        norm = sqrt_rn(a ** 2 + b ** 2 + c ** 2)
        return [a / norm, b / norm, c / norm]


class HyperboloidCapillaryMirror(_RevolutionMethods, OE):
    """Hyperboloid-of-revolution capillary; the outer surface reflects."""

    invertNormal = -1

    def __init__(self, hyperbolaA=10000.0, hyperbolaB=2.5,
                 workingDistance=17.0, **kwargs):
        super().__init__(**kwargs)
        self.hyperbolaA, self.hyperbolaB = float(hyperbolaA), \
            float(hyperbolaB)
        self.workingDistance = float(workingDistance)
        c = math.sqrt(self.hyperbolaA ** 2 + self.hyperbolaB ** 2)
        self.ctd = c + self.workingDistance + 0.5 * abs(
            self.limPhysY[-1] - self.limPhysY[0])

    @classmethod
    def create(cls, hyperbolaA=10000.0, hyperbolaB=2.5,
               workingDistance=17.0, limPhysY=(-50.0, 50.0), **kwargs):
        return super(HyperboloidCapillaryMirror, cls).create(
            hyperbolaA=hyperbolaA, hyperbolaB=hyperbolaB,
            workingDistance=workingDistance, limPhysY=limPhysY, **kwargs)

    def local_r(self, s, phi):
        ss = self.ctd + s
        return self.hyperbolaB * sqrt_rn(torch.abs(
            ss ** 2 / self.hyperbolaA ** 2 - 1))

    def local_n(self, s, phi):
        ss = self.ctd + s
        A2s2 = ss ** 2 - self.hyperbolaA ** 2
        A2s2 = torch.where(A2s2 <= 0, torch.full_like(A2s2, 1e22), A2s2)
        nr = -self.hyperbolaB / self.hyperbolaA * ss / sqrt_rn(A2s2)
        norm = sqrt_rn(nr ** 2 + 1)
        return [torch.sin(phi) / norm, nr / norm, torch.cos(phi) / norm]
