"""Parametric mirrors: the exact elliptical figure.

Port of ``_ConicParamMethods`` and ``EllipticalMirrorParam`` of the
reference package's ``oes/parametric.py``.  Parameterization: *s* along the
conic's major axis, (*phi*, *r*) polar coordinates in planes normal to it,
polar axis up; the OE centre lies on the surface and the figure follows
from (p, q, pitch) at create time.  The figure parameters are host float64.

In float32, ``xyz_to_param`` subtracts y0 = (q - p)/2 cos(pitch), which is
~1e4 mm for a long arm, so s carries one float32 ulp of ~2e-3 mm; the port
keeps the reference's formula (ROADMAP C7).  The parabolic, hyperbolic and
capillary surfaces come with ROADMAP A8.
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..transforms import rotate_x
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
