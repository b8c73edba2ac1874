"""Stock mirrors: flat, bent-flat (cylindrical), spherical, toroidal,
sagittally cylindrical and conical, with the Coddington helpers.

Port of the reference package's ``oes/mirrors.py``.  Radii and angles are
Python floats, or the tensors that were passed in.  ``DualVFM`` and the
tripod support come with ROADMAP A8.
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

