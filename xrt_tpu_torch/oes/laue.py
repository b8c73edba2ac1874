"""Laue-geometry crystal optics.

Port of the reference package's ``oes/laue.py``: the flat ``LauePlate``,
the simply bent ``BentLaueCylinder`` (circular or parabolic section), its
ground-bent variant ``GroundBentLaueCylinder``, the spherical
``BentLaueSphere`` and the parabolically 2D-bent ``BentLaue2D`` with its
depth-dependent lattice orientation (``local_n_depth``) for volumetric
diffraction.  The thickness comes from the crystal; ``local_n`` gives the
Bragg-plane normal, which lies in the surface (turned by the asymmetry
angle *alpha*), and the surface normal.
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..materials.tt import compute_tt_params_full
from ..ops.dd import sqrt_rn
from ..transforms import cos, rotate_x, sin
from .base import OE
from .mirrors import rmer_from_coddington


def _root(v):
    """sqrt(max(v, 1e-30)): the reference's guard of the circle's root."""
    return sqrt_rn(torch.clamp(v, min=1e-30))


class LauePlate(OE):
    """A flat Laue plate."""

    def local_n(self, x, y):
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        if self.alpha is not None:
            bB, cB = rotate_x(zero, one, -sin(self.alpha), -cos(self.alpha))
        else:
            bB, cB = one, -zero
        return [zero, bB, cB, zero, zero, one]


class BentLaueCylinder(OE):
    """A crystal in Laue geometry bent to the radius *R* (mm; a (p, q)
    pair gives the meridional Coddington radius at the pitch), circular
    or parabolic in section."""

    def __init__(self, R=1000.0, crossSection='circular', **kwargs):
        super().__init__(**kwargs)
        self.R = config.number(R)
        self.crossSection = crossSection

    @classmethod
    def create(cls, R=1000.0, crossSection='circular', pitch=0.0,
               bragg=None, **kwargs):
        if not (crossSection.startswith('circ') or
                crossSection.startswith('parab')):
            raise ValueError('unknown crossSection!')
        if isinstance(R, (tuple, list)):
            ang = config.auto_units_angle(bragg if bragg else pitch)
            R = float(rmer_from_coddington(R[0], R[1], ang))
        return super(BentLaueCylinder, cls).create(
            R=R, crossSection=crossSection, pitch=pitch, bragg=bragg,
            **kwargs)

    def local_z(self, x, y):
        if self.crossSection.startswith('circ'):
            return self.R - _root(self.R ** 2 - y ** 2)
        return y ** 2 / 2.0 / self.R

    def local_n_cylinder(self, x, y, R, withAlpha):
        a = torch.zeros_like(x)
        b = -y / R
        if self.crossSection.startswith('circ'):
            c = _root(R ** 2 - y ** 2) / R
        else:
            norm = sqrt_rn(b ** 2 + 1)
            b = b / norm
            c = 1.0 / norm
        if withAlpha and self.alpha is not None:
            bB, cB = rotate_x(b, c, -sin(self.alpha), -cos(self.alpha))
        else:
            bB, cB = c, -b
        return [a, bB, cB, a, b, c]

    def local_n(self, x, y):
        return self.local_n_cylinder(x, y, self.R, True)


class GroundBentLaueCylinder(BentLaueCylinder):
    """A ground-bent Laue crystal: its planes follow a circle of radius
    2R (ground to R, then bent to R)."""

    def local_n(self, x, y):
        nSurf = self.local_n_cylinder(x, y, self.R, False)
        a = torch.zeros_like(x)
        b = -y
        c = _root(self.R ** 2 - y ** 2) + self.R
        if self.alpha is not None:
            b, c = rotate_x(b, c, -sin(self.alpha), -cos(self.alpha))
        else:
            b, c = c, -b
        norm = sqrt_rn(b ** 2 + c ** 2)
        return [a / norm, b / norm, c / norm,
                nSurf[-3], nSurf[-2], nSurf[-1]]


class BentLaue2D(OE):
    """A Laue crystal bent parabolically to the meridional radius *Rm* and
    the sagittal *Rs* (mm; None or 0 is flat), whose lattice orientation
    at depth follows the displacement jacobian of the crystal's elastic
    model (``djparams``, [coef1, coef2, invR1, coef3, invR2] in 1/um,
    taken at creation by ``compute_tt_params_full``; None without one,
    and then an isotropic estimate with the crystal's nu, 0.22 if unset).
    With a ``volumetricDiffraction`` crystal the diffraction point is
    drawn through the depth."""

    def __init__(self, Rm=1.0e4, Rs=-5.0e4, djparams=None, **kwargs):
        super().__init__(**kwargs)
        self.Rm = config.number(Rm)
        self.Rs = config.number(Rs)
        self.djparams = djparams

    @classmethod
    def create(cls, Rm=1.0e4, Rs=-5.0e4, material=None, alpha=0.0,
               **kwargs):
        Rm = math.inf if Rm in (None, 0) else float(Rm)
        Rs = math.inf if Rs in (None, 0) else float(Rs)
        dj = None
        if material is not None and hasattr(material, 'get_F_chi'):
            try:
                dj = tuple(float(v) for v in compute_tt_params_full(
                    material, alpha, Rm=Rm, Rs=Rs))
            except (ValueError, KeyError):
                dj = None
        return super(BentLaue2D, cls).create(
            Rm=Rm, Rs=Rs, djparams=dj, material=material, alpha=alpha,
            **kwargs)

    def local_z(self, x, y):
        return 0.5 * x ** 2 / self.Rs + 0.5 * y ** 2 / self.Rm

    def local_n(self, x, y):
        """The surface normal, and the Bragg-plane normal turned by the
        local surface slopes."""
        a = -x / self.Rs
        b = -y / self.Rm
        norm = sqrt_rn(a ** 2 + b ** 2 + 1.0)
        a, b, c = a / norm, b / norm, 1.0 / norm
        sinpitch = -b
        cospitch = sqrt_rn(torch.clamp(1 - b ** 2, 0.0, 1.0))
        sinroll = -a
        cosroll = sqrt_rn(torch.clamp(1 - a ** 2, 0.0, 1.0))
        aB = torch.zeros_like(a)
        bB = torch.ones_like(a)
        cB = torch.zeros_like(a)
        if self.alpha is not None:
            bB, cB = rotate_x(bB, cB, cos(self.alpha), -sin(self.alpha))
        # about y by the roll, then about x by the pitch
        aB, cB = (cosroll * aB + (-sinroll) * cB,
                  sinroll * aB + cosroll * cB)
        bB, cB = rotate_x(bB, cB, cospitch, sinpitch)
        normB = sqrt_rn(aB ** 2 + bB ** 2 + cB ** 2)
        return [aB / normB, bB / normB, cB / normB, a, b, c]

    def local_n_depth(self, x, y, z):
        """The Bragg-plane normal at depth *z*, strained by the
        displacement field's jacobian, h' = h - grad(u . h), and the
        surface normal."""
        alpha = self.alpha if self.alpha is not None else 0.0
        a = -x / self.Rs
        b = -y / self.Rm
        norm = sqrt_rn(a ** 2 + b ** 2 + 1.0)
        a, b, c = a / norm, b / norm, 1.0 / norm
        hx = torch.zeros_like(x)
        hy = cos(alpha) * torch.ones_like(x)
        hz = -sin(alpha) * torch.ones_like(x)
        if self.djparams is not None:
            coef1, coef2, invR1, coef3, invR2 = self.djparams
            # the jacobian in 1/um, to 1/mm
            duh_dx = (hx * (-z * invR2) + hz * (x * invR2)) * 1e3
            duh_dy = (hy * (-z * invR1) + hz * (y * invR1)) * 1e3
            duh_dz = (hx * (-x * invR2 + z * coef3) +
                      hy * (-y * invR1 + z * coef2) +
                      hz * (z * coef1)) * 1e3
        else:
            nu = getattr(self.material, 'nu', None)
            nu = 0.22 if nu is None else nu     # a Si-like anticlastic bend
            duh_dx = hx * (-z * nu / self.Rm) + hz * (-x * nu / self.Rm)
            duh_dy = hy * (-z / self.Rm) + hz * (y / self.Rm)
            duh_dz = (hx * (-x * nu / self.Rm) + hy * (-y / self.Rm) +
                      hz * (nu * z / self.Rm))
        hpx = hx - duh_dx
        hpy = hy - duh_dy
        hpz = hz - duh_dz
        hn = sqrt_rn(hpx ** 2 + hpy ** 2 + hpz ** 2)
        return [hpx / hn, hpy / hn, hpz / hn, a, b, c]


class BentLaueSphere(BentLaueCylinder):
    """A spherically bent Laue crystal."""

    def local_z(self, x, y):
        if self.crossSection.startswith('circ'):
            return self.R - _root(self.R ** 2 - x ** 2 - y ** 2)
        return (x ** 2 + y ** 2) / 2.0 / self.R

    def local_n(self, x, y):
        if self.crossSection.startswith('circ'):
            s = _root(self.R ** 2 - x ** 2 - y ** 2)
            a = -x / s
            b = -y / s
        else:
            a = -x / self.R
            b = -y / self.R
        c = torch.ones_like(x)
        norm = sqrt_rn(a ** 2 + b ** 2 + 1)
        aB = torch.zeros_like(x)
        normB = sqrt_rn(b ** 2 + c ** 2)
        return [aB / normB, c / normB, -b / normB,
                a / norm, b / norm, c / norm]
