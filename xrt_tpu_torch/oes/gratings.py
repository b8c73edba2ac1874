"""Gratings and Fresnel zone plates.

Port of the reference package's ``oes/gratings.py``:

* ``Grating``: a plane grating of (polynomially varied) line density, and
  the zone plates ``NormalFZP`` (circular binary zones; opaque zones kill
  their rays, open ones diffract by the local radial grating vector) and
  ``GeneralFZPin0YZ`` (zones of two focal points), which diffract through
  their local grating vector ``local_g`` in ``OE._interact`` (kinds
  'grating' and 'FZP');
* ``BlazedGrating`` (sawtooth), ``LaminarGrating`` and
  ``VLSLaminarGrating`` (rectangular grooves): surfaces whose diffraction
  comes from the Kirchhoff integral over the real profile, so they take a
  'mirror'-kind material; their analytic intersections replace the
  search.

Facet and groove indices are taken by true divisions by 0-dim tensors
(PyTorch's CUDA division by a Python number multiplies by the reciprocal,
and a sample at an edge could land on the other side).  The blazed
grating's groove arithmetic runs in float64 whatever the rays' dtype: its
antiblaze facet is ~1.1e-8 mm wide at 300 lines/mm, below float32's
rounding of y (a few 1e-6 mm at |y| ~ 40 mm), so a float32 groove index
put samples near an edge on the wrong facet.  The zone index of
``NormalFZP`` is n = 2 r^2 / ((sqrt(f^2 + r^2) + f) lambda), the reference's
2 (sqrt(f^2 + r^2) - f) / lambda without the difference of two numbers
near f, which in float32 is one ulp of f: 1770 zones at f = 2000 mm, 9 keV
(ROADMAP C14).
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..physconsts import CH
from .base import OE


def _T(v, like):
    """*v* as a 0-dim tensor of *like*'s dtype on its device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _mod(x, p):
    """x mod p with the sign of p (a truncated remainder, then moved
    into p's sign), as the reference's floor-mod."""
    r = torch.fmod(x, p)
    return torch.where((r != 0) & ((r < 0) != (p < 0)), r + p, r)


class Grating(OE):
    """A plane diffraction grating of *rho* lines/mm along y, with the
    line density rho (1 + 2 b2 y + 3 b3 y^2 + ...) for *vlsCoeffs*
    (b2, b3, ...).  Give it a 'grating'-kind material (or an
    ``EmptyMaterial``) and an *order*."""

    def __init__(self, rho=300.0, vlsCoeffs=None, **kwargs):
        super().__init__(**kwargs)
        self.rho = config.number(rho)
        self.vlsCoeffs = None if vlsCoeffs is None else \
            tuple(float(v) for v in vlsCoeffs)

    @classmethod
    def create(cls, rho=300.0, vlsCoeffs=None, **kwargs):
        kwargs.setdefault('order', 1)
        kwargs.setdefault('auto_material_kind', 'grating')
        return super(Grating, cls).create(rho=rho, vlsCoeffs=vlsCoeffs,
                                          **kwargs)

    def local_g(self, x, y):
        rho = self.rho
        if self.vlsCoeffs is not None:
            poly = torch.ones_like(y)
            for i, b in enumerate(self.vlsCoeffs):
                poly = poly + (i + 2) * b * y ** (i + 1)
            rho = rho * poly
        return [torch.zeros_like(x), -rho * torch.ones_like(y),
                torch.zeros_like(x)]


class NormalFZP(OE):
    """Circular Fresnel zone plate of focal length *f* (mm) at energy *E*
    (eV) with *N* zones of zero thickness: r_n = sqrt(n f lambda +
    (n lambda / 2)^2).  Rays in opaque zones are lost, those in open zones
    get the local radial grating vector."""

    def __init__(self, f=50.0, E0=1000.0, N=1000, isCentralZoneBlack=True,
                 **kwargs):
        super().__init__(**kwargs)
        self.f = config.number(f)
        self.E0 = float(E0)
        self.N = int(N)
        self.isCentralZoneBlack = isCentralZoneBlack

    @classmethod
    def create(cls, f=50.0, E=1000.0, N=1000, thinnestZone=None,
               isCentralZoneBlack=True, order=1, **kwargs):
        lambdaE = CH / E * 1e-7
        if thinnestZone is not None:
            N = int(lambdaE * f / 4.0 / thinnestZone ** 2)
        rN = math.sqrt(N * f * lambdaE + 0.25 * (N * lambdaE) ** 2)
        kwargs.setdefault('limPhysX', (-rN, rN))
        kwargs.setdefault('limPhysY', (-rN, rN))
        kwargs.setdefault('shape', 'round')
        kwargs.setdefault('auto_material_kind', 'FZP')
        return super(NormalFZP, cls).create(
            f=f, E0=float(E), N=int(N),
            isCentralZoneBlack=isCentralZoneBlack, order=order, **kwargs)

    @property
    def _lambdaE(self):
        return CH / self.E0 * 1e-7

    def _r_of_n(self, n):
        lam = self._lambdaE
        return sqrt_rn(torch.clamp(n * self.f * lam + 0.25 * (n * lam) ** 2,
                                   min=0.0))

    def _n_of_r(self, r):
        """The zone index of radius r: 2 r^2 / ((sqrt(f^2 + r^2) + f)
        lambda), free of cancellation (ROADMAP C14)."""
        f = _T(self.f, r)
        r2 = r * r
        return 2.0 * r2 / ((sqrt_rn(f * f + r2) + f) * _T(self._lambdaE, r))

    def rays_good(self, x, y, state, lostNum=config.STATE_DEAD,
                  limits=None):
        locState = OE.rays_good(self, x, y, state, lostNum, limits)
        r = sqrt_rn(x * x + y * y)
        i = torch.floor(self._n_of_r(r)).to(torch.int32)
        rmax = self._r_of_n(config.scalar(self.N, r.dtype, r.device))
        transparent = (i % 2 == int(self.isCentralZoneBlack)) & (r < rmax)
        return torch.where((locState == 1) & ~transparent, lostNum,
                           locState).to(state.dtype)

    def local_g(self, x, y):
        r = sqrt_rn(x * x + y * y)
        i = torch.floor(self._n_of_r(r))
        rho = 1.0 / torch.clamp(self._r_of_n(i + 1) - self._r_of_n(i - 1),
                                min=1e-12)
        rsafe = torch.clamp(r, min=1e-12)
        return [-x / rsafe * rho, -y / rsafe * rho, torch.zeros_like(x)]


class GeneralFZPin0YZ(OE):
    """Zone plate for the focal points *f1* (real) and *f2* (real, or
    virtual with *f2isVirtual*) given in the local frame, through its local
    grating vector: the gradient of the phase k (|r - f1| +- |r - f2|)
    over 2 pi."""

    def __init__(self, f1=(0, 0, -50.0), f2=(0, 0, 50.0), E0=1000.0,
                 f2Virtual=False, **kwargs):
        super().__init__(**kwargs)
        self.f1 = tuple(float(v) for v in f1)
        self.f2 = tuple(float(v) for v in f2)
        self.E0 = float(E0)
        self.f2Virtual = f2Virtual

    @classmethod
    def create(cls, f1=(0, 0, -50.0), f2=(0, 0, 50.0), E=1000.0,
               f2isVirtual=False, order=1, **kwargs):
        kwargs.setdefault('auto_material_kind', 'FZP')
        return super(GeneralFZPin0YZ, cls).create(
            f1=f1, f2=f2, E0=float(E), f2Virtual=f2isVirtual, order=order,
            **kwargs)

    def local_g(self, x, y):
        lam = _T(CH / self.E0 * 1e-7, x)
        sign2 = -1.0 if self.f2Virtual else 1.0

        def grad_path(f):
            dx = x - f[0]
            dy = y - f[1]
            dz = -f[2]
            r = sqrt_rn(dx ** 2 + dy ** 2 + dz ** 2)
            return dx / r, dy / r
        g1x, g1y = grad_path(self.f1)
        g2x, g2y = grad_path(self.f2)
        gx = (g1x + sign2 * g2x) / lam
        gy = (g1y + sign2 * g2y) / lam
        return [-gx, -gy, torch.zeros_like(x)]


class BlazedGrating(OE):
    """Sawtooth-profile grating of *rho* lines/mm with facet angles *blaze*
    and *antiblaze* (rad)."""

    def __init__(self, blaze=None, antiblaze=math.pi * 0.4999, rho=300.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.blaze = config.number(blaze)
        self.antiblaze = config.number(antiblaze)
        self.rho = config.number(rho)

    @classmethod
    def create(cls, blaze=None, antiblaze=math.pi * 0.4999, rho=300.0,
               **kwargs):
        return super(BlazedGrating, cls).create(blaze=blaze,
                                                antiblaze=antiblaze,
                                                rho=rho, **kwargs)

    @property
    def rho_1(self):
        """The groove period, mm."""
        return 1.0 / self.rho

    def _consts(self, like):
        """(period, tan blaze, tan antiblaze) as 0-dim float64 tensors on
        *like*'s device."""
        def T(v):
            return torch.as_tensor(v, dtype=torch.float64, device=like.device)
        return (T(1.0) / T(self.rho), torch.tan(T(self.blaze)),
                torch.tan(T(self.antiblaze)))

    def _local_pre(self, y):
        """The groove arithmetic in float64, whatever *y*'s dtype: (y, y1,
        yC, yL, tanB, tanA) with y as float64, y1 the period's end, yC the
        antiblaze facet's width and yL the in-period coordinate (the blaze
        facet is yL > yC)."""
        y = y.to(torch.float64)
        rho_1, tanB, tanA = self._consts(y)
        y0 = torch.floor(y / rho_1) * rho_1
        y1 = y0 + rho_1
        yL = y - y0
        yC = (y1 - y0) / (1 + tanA / tanB)
        return y, y1, yC, yL, tanB, tanA

    def local_z(self, x, y):
        y64, y1, yC, yL, tanB, tanA = self._local_pre(y)
        return torch.where(yL > yC, -(y1 - y64) * tanB,
                           -yL * tanA).to(y.dtype)

    def local_n(self, x, y):
        _, _, yC, yL, _, _ = self._local_pre(y)

        def T(v):
            return torch.as_tensor(v, dtype=torch.float64, device=y.device)
        blaze, anti = T(self.blaze), T(self.antiblaze)
        on_blaze = yL > yC
        return [torch.zeros_like(x),
                torch.where(on_blaze, -torch.sin(blaze),
                            torch.sin(anti)).to(y.dtype),
                torch.where(on_blaze, torch.cos(blaze),
                            torch.cos(anti)).to(y.dtype)]

    def analytic_intersect(self, tMin, tMax, x, y, z, a, b, c):
        """The hit on the blaze facet of the period that holds the ray's
        z = 0 crossing (the first, illuminated facet crossing), in float64
        like the groove arithmetic of :meth:`local_z`, returned in the
        rays' dtype."""
        dt = y.dtype
        x, y, z, a, b, c = (v.to(torch.float64) for v in (x, y, z, a, b, c))
        rho_1, tanB, _ = self._consts(y)
        b_c = b / torch.where(c == 0, torch.full_like(c, -1e-12), c)
        yz = y - b_c * z
        y1 = rho_1 * torch.floor(yz / rho_1) + rho_1
        z2 = tanB * (yz - y1) / (1 - tanB * b_c)
        y2 = b_c * (z2 - z) + y
        t2 = (y2 - y) / torch.where(b == 0, torch.full_like(b, 1e-12), b)
        x2 = x + t2 * a
        return (t2.to(dt), x2.to(dt), y2.to(dt), z2.to(dt),
                torch.zeros_like(t2, dtype=torch.bool))

    def get_grating_area_fraction(self):
        """Illuminated fraction of the period at the grating's pitch (host
        float64)."""
        rho = config.host_float(self.rho)
        rho_1 = 1.0 / rho
        tanPitch = math.tan(abs(config.host_float(self.pitch)))
        tanB = math.tan(config.host_float(self.blaze))
        y1 = rho_1 * tanB / (tanB + tanPitch)
        z1 = -y1 * tanPitch
        return math.sqrt((rho_1 - y1) ** 2 + z1 ** 2) * rho


class LaminarGrating(OE):
    """Rectangular-profile (laminar) grating of *rho* lines/mm: ridges of
    the fraction *aspect* of a period at z = 0, grooves at z = -*depth*."""

    def __init__(self, rho=300.0, aspect=0.5, depth=1e-3, **kwargs):
        super().__init__(**kwargs)
        self.rho = config.number(rho)
        self.aspect = config.number(aspect)
        self.depth = config.number(depth)

    @classmethod
    def create(cls, rho=300.0, aspect=0.5, depth=1e-3, **kwargs):
        return super(LaminarGrating, cls).create(rho=rho, aspect=aspect,
                                                 depth=depth, **kwargs)

    def _period(self, like):
        return _T(1.0, like) / _T(self.rho, like)

    def local_z(self, x, y):
        rho_1 = self._period(y)
        top = _mod(y, rho_1) < self.aspect * rho_1
        return torch.where(top, torch.zeros_like(y),
                           -self.depth * torch.ones_like(y))

    def local_n(self, x, y):
        return [torch.zeros_like(x), torch.zeros_like(y),
                torch.ones_like(x)]

    def analytic_intersect(self, tMin, tMax, x, y, z, a, b, c):
        """The hit on a ridge top (z = 0) where the ray crosses z = 0 on
        one, else on the groove floor."""
        rho_1 = self._period(y)
        csafe = torch.where(c == 0, torch.full_like(c, -1e-12), c)
        t_top = -z / csafe
        on_top = _mod(y + b * t_top, rho_1) < self.aspect * rho_1
        t_bot = (-self.depth - z) / csafe
        t2 = torch.where(on_top, t_top, t_bot)
        return (t2, x + a * t2, y + b * t2, z + c * t2,
                torch.zeros_like(t2, dtype=torch.bool))


class VLSLaminarGrating(LaminarGrating):
    """Laminar grating whose groove number is rho (c1 y + c2 y^2 + ...)
    for *coeffs* (c1, c2, ...): rho(y) = rho (c1 + 2 c2 y + ...)."""

    def __init__(self, coeffs=(1.0, 0.0, 0.0), **kwargs):
        super().__init__(**kwargs)
        self.coeffs = tuple(float(v) for v in coeffs)

    @classmethod
    def create(cls, rho=300.0, coeffs=(1.0, 0.0, 0.0), **kwargs):
        return super(VLSLaminarGrating, cls).create(rho=rho, coeffs=coeffs,
                                                    **kwargs)

    def _groove_number(self, y):
        g = torch.zeros_like(y)
        for i, ci in enumerate(self.coeffs):
            g = g + ci * y ** (i + 1)
        return self.rho * g

    def local_z(self, x, y):
        frac = _mod(self._groove_number(y), _T(1.0, y))
        return torch.where(frac < self.aspect, torch.zeros_like(y),
                           -self.depth * torch.ones_like(y))
