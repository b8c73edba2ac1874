"""Bent-crystal analyzer optics: Johann and Johansson cylinders and
toroids, the general Bragg toroid, and their diced versions.

Port of the reference package's ``oes/bragg.py``.  A Johansson crystal's
Bragg planes follow the Rowland circle while its surface is bent to Rm, so
``local_n`` gives the Bragg-plane normal and the surface normal as six
components.  A diced element is cut into facets (dxFacet x dyFacet, gaps
dxGap, dyGap): the facet of a point is round(x / step), rounded half to
even as the reference rounds, and a ray that lands in a gap is lost.
"""
from __future__ import annotations

import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..transforms import cos, rotate_x, rotate_y, sin
from .base import KERNEL_FNS, OE


def _root(v):
    """sqrt(max(v, 1e-30)): the reference's guard of the circle's root."""
    return sqrt_rn(torch.clamp(v, min=1e-30))


class JohannCylinder(OE):
    """A simply bent crystal: cylindrical (crossSection='circular') or
    parabolic meridional bending of radius *Rm*."""

    def __init__(self, Rm=1000.0, crossSection='circular', **kwargs):
        super().__init__(**kwargs)
        self.Rm = config.number(Rm)
        self.crossSection = crossSection

    @classmethod
    def create(cls, Rm=1000.0, crossSection='circular', **kwargs):
        if not (crossSection.startswith('circ') or
                crossSection.startswith('parab')):
            raise ValueError('unknown crossSection!')
        return super(JohannCylinder, cls).create(
            Rm=Rm, crossSection=crossSection, **kwargs)

    def local_z(self, x, y):
        if self.crossSection.startswith('circ'):
            return self.Rm - _root(self.Rm ** 2 - y ** 2)
        return y ** 2 / 2.0 / self.Rm

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
            bA, cA = rotate_x(b, c, cos(self.alpha), -sin(self.alpha))
            return [a, bA, cA, a, b, c]
        return [a, b, c]

    def local_n(self, x, y):
        return self.local_n_cylinder(x, y, self.Rm, True)


class JohanssonCylinder(JohannCylinder):
    """A ground-bent (Johansson) crystal: the Bragg planes follow the
    Rowland circle (radius 2 Rm in effect), the surface is bent to Rm."""

    def local_n(self, x, y):
        nSurf = self.local_n_cylinder(x, y, self.Rm, False)
        a = torch.zeros_like(x)
        b = -y
        c = _root(self.Rm ** 2 - y ** 2) + self.Rm
        if self.alpha is not None:
            b, c = rotate_x(b, c, cos(self.alpha), -sin(self.alpha))
        norm = sqrt_rn(b ** 2 + c ** 2)
        return [a / norm, b / norm, c / norm,
                nSurf[-3], nSurf[-2], nSurf[-1]]


class JohannToroid(OE):
    """A 2D-bent crystal with the meridional radius *Rm* and the sagittal
    radius *Rs* (Rm by default)."""

    #: the CUDA kernels' surface and normals of this class
    #: (``base.kernel_kind``); a subclass inherits its parent's only where
    #: every function of ``base.KERNEL_FNS`` is the parent's
    kernel_kind = 'johann'

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if 'kernel_kind' in vars(cls):
            return
        owner = next(c for c in cls.__mro__[1:] if 'kernel_kind' in vars(c))
        if any(getattr(cls, name, None) is not getattr(owner, name, None)
               for name in KERNEL_FNS):
            cls.kernel_kind = None

    def __init__(self, Rm=1000.0, Rs=None, **kwargs):
        super().__init__(**kwargs)
        self.Rm = config.number(Rm)
        self.Rs = config.number(Rm if Rs is None else Rs)

    @classmethod
    def create(cls, Rm=1000.0, Rs=None, **kwargs):
        return super(JohannToroid, cls).create(
            Rm=Rm, Rs=Rm if Rs is None else Rs, **kwargs)

    def local_z(self, x, y):
        z = self.Rm - self.Rs - _root(self.Rm ** 2 - y ** 2)
        absz = torch.abs(z)
        cosangle = _root(z ** 2 - x ** 2) / absz
        sinangle = -x / absz
        _, z2 = rotate_y(torch.zeros_like(z), z, cosangle, sinangle)
        return z2 + self.Rs

    def local_n_toroid(self, x, y, Rm, Rs, withAlpha):
        a = torch.zeros_like(x)
        b = -y / Rm
        c = _root(Rm ** 2 - y ** 2) / Rm
        hasAlpha = withAlpha and self.alpha is not None
        if hasAlpha:
            aA = torch.zeros_like(x)
            bA, cA = rotate_x(b, c, cos(self.alpha), -sin(self.alpha))
        r = Rs - (Rm - _root(Rm ** 2 - y ** 2))
        cosangle = _root(r ** 2 - x ** 2) / r
        sinangle = -x / r
        a, c = rotate_y(a, c, cosangle, sinangle)
        if hasAlpha:
            aA, cA = rotate_y(aA, cA, cosangle, sinangle)
            return [aA, bA, cA, a, b, c]
        return [a, b, c]

    def local_n(self, x, y):
        return self.local_n_toroid(x, y, self.Rm, self.Rs, True)


class JohanssonToroid(JohannToroid):
    """A ground 2D-bent (Johansson) toroid."""

    kernel_kind = 'johansson'

    def local_n(self, x, y):
        nSurf = self.local_n_toroid(x, y, self.Rm, self.Rs, False)
        a = torch.zeros_like(x)
        b = -y
        c = _root(self.Rm ** 2 - y ** 2) + self.Rm
        norm = sqrt_rn(b ** 2 + c ** 2)
        b, c = b / norm, c / norm
        if self.alpha is not None:
            b, c = rotate_x(b, c, cos(self.alpha), -sin(self.alpha))
        r = self.Rs - (self.Rm - _root(self.Rm ** 2 - y ** 2))
        cosangle = _root(r ** 2 - x ** 2) / r
        sinangle = -x / r
        a, c = rotate_y(a, c, cosangle, sinangle)
        if self.alpha is not None:
            a, c = rotate_y(a, c, cosangle, sinangle)
        return [a, b, c, nSurf[-3], nSurf[-2], nSurf[-1]]


class GeneralBraggToroid(JohannToroid):
    """A toroid with four radii: the surface's (Rm, Rs) and the Bragg
    planes' (RmBragg, RsBragg)."""

    kernel_kind = 'general'

    def __init__(self, RmBragg=None, RsBragg=None, **kwargs):
        super().__init__(**kwargs)
        self.RmBragg = config.number(self.Rm if RmBragg is None
                                     else RmBragg)
        self.RsBragg = config.number(self.Rs if RsBragg is None
                                     else RsBragg)

    @classmethod
    def create(cls, Rm=1000.0, Rs=None, RmBragg=None, RsBragg=None,
               **kwargs):
        Rs = Rm if Rs is None else Rs
        return super(GeneralBraggToroid, cls).create(
            Rm=Rm, Rs=Rs, RmBragg=Rm if RmBragg is None else RmBragg,
            RsBragg=Rs if RsBragg is None else RsBragg, **kwargs)

    def local_n(self, x, y):
        nSurf = self.local_n_toroid(x, y, self.Rm, self.Rs, False)
        nBr = self.local_n_toroid(x, y, self.RmBragg, self.RsBragg, False)
        return [nBr[0], nBr[1], nBr[2], nSurf[-3], nSurf[-2], nSurf[-1]]


class _DicedMethods:
    """The facet decomposition of a diced element."""

    def _init_facets(self, dxFacet, dyFacet, dxGap, dyGap):
        self.dxFacet, self.dyFacet = float(dxFacet), float(dyFacet)
        self.dxGap, self.dyGap = float(dxGap), float(dyGap)

    def facet_center_z(self, x, y):
        return torch.zeros_like(y)

    def facet_center_n(self, x, y):
        return [torch.zeros_like(x), torch.zeros_like(x), torch.ones_like(x)]

    def facet_delta_z(self, u, v):
        return torch.zeros_like(u)

    def facet_delta_n(self, u, v):
        return None

    def _facets(self, x, y):
        """(facet centre x, y, position in the facet u, v).  The steps are
        sums of 0-dim tensors in the rays' dtype, as the reference forms
        them, and a division by them is a true division on every device, so
        a point at a facet edge takes the reference's facet; torch.round
        rounds half to even, as the reference does."""
        def T(v):
            return config.scalar(v, x.dtype, x.device)
        xStep = T(self.dxFacet) + T(self.dxGap)
        yStep = T(self.dyFacet) + T(self.dyGap)
        cx = torch.round(x / xStep) * xStep
        cy = torch.round(y / yStep) * yStep
        return cx, cy, x - cx, y - cy

    def local_z(self, x, y):
        cx, cy, fx, fy = self._facets(x, y)
        cz = self.facet_center_z(cx, cy)
        cn = self.facet_center_n(cx, cy)
        return cz + (self.facet_delta_z(fx, fy) - cn[-3] * fx -
                     cn[-2] * fy) / cn[-1]

    def local_n(self, x, y):
        cx, cy, fx, fy = self._facets(x, y)
        cn = list(self.facet_center_n(cx, cy))
        dn = self.facet_delta_n(fx, fy)
        if dn is not None:
            n1 = cn[-1] + dn[-1]
            n2 = cn[-2] + dn[-2]
            n3 = cn[-3]
            norm = sqrt_rn(n1 ** 2 + n2 ** 2 + n3 ** 2)
            cn[-1], cn[-2], cn[-3] = n1 / norm, n2 / norm, n3 / norm
        if self.alpha is not None and len(cn) == 3:
            bA, cA = rotate_x(cn[1], cn[2], cos(self.alpha),
                              -sin(self.alpha))
            return [cn[0], bA, cA, cn[-3], cn[-2], cn[-1]]
        return cn

    def rays_good(self, x, y, state, lostNum=config.STATE_DEAD,
                  limits=None):
        locState = OE.rays_good(self, x, y, state, lostNum, limits)
        _, _, fx, fy = self._facets(x, y)
        inGaps = (torch.abs(fx) > self.dxFacet / 2) | \
                 (torch.abs(fy) > self.dyFacet / 2)
        return torch.where((locState == 1) & inGaps, lostNum,
                           locState).to(state.dtype)


def _diced_create(base, cls, dxFacet, dyFacet, dxGap, dyGap, kwargs):
    el = super(base, cls).create(**kwargs)
    el._init_facets(dxFacet, dyFacet, dxGap, dyGap)
    return el


class DicedOE(_DicedMethods, OE):
    """A flat diced mirror of facets dxFacet x dyFacet separated by gaps."""

    @classmethod
    def create(cls, dxFacet=2.1, dyFacet=1.4, dxGap=0.05, dyGap=0.05,
               **kwargs):
        return _diced_create(DicedOE, cls, dxFacet, dyFacet, dxGap, dyGap,
                             kwargs)


class DicedJohannToroid(_DicedMethods, JohannToroid):
    """A diced Johann toroid."""

    kernel_kind = 'diced_johann'

    @classmethod
    def create(cls, dxFacet=2.1, dyFacet=1.4, dxGap=0.05, dyGap=0.05,
               **kwargs):
        return _diced_create(DicedJohannToroid, cls, dxFacet, dyFacet,
                             dxGap, dyGap, kwargs)

    def facet_center_z(self, x, y):
        return JohannToroid.local_z(self, x, y)

    def facet_center_n(self, x, y):
        return JohannToroid.local_n(self, x, y)


class DicedJohanssonToroid(DicedJohannToroid):
    """A diced Johansson toroid."""

    kernel_kind = 'diced_johansson'

    def facet_center_n(self, x, y):
        return JohanssonToroid.local_n(self, x, y)

    def facet_delta_z(self, u, v):
        return v ** 2 / 2.0 / self.Rm

    def facet_delta_n(self, u, v):
        b = -v / self.Rm
        norm = sqrt_rn(b ** 2 + 1)
        return [torch.zeros_like(u), b / norm, 1.0 / norm]
