"""Refractive optics: plates and compound refractive lenses (CRL).

Port of the reference package's ``oes/refractive.py``.  A ``Plate`` is a
DCM-like body of two refracting surfaces, traced from vacuum at the first
and into vacuum at the second (refraction, and absorption along the path
inside); a lens stack (*nCRL* lenses, or ``nCRL=(f, E)`` for the count
that focuses at f mm at E eV) repeats the lens along the optical axis.
The reference scans the stack; here it is a Python loop over the lenses,
each a ``double_refract``, whose generator is the given one's seed plus
the lens index (lenses draw nothing at random today).

Unlike the reference, whose class attribute is shadowed by the element's
default 'mirror', a plate's 'auto' material refracts as a 'plate' and a
lens's as a 'lens'.
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..transforms import rotate_xyz
from .dcm import DCM


def _lens_generator(generator, i):
    """The generator of the i-th lens of a stack: the given one's seed plus
    *i* (None stays None)."""
    if generator is None or i == 0:
        return generator
    return torch.Generator(generator.device).manual_seed(
        (generator.initial_seed() + i) % 2 ** 63)


class Plate(DCM):
    """A body with two refracting surfaces: thickness *t* (mm) and a
    *wedgeAngle* of the back surface."""

    def __init__(self, t=0.0, wedgeAngle=0.0, **kwargs):
        super().__init__(**kwargs)
        self.t = config.number(t)
        self.wedgeAngle = config.number(wedgeAngle)

    @classmethod
    def create(cls, t=0.0, wedgeAngle=0.0, **kwargs):
        kwargs.setdefault('overEdge', '')
        kwargs.setdefault('auto_material_kind', 'plate')
        obj = super(Plate, cls).create(t=t, wedgeAngle=wedgeAngle, **kwargs)
        # the back surface: translated by -t, pitched by the wedge
        obj.cryst2perpTransl = -config.number(t)
        obj.cryst2pitch = config.number(wedgeAngle)
        obj.braggAngle = 0.0
        return obj

    def double_refract(self, beam, generator=None, needLocal=True):
        """(beamGlobal, beamLocal1, beamLocal2): refraction into the body at
        the first surface and out of it at the second."""
        return self.double_reflect(beam, generator=generator,
                                   needLocal=needLocal, fromVacuum1=True,
                                   fromVacuum2=False)

    def multiple_refract(self, beam, generator=None, needLocal=True):
        """Refraction through the whole stack of *nCRL* lenses, each
        displaced along the optical axis by the lens's length; returns
        (beamGlobal, beamLocal1, beamLocal2) with the first lens's local
        beams."""
        nCRL = int(getattr(self, 'nCRL', 1))
        out, lo1, lo2 = self.double_refract(beam, generator, needLocal=True)
        if nCRL == 1:
            return out, lo1, lo2
        zmax = getattr(self, 'zmax', None)
        zstep = 5.0 if zmax is None else zmax
        t = config.host_float(self.t)
        step = (2.0 * zstep + t) if isinstance(
            self, (DoubleParaboloidLens, DoubleParabolicCylinderLens)) \
            else zstep + t
        toward = [config.host_float(v) for v in rotate_xyz(
            0.0, 0.0, 1.0, self.rotationSequence,
            config.host_float(self.pitch),
            config.host_float(self.roll) +
            config.host_float(self.positionRoll),
            config.host_float(self.yaw))]
        for i in range(1, nCRL):
            center = tuple(c - v * (step * i)
                           for c, v in zip(self.center, toward))
            out = self.replace(center=center).double_refract(
                out, _lens_generator(generator, i), needLocal=True)[0]
        return out, lo1, lo2


class ParaboloidFlatLens(Plate):
    """A paraboloid-flat refractive lens, or a stack of *nCRL* of them:
    the entrance z = (x^2 + y^2) / (4 focus), capped at *zmax*, and a flat
    exit.  ``nCRL=(f, E)`` takes the count that focuses at f mm at E eV,
    round(2 focus / (f delta)) (half of it for a double lens)."""

    def __init__(self, focus=1.0, zmax=None, nCRL=1, **kwargs):
        super().__init__(**kwargs)
        self.focus = config.number(focus)
        self.zmax = zmax
        self.nCRL = nCRL

    @classmethod
    def create(cls, focus=1.0, zmax=None, nCRL=1, pitch=math.pi / 2,
               material=None, **kwargs):
        if isinstance(nCRL, (tuple, list)):
            f, E = nCRL
            nFactor = 0.5 if cls.__name__.startswith('Double') else 1.0
            delta = 1.0 - float(material.get_refractive_index(E).real)
            nCRL = max(int(round(2 * focus / f / delta * nFactor)), 1)
        kwargs.setdefault('auto_material_kind', 'lens')
        return super(ParaboloidFlatLens, cls).create(
            focus=focus, zmax=None if zmax is None else float(zmax),
            nCRL=int(nCRL), pitch=pitch, material=material, **kwargs)

    def local_z1(self, x, y):
        z = (x ** 2 + y ** 2) / (4 * self.focus)
        if self.zmax is not None:
            z = torch.clamp(z, max=self.zmax)
        return z

    def local_n1(self, x, y):
        a = -x / (2 * self.focus)
        b = -y / (2 * self.focus)
        if self.zmax is not None:
            flat = (x ** 2 + y ** 2) / (4 * self.focus) > self.zmax
            a = torch.where(flat, torch.zeros_like(a), a)
            b = torch.where(flat, torch.zeros_like(b), b)
        norm = sqrt_rn(a ** 2 + b ** 2 + 1)
        return [a / norm, b / norm, 1.0 / norm]

    def local_z2(self, x, y):
        return torch.zeros_like(x)

    def local_n2(self, x, y):
        return [torch.zeros_like(x), torch.zeros_like(y), torch.ones_like(x)]

    # the single-surface view
    def local_z(self, x, y):
        return self.local_z1(x, y)

    def local_n(self, x, y):
        return self.local_n1(x, y)


class ParabolicCylinderFlatLens(ParaboloidFlatLens):
    """A cylindrical (1D) parabolic-flat lens: the paraboloid depends on x
    only (roll the lens by 90 deg to focus vertically)."""

    def local_z1(self, x, y):
        z = x ** 2 / (4 * self.focus)
        if self.zmax is not None:
            z = torch.clamp(z, max=self.zmax)
        return z

    def local_n1(self, x, y):
        a = -x / (2 * self.focus)
        if self.zmax is not None:
            a = torch.where(x ** 2 / (4 * self.focus) > self.zmax,
                            torch.zeros_like(a), a)
        norm = sqrt_rn(a ** 2 + 1)
        return [a / norm, torch.zeros_like(y), 1.0 / norm]


class DoubleParaboloidLens(ParaboloidFlatLens):
    """A lens with two paraboloid surfaces."""

    def local_z2(self, x, y):
        return self.local_z1(x, y)

    def local_n2(self, x, y):
        return self.local_n1(x, y)


class DoubleParabolicCylinderLens(ParabolicCylinderFlatLens):
    """A cylindrical lens with two parabolic surfaces."""

    def local_z2(self, x, y):
        return self.local_z1(x, y)

    def local_n2(self, x, y):
        return self.local_n1(x, y)
