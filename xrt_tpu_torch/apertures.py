"""Apertures: rectangular and round openings.

Port of the reference package's ``apertures.py`` (``RectangularAperture``,
``RoundAperture``): their frame, opening, ``inside`` test and ray
``propagate``, which advances rays to the aperture plane, applies the
propagation phase to amplitudes and marks blocked rays dead through the
``state`` mask (or, with *softEdge*, attenuates them by a sigmoid of that
width and keeps them alive).  Wave samples in the opening come from
:func:`xrt_tpu_torch.waves.prepare_wave_on_aperture`.  The frame is kept
as Python floats; the centre, the blade positions, the radius and the
soft-edge width are Python floats, or the tensors that were passed in: the
soft-edged ``propagate`` is differentiable with respect to them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import config
from .beam import Beam, propagated_amplitudes
from .ops.dd import sqrt_rn
from .transforms import to_local_frame


def _frame(x, z):
    ex = np.asarray(x if x not in (None, 'auto') else (1, 0, 0), np.float64)
    ez = np.asarray(z if z not in (None, 'auto') else (0, 0, 1), np.float64)
    return (tuple(float(c) for c in ex / np.linalg.norm(ex)),
            tuple(float(c) for c in ez / np.linalg.norm(ez)))


class _ApertureBase(config.Replaceable):
    def __init__(self, center, ex, ez, name='', isBeamStop=False,
                 softEdge=None):
        self.center = tuple(config.number(c) for c in center)
        self.ex, self.ez = ex, ez
        self.name = name
        self.isBeamStop = isBeamStop
        # smooth-edge width (mm)
        self.softEdge = None if softEdge is None else \
            config.number(softEdge)

    @property
    def ey(self):
        return tuple(float(c) for c in np.cross(self.ez, self.ex))

    def inside(self, x, z):
        raise NotImplementedError

    def transmission(self, x, z):
        """Smooth transmission in [0, 1] of the *softEdge* blades."""
        raise NotImplementedError

    def propagate(self, beam: Beam, needNewGlobal=False):
        """Advance rays to the aperture plane and kill the blocked ones.
        Returns the local beam, or (global, local) when *needNewGlobal*."""
        good = beam.state > 0
        lx, ly, lz, la, lb, lc = to_local_frame(
            beam, self.center, self.ex, self.ey, self.ez)
        zero = torch.zeros_like(ly)
        path = torch.where(
            good, -ly / torch.where(lb == 0, torch.ones_like(lb), lb), zero)
        lx = lx + la * path
        lz = lz + lc * path
        updates = dict(x=lx, y=torch.where(good, zero, ly), z=lz, a=la,
                       b=lb, c=lc, path=beam.path + path)
        amps = propagated_amplitudes(beam, path)
        if self.softEdge is not None:
            T = self.transmission(lx, lz)
            if self.isBeamStop:
                T = 1.0 - T
            for f in ('Jss', 'Jpp', 'Jsp'):
                v = getattr(beam, f)
                updates[f] = torch.where(good, v * T, v)
            amp = sqrt_rn(torch.clamp(T, min=0.0))
            amps = {f: v * amp for f, v in amps.items()}
        else:
            keep = self.inside(lx, lz)
            if self.isBeamStop:
                keep = ~keep
            updates['state'] = torch.where(good & ~keep, config.STATE_DEAD,
                                           beam.state)
        for f, v in amps.items():
            updates[f] = torch.where(good, v, getattr(beam, f))
        lo = beam.replace(**updates)
        if needNewGlobal:
            return self._to_global(lo), lo
        return lo

    def _to_global(self, lo: Beam) -> Beam:
        ex, ey, ez, c = self.ex, self.ey, self.ez, self.center
        return lo.replace(
            x=c[0] + lo.x * ex[0] + lo.y * ey[0] + lo.z * ez[0],
            y=c[1] + lo.x * ex[1] + lo.y * ey[1] + lo.z * ez[1],
            z=c[2] + lo.x * ex[2] + lo.y * ey[2] + lo.z * ez[2],
            a=lo.a * ex[0] + lo.b * ey[0] + lo.c * ez[0],
            b=lo.a * ex[1] + lo.b * ey[1] + lo.c * ez[1],
            c=lo.a * ex[2] + lo.b * ey[2] + lo.c * ez[2])


class RectangularAperture(_ApertureBase):
    """Opening given by blade positions (left, right, bottom, top) in the
    local (x, z) plane; absent blades are at +-inf."""

    def __init__(self, center, ex, ez, left, right, bottom, top, **kw):
        super().__init__(center, ex, ez, **kw)
        self.left, self.right = config.number(left), config.number(right)
        self.bottom, self.top = config.number(bottom), config.number(top)

    @classmethod
    def create(cls, name='', center=(0, 0, 0),
               kind=('left', 'right', 'bottom', 'top'),
               opening=(-10, 10, -2, 2), x='auto', z='auto',
               isBeamStop=False, softEdge=None):
        blades = dict(zip(kind, opening))
        ex, ez = _frame(x, z)
        inf = math.inf
        return cls(center, ex, ez, blades.get('left', -inf),
                   blades.get('right', inf), blades.get('bottom', -inf),
                   blades.get('top', inf), name=name,
                   isBeamStop=isBeamStop, softEdge=softEdge)

    @property
    def opening(self):
        return [self.left, self.right, self.bottom, self.top]

    def inside(self, x, z):
        return (x >= self.left) & (x <= self.right) & \
            (z >= self.bottom) & (z <= self.top)

    def transmission(self, x, z):
        big = 1e30      # an absent blade is far away, not at infinity

        def edge(signed):   # signed distance into the opening
            return torch.sigmoid(torch.clamp(signed, -big, big) /
                                 self.softEdge)

        def blade(v):       # a tensor blade is finite and stays a tensor
            return v if isinstance(v, torch.Tensor) else \
                min(max(v, -big), big)
        return edge(x - blade(self.left)) * edge(blade(self.right) - x) * \
            edge(z - blade(self.bottom)) * edge(blade(self.top) - z)


class RoundAperture(_ApertureBase):
    """Round opening of radius r."""

    def __init__(self, center, ex, ez, r, **kw):
        super().__init__(center, ex, ez, **kw)
        self.r = config.number(r)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), r=1.0, x='auto', z='auto',
               isBeamStop=False, softEdge=None):
        ex, ez = _frame(x, z)
        return cls(center, ex, ez, r, name=name, isBeamStop=isBeamStop,
                   softEdge=softEdge)

    def inside(self, x, z):
        return x ** 2 + z ** 2 <= self.r ** 2

    def transmission(self, x, z):
        return torch.sigmoid((self.r - sqrt_rn(x ** 2 + z ** 2)) /
                             self.softEdge)
