"""Apertures: rectangular and round openings.

Port of the reference package's ``apertures.py`` (``RectangularAperture``,
``RoundAperture``) as the wave chain uses them: their frame, opening and
``inside`` test; wave samples in the opening come from
:func:`xrt_tpu_torch.waves.prepare_wave_on_aperture`.  Geometry is kept
as Python floats.  Ray ``propagate`` (with smooth edges) belongs to the
ray-trace slice (ROADMAP A7).
"""
from __future__ import annotations

import math

import numpy as np


def _frame(x, z):
    ex = np.asarray(x if x not in (None, 'auto') else (1, 0, 0), np.float64)
    ez = np.asarray(z if z not in (None, 'auto') else (0, 0, 1), np.float64)
    return (tuple(float(c) for c in ex / np.linalg.norm(ex)),
            tuple(float(c) for c in ez / np.linalg.norm(ez)))


class _ApertureBase:
    def __init__(self, center, ex, ez, name='', isBeamStop=False,
                 softEdge=None):
        self.center = tuple(float(c) for c in center)
        self.ex, self.ez = ex, ez
        self.name = name
        self.isBeamStop = isBeamStop
        # smooth-edge width (mm), used by the ray-trace propagate
        self.softEdge = None if softEdge is None else float(softEdge)

    @property
    def ey(self):
        return tuple(float(c) for c in np.cross(self.ez, self.ex))

    def inside(self, x, z):
        raise NotImplementedError


class RectangularAperture(_ApertureBase):
    """Opening given by blade positions (left, right, bottom, top) in the
    local (x, z) plane; absent blades are at +-inf."""

    def __init__(self, center, ex, ez, left, right, bottom, top, **kw):
        super().__init__(center, ex, ez, **kw)
        self.left, self.right = float(left), float(right)
        self.bottom, self.top = float(bottom), float(top)

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


class RoundAperture(_ApertureBase):
    """Round opening of radius r."""

    def __init__(self, center, ex, ez, r, **kw):
        super().__init__(center, ex, ez, **kw)
        self.r = float(r)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), r=1.0, x='auto', z='auto',
               isBeamStop=False, softEdge=None):
        ex, ez = _frame(x, z)
        return cls(center, ex, ez, r, name=name, isBeamStop=isBeamStop,
                   softEdge=softEdge)

    def inside(self, x, z):
        return x ** 2 + z ** 2 <= self.r ** 2
