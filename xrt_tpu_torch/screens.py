"""Screens — flat observation surfaces.

Port of the reference package's ``screens.py`` (``Screen``): a flat
screen at *center* whose local frame is given by the unit vectors *x* and
*z*; the normal is y = z cross x.  Geometry is kept as Python floats in
float64; wave samples on the screen come from
:func:`xrt_tpu_torch.waves.prepare_wave_on_screen`.
"""
from __future__ import annotations

import numpy as np


def _unit(v):
    v = np.asarray(v, np.float64)
    return tuple(float(c) for c in v / np.linalg.norm(v))


class Screen:
    """A flat screen at *center* with local axes *x* and *z* (global
    frame)."""

    def __init__(self, center, ex, ez, name='', compressX=None,
                 compressZ=None):
        self.center = tuple(float(c) for c in center)
        self.ex = ex
        self.ez = ez
        self.name = name
        self.compressX = compressX
        self.compressZ = compressZ

    @classmethod
    def create(cls, name='', center=(0, 0, 0), x=(1, 0, 0), z=(0, 0, 1),
               compressX=None, compressZ=None):
        return cls(center, _unit(x), _unit(z), name=name,
                   compressX=compressX, compressZ=compressZ)

    @property
    def ey(self):
        return tuple(float(c) for c in np.cross(self.ez, self.ex))
