"""Screens — flat and hemispheric observation surfaces.

Port of the reference package's ``screens.py`` (``Screen`` with
``expose`` and ``expose_global``, ``HemisphericScreen``): a screen at
*center* whose local frame is given by the unit vectors *x* and *z*; the
normal is y = z cross x.  ``expose`` intersects rays with the screen and
returns the image beam in the screen-local frame; amplitudes acquire the
propagation phase exp(1e7j * k * path) (path mm -> A).  The frame is kept
as Python floats in float64; the centre components are Python floats, or
the tensors that were passed in.  Wave samples on the screen come from
:func:`xrt_tpu_torch.waves.prepare_wave_on_screen`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import config
from .beam import Beam, propagated_amplitudes
from .ops.dd import sqrt_rn
from .transforms import to_local_frame


def _unit(v):
    v = np.asarray(v, np.float64)
    return tuple(float(c) for c in v / np.linalg.norm(v))


class Screen(config.Replaceable):
    """A flat screen at *center* with local axes *x* and *z* (global
    frame)."""

    def __init__(self, center, ex, ez, name='', compressX=None,
                 compressZ=None):
        self.center = tuple(config.number(c) for c in center)
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

    def local_to_global(self, x, y, z):
        """Screen-local point -> global coordinates."""
        ex, ey, ez = self.ex, self.ey, self.ez
        c = self.center
        return (c[0] + x * ex[0] + y * ey[0] + z * ez[0],
                c[1] + x * ex[1] + y * ey[1] + z * ez[1],
                c[2] + x * ex[2] + y * ey[2] + z * ez[2])

    def expose(self, beam: Beam, onlyPositivePath=False) -> Beam:
        """Intersect *beam* (global frame) with the screen plane; returns
        the local-frame image beam.  Rays parallel to the plane (or with
        negative path when *onlyPositivePath*) are marked lost."""
        lx, ly, lz, la, lb, lc = to_local_frame(
            beam, self.center, self.ex, self.ey, self.ez)
        path = -ly / torch.where(lb == 0, torch.ones_like(lb), lb)
        condBad = (lb == 0) | ~torch.isfinite(path)
        if onlyPositivePath:
            condBad = condBad | (path < 0)
        path = torch.where(condBad, torch.zeros_like(path), path)
        state = torch.where(condBad, config.STATE_DEAD, beam.state)
        x = lx + la * path
        z = lz + lc * path
        if self.compressX:
            x = x * self.compressX
        if self.compressZ:
            z = z * self.compressZ
        return beam.replace(x=x, y=torch.zeros_like(ly), z=z, a=la, b=lb,
                            c=lc, path=beam.path + path, state=state,
                            **propagated_amplitudes(beam, path))

    def expose_wave(self, wave=None, dim1=None, dim2=None, generator=None,
                    fixedEnergy=None, prevOE=None, **kw):
        """One-call Kirchhoff hop onto this screen's pixel grid (see
        :func:`xrt_tpu_torch.waves.expose_wave_on_screen`).  Returns the
        filled Wave."""
        from .waves import expose_wave_on_screen
        return expose_wave_on_screen(self, wave, dim1, dim2,
                                     generator=generator,
                                     fixedEnergy=fixedEnergy, prevOE=prevOE,
                                     **kw)

    def expose_global(self, beam: Beam, onlyPositivePath=False) -> Beam:
        """Like :meth:`expose` but returns the beam in the global frame."""
        ey, c = self.ey, self.center
        denom = beam.a * ey[0] + beam.b * ey[1] + beam.c * ey[2]
        safe = torch.where(denom == 0, torch.ones_like(denom), denom)
        path = ((c[0] - beam.x) * ey[0] + (c[1] - beam.y) * ey[1] +
                (c[2] - beam.z) * ey[2]) / safe
        condBad = (denom == 0) | ~torch.isfinite(path)
        if onlyPositivePath:
            condBad = condBad | (path < 0)
        path = torch.where(condBad, torch.zeros_like(path), path)
        state = torch.where(condBad, config.STATE_DEAD, beam.state)
        return beam.replace(x=beam.x + path * beam.a,
                            y=beam.y + path * beam.b,
                            z=beam.z + path * beam.c,
                            path=beam.path + path, state=state,
                            **propagated_amplitudes(beam, path))


class HemisphericScreen(Screen):
    """Hemispheric screen of radius R; the image is in spherical angular
    coordinates (x = phi * R, z = theta * R)."""

    def __init__(self, center, ex, ez, R=1000.0, name=''):
        super().__init__(center, ex, ez, name=name)
        self.R = config.number(R)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), x=(1, 0, 0), z=(0, 0, 1),
               R=1000.0):
        return cls(center, _unit(x), _unit(z), R=R, name=name)

    def expose(self, beam: Beam, onlyPositivePath=False) -> Beam:
        lx, ly, lz, la, lb, lc = to_local_frame(
            beam, self.center, self.ex, self.ey, self.ez)
        # |p + t v| = R with p = (lx, ly, lz), v = (la, lb, lc) unit
        pv = lx * la + ly * lb + lz * lc
        p2 = lx ** 2 + ly ** 2 + lz ** 2
        disc = pv ** 2 - p2 + self.R ** 2
        bad = disc < 0
        path = -pv + sqrt_rn(torch.clamp(disc, min=0.0))
        if onlyPositivePath:
            bad = bad | (path < 0)
        path = torch.where(bad, torch.zeros_like(path), path)
        state = torch.where(bad, config.STATE_DEAD, beam.state)
        x3 = lx + la * path
        y3 = ly + lb * path
        z3 = lz + lc * path
        theta = torch.arcsin(torch.clamp(z3 / self.R, -1.0, 1.0))
        phi = torch.atan2(x3, y3)
        return beam.replace(x=phi * self.R, z=theta * self.R,
                            y=torch.zeros_like(ly), a=la, b=lb, c=lc,
                            path=beam.path + path, state=state,
                            **propagated_amplitudes(beam, path))
