"""Apertures: slits, round, double, polygonal and grid openings, the
Siemens star, their beam-stop forms and a set of slits on an actuator.

Port of the reference package's ``apertures.py``: each opening's frame,
``inside`` test and ray ``propagate``, which advances rays to the aperture plane, applies the
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
        """Transmission in [0, 1]: the opening's indicator, smoothed over
        *softEdge* where the opening has one."""
        return self.inside(x, z).to(x.dtype)

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

    def propagate_wave(self, wave=None, nrays='auto', generator=None,
                       fixedEnergy=None, prevOE=None, **kw):
        """One-call Kirchhoff hop onto samples inside this opening (see
        :func:`xrt_tpu_torch.waves.propagate_wave_to_aperture`).  Returns
        the filled Wave."""
        from .waves import propagate_wave_to_aperture
        return propagate_wave_to_aperture(self, wave, nrays=nrays,
                                          generator=generator,
                                          fixedEnergy=fixedEnergy,
                                          prevOE=prevOE, **kw)

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

    def _distance(self, source):
        return float(np.linalg.norm(
            np.asarray([config.host_float(c) for c in self.center]) -
            np.asarray([config.host_float(c) for c in source.center])))

    def get_divergence(self, source):
        """The blades' angular openings seen from *source*."""
        d = self._distance(source)
        return [config.host_float(v) / d for v in self.opening]

    def set_divergence(self, source, divergence):
        """A copy with the blades set from the angular openings (left,
        right, bottom, top) seen from *source*."""
        d = self._distance(source)
        eps = 1e-9
        vals = [dv * d + (eps if dv > 0 else -eps) for dv in divergence]
        return self.replace(left=vals[0], right=vals[1], bottom=vals[2],
                            top=vals[3])

    def touch_beam(self, beam: Beam):
        """A copy with the blades moved to just touch the footprint of the
        good and out rays of *beam* on the aperture plane (host side)."""
        good = ((beam.state == 1) | (beam.state == 2)).cpu().numpy()
        lx, ly, lz, la, lb, lc = (v.detach().cpu().double().numpy()
                                  for v in to_local_frame(
                                      beam, self.center, self.ex, self.ey,
                                      self.ez))
        t = -ly / np.where(lb == 0, 1.0, lb)
        x_at = (lx + la * t)[good]
        z_at = (lz + lc * t)[good]
        if x_at.size == 0:
            return self
        return self.replace(left=float(x_at.min()), right=float(x_at.max()),
                            bottom=float(z_at.min()), top=float(z_at.max()))

    def inside(self, x, z):
        return (x >= self.left) & (x <= self.right) & \
            (z >= self.bottom) & (z <= self.top)

    def transmission(self, x, z):
        if self.softEdge is None:
            return self.inside(x, z).to(x.dtype)
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
        if self.softEdge is None:
            return self.inside(x, z).to(x.dtype)
        return torch.sigmoid((self.r - sqrt_rn(x ** 2 + z ** 2)) /
                             self.softEdge)


def RectangularBeamStop(name='', center=(0, 0, 0),
                        kind=('left', 'right', 'bottom', 'top'),
                        opening=(-10, 10, -2, 2), x='auto', z='auto'):
    """A rectangular aperture that blocks inside."""
    return RectangularAperture.create(name, center, kind, opening, x, z,
                                      isBeamStop=True)


def RoundBeamStop(name='', center=(0, 0, 0), r=1.0, x='auto', z='auto'):
    """A round aperture that blocks inside."""
    return RoundAperture.create(name, center, r, x, z, isBeamStop=True)


class DoubleSlit(_ApertureBase):
    """Two parallel vertical slits: a rectangular opening with an opaque
    strip from *shadeFraction*[0] to [1] of its width."""

    def __init__(self, center, ex, ez, left, right, bottom, top, shadeLeft,
                 shadeRight, **kw):
        super().__init__(center, ex, ez, **kw)
        self.left, self.right = float(left), float(right)
        self.bottom, self.top = float(bottom), float(top)
        self.shadeLeft, self.shadeRight = float(shadeLeft), float(shadeRight)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), opening=(-1, 1, -1, 1),
               shadeFraction=(0.3, 0.7), x='auto', z='auto',
               isBeamStop=False):
        ex, ez = _frame(x, z)
        le, ri, bo, to = opening
        width = ri - le
        return cls(center, ex, ez, le, ri, bo, to,
                   le + shadeFraction[0] * width,
                   le + shadeFraction[1] * width, name=name,
                   isBeamStop=isBeamStop)

    def inside(self, x, z):
        inRect = (x >= self.left) & (x <= self.right) & \
            (z >= self.bottom) & (z <= self.top)
        inShade = (x > self.shadeLeft) & (x < self.shadeRight)
        return inRect & ~inShade


def DoubleBeamStop(name='', center=(0, 0, 0), opening=(-1, 1, -1, 1),
                   shadeFraction=(0.3, 0.7), x='auto', z='auto'):
    """A double slit whose two strips block."""
    return DoubleSlit.create(name, center, opening, shadeFraction, x, z,
                             isBeamStop=True)


class PolygonalAperture(_ApertureBase):
    """An opening bounded by a closed polygon of *vertices* (N, 2) in the
    local (x, z) plane; inside by the even-odd (crossing-number) rule over
    rays x edges."""

    def __init__(self, center, ex, ez, vertices, **kw):
        super().__init__(center, ex, ez, **kw)
        self.vertices = np.asarray(vertices, float)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), opening=None, x='auto',
               z='auto', isBeamStop=False):
        ex, ez = _frame(x, z)
        return cls(center, ex, ez, opening, name=name, isBeamStop=isBeamStop)

    def inside(self, x, z):
        v = torch.as_tensor(self.vertices, dtype=x.dtype, device=x.device)
        x1, z1 = v[:, 0], v[:, 1]
        x2, z2 = torch.roll(x1, -1), torch.roll(z1, -1)
        xp, zp = x[:, None], z[:, None]
        cond = (z1[None, :] > zp) != (z2[None, :] > zp)
        dz_ = torch.where(z2 - z1 == 0, torch.ones_like(z1), z2 - z1)[None, :]
        xCross = x1[None, :] + (zp - z1[None, :]) * (x2 - x1)[None, :] / dz_
        crossings = torch.sum(cond & (xp < xCross), dim=1)
        return (crossings % 2) == 1


def PolygonalBeamStop(name='', center=(0, 0, 0), opening=None, x='auto',
                      z='auto'):
    """A polygonal aperture that blocks inside."""
    return PolygonalAperture.create(name, center, opening, x, z,
                                    isBeamStop=True)


class GridAperture(_ApertureBase):
    """A Cartesian grid of rectangular holes: half-sizes (dx, dz), pitches
    (px, pz), *nx*, *nz* holes on each side of the centre."""

    def __init__(self, center, ex, ez, dx, dz, px, pz, nx, nz, **kw):
        super().__init__(center, ex, ez, **kw)
        self.dx, self.dz = float(dx), float(dz)
        self.px, self.pz = float(px), float(pz)
        self.nx, self.nz = int(nx), int(nz)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), dx=0.1, dz=0.1, px=1.0,
               pz=1.0, nx=7, nz=7, x='auto', z='auto', isBeamStop=False):
        ex, ez = _frame(x, z)
        return cls(center, ex, ez, dx, dz, px, pz, nx, nz, name=name,
                   isBeamStop=isBeamStop)

    def inside(self, x, z):
        px = config.scalar(self.px, x.dtype, x.device)
        pz = config.scalar(self.pz, z.dtype, z.device)
        hx = torch.abs(x - torch.round(x / px) * px) <= self.dx
        hz = torch.abs(z - torch.round(z / pz) * pz) <= self.dz
        inGridX = torch.abs(x) <= (self.nx + 0.5) * self.px
        inGridZ = torch.abs(z) <= (self.nz + 0.5) * self.pz
        return hx & hz & inGridX & inGridZ


def GridBeamStop(name='', center=(0, 0, 0), dx=0.1, dz=0.1, px=1.0,
                 pz=1.0, nx=7, nz=7, x='auto', z='auto'):
    """A grid of rectangles that block."""
    return GridAperture.create(name, center, dx, dz, px, pz, nx, nz, x, z,
                               isBeamStop=True)


class SiemensStar(_ApertureBase):
    """A Siemens star: *nSpokes* wedge-shaped openings within radius *r*
    (the alternate wedges and everything beyond *r* are opaque), turned by
    *phi0*, twisted by *vortex*."""

    def __init__(self, center, ex, ez, r, nSpokes, vortex, phi0, **kw):
        super().__init__(center, ex, ez, **kw)
        self.r, self.phi0 = float(r), float(phi0)
        self.nSpokes, self.vortex = int(nSpokes), int(vortex)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), nSpokes=9, r=1.0, phi0=0.0,
               vortex=0, x='auto', z='auto', isBeamStop=False):
        ex, ez = _frame(x, z)
        return cls(center, ex, ez, r, nSpokes, vortex, phi0, name=name,
                   isBeamStop=isBeamStop)

    def inside(self, x, z):
        rho = sqrt_rn(x ** 2 + z ** 2)
        phi = torch.atan2(z, x) - self.phi0
        if self.vortex:
            phi = phi + self.vortex * torch.log(torch.clamp(rho, min=1e-12))
        spoke = torch.sin(self.nSpokes * phi) > 0
        return (rho <= self.r) & ~spoke


class SetOfRectangularAperturesOnZActuator:
    """Coplanar named openings on a vertical actuator (host side):
    ``select_aperture`` moves the actuator and returns the
    :class:`RectangularAperture` of that opening (a half-plane for a last
    'top-edge' or 'bottom-edge' entry)."""

    def __init__(self, center, apertures, centerZs, dXs, dZs,
                 x='auto', z='auto'):
        self.center = tuple(float(v) for v in center)
        self.apertures = list(apertures)
        self.centerZs = list(centerZs)
        self.dXs = list(dXs)
        self.dZs = list(dZs)
        self.x = x
        self.z = z
        self.curAperture = 0
        self.zActuator = self.center[2]

    def select_aperture(self, apertureName, targetZ=None):
        """*apertureName*, its window centred at *targetZ* (by default
        its nominal z)."""
        ca = self.apertures.index(apertureName)
        self.curAperture = ca
        cz = self.centerZs[ca]
        if targetZ is None:
            targetZ = self.center[2] + cz
        self.zActuator = targetZ - cz
        dzAct = self.zActuator - self.center[2]
        inf = math.inf
        if ca < len(self.apertures) - 1:
            dx = self.dXs[ca] * 0.5
            dz = self.dZs[ca] * 0.5
            opening = (-dx, dx, cz + dzAct - dz, cz + dzAct + dz)
        elif self.apertures[-1].startswith('top'):
            opening = (-inf, inf, -inf, cz + dzAct)
        else:
            opening = (-inf, inf, cz + dzAct, inf)
        return RectangularAperture.create(
            name=apertureName, center=self.center, opening=opening,
            x=self.x, z=self.z)
