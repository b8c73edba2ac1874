"""Optical element base: placement, ray-surface intersection, frames,
classification and the reflection physics at the surface.

Port of the reference package's ``oes/base.py`` for the mirror kinds:
``OE.create``, the local/global frames, ``local_z``/``local_n``,
``rays_good``, the bracketed intersection search
(``find_intersection``, ``find_intersection_dz``, ``OE._bracket``),
``reflect`` (with the search, or with ``noIntersectionSearch=True`` for
the wave hops, which reflect at the exact receiving samples) and
``_interact``.  Rays are never filtered: the ``state`` mask selects which
rays change.

The search is a vectorized Illinois (modified regula falsi) iteration on
all rays in lockstep with a convergence mask, then two Newton steps.  The
iteration runs under ``torch.no_grad()`` and reads ``any(active)`` to the
host once per iteration: at the ray counts of a trace one iteration is
tens of kernel launches over the whole ray state, so the read costs less
than one more iteration would.  The Newton steps are differentiable torch
operations: they polish the root (float32 at t ~ 1e4 mm has ~6e-4 mm
ulps, so the bracket alone cannot give float32 accuracy) and carry the
implicit-function gradient dt/dparams = -dF/dparams / dF/dt.

The crystal, grating and refractive physics, parametric surfaces,
element offsets and the second crystal of a DCM come with later slices
(ROADMAP A5, A8) and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import config
from ..beam import Beam, rotate_coherency_matrix
from ..physconsts import CHBAR
from ..transforms import (global_to_virgin_local, rotate_beam, rotate_y,
                          virgin_local_to_global)


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


# ---------------------------------------------------------------------------
# intersection solver
# ---------------------------------------------------------------------------

def _z_eps(dtype):
    """Convergence tolerance of the intersection search, mm: 1e-12 in
    float64; in float32 that is unreachable, so it scales with the dtype
    epsilon."""
    return 1e-12 if dtype == torch.float64 else 3e-6


def _rel_eps(dtype):
    """Relative bracket-width tolerance, a small multiple of the dtype
    epsilon: the bracket cannot shrink below the ulp of t anyway."""
    return 32.0 * torch.finfo(dtype).eps


def find_intersection(surface_fn, tMin, tMax, x, y, z, a, b, c,
                      invertNormal=1, active=None, max_iterations=None):
    """Bracketed root-find against an explicit surface z(x, y); see
    :func:`find_intersection_dz` for the general form."""
    def dz_fn(xx, yy, zz):
        surf = surface_fn(xx, yy)
        surf = torch.where(torch.isnan(surf), torch.zeros_like(surf), surf)
        return (zz - surf) * invertNormal
    return find_intersection_dz(dz_fn, tMin, tMax, x, y, z, a, b, c,
                                active, max_iterations)


def find_intersection_dz(dz_fn, tMin, tMax, x, y, z, a, b, c,
                         active=None, max_iterations=None):
    """Vectorized bracketed root-finding of dz(t) along each ray.
    *dz_fn(x, y, z) -> signed distance* must be positive at tMin and
    negative at tMax for rays that intersect, and be made of operations
    ``torch.func.jvp`` can trace.  Returns (t, x2, y2, z2, lost_mask)
    where lost_mask marks rays already below the surface at tMin."""
    eps = _z_eps(x.dtype)
    rel = _rel_eps(x.dtype)
    if max_iterations is None:
        max_iterations = config.MAX_INTERSECTION_ITERATIONS
    if active is None:
        active = torch.ones_like(x, dtype=torch.bool)

    def F(t):
        return dz_fn(x + a * t, y + b * t, z + c * t)

    with torch.no_grad():
        fa, fb = F(tMin), F(tMax)
        lost = active & (fa <= 0)       # started below the surface
        over = active & (fb >= 0)       # never crosses within the bracket
        good = active & ~(lost | over)
        # Illinois iteration on the bracket [ta, tb] with f(ta) > 0 > f(tb)
        ta, tb = tMin, tMax
        ts = torch.where(good, 0.5 * (ta + tb), tMax)
        act = good
        for _ in range(max_iterations):
            if not bool(torch.any(act)):
                break
            denom = fb - fa
            denom = torch.where(denom == 0, torch.ones_like(denom), denom)
            tn = ta - fa * (tb - ta) / denom
            # fall back to bisection when the step leaves the bracket
            bad = (tn <= torch.minimum(ta, tb)) | \
                (tn >= torch.maximum(ta, tb)) | torch.isnan(tn)
            tn = torch.where(bad, 0.5 * (ta + tb), tn)
            fs = F(tn)
            keep_a = fs <= 0          # root in [ta, tn]
            # halving the stale endpoint's value keeps the convergence
            # superlinear
            upd_a = act & ~keep_a
            upd_b = act & keep_a
            fa = torch.where(upd_a, fs, torch.where(upd_b, fa * 0.5, fa))
            fb = torch.where(upd_b, fs, torch.where(upd_a, fb * 0.5, fb))
            ta = torch.where(upd_a, tn, ta)
            tb = torch.where(upd_b, tn, tb)
            ts = torch.where(act, tn, ts)
            # the absolute eps is unreachable in float32 at beamline
            # scales, so the bracket width is also tested relative to t;
            # the Newton steps below restore full precision
            tol = eps + rel * (torch.abs(ta) + torch.abs(tb))
            act = act & (torch.abs(fs) > eps) & (torch.abs(tb - ta) > tol)
        t0 = torch.where(good, ts, torch.where(lost, tMin, tMax))

    t = t0
    for _ in range(2):       # quadratic: two steps reach machine precision
        Ft, dFt = torch.func.jvp(F, (t,), (torch.ones_like(t),))
        dFt = torch.where(torch.abs(dFt) < 1e-12,
                          torch.full_like(dFt, 1e-12), dFt)
        t = t - Ft / dFt
    # keep the Newton result only where it stays within the bracket
    ok = good & (t >= tMin) & (t <= tMax) & torch.isfinite(t)
    t = torch.where(ok, t, t0)
    return t, x + a * t, y + b * t, z + c * t, lost


def _merge_by_mask(old: Beam, new: Beam, mask) -> Beam:
    """new where mask else old, over all present tensor fields."""
    updates = {}
    for f in dataclasses.fields(Beam):
        ov = getattr(old, f.name)
        nv = getattr(new, f.name)
        if nv is None:
            continue
        if ov is None or nv.ndim == 0 or nv.shape != mask.shape:
            updates[f.name] = nv
        else:
            updates[f.name] = torch.where(mask, nv, ov)
    return old.replace(**updates)


def _fvec(v):
    return None if v is None else tuple(float(c) for c in v)


class OE(config.Replaceable):
    """A general optical element.  Subclasses define the surface through
    ``local_z``/``local_n``.  Limits are Python floats.  The centre, the
    placement angles and a subclass's radii are Python floats, or the
    tensors that were passed in (to ``create``, the constructor or
    ``replace``): a gradient then flows to them through ``reflect``.  The
    host geometry of the wave samplers reads their detached values.
    Material tables are tensors on the material's device."""

    isParametric = False

    def __init__(self, name='', center=(0, 0, 0), pitch=0.0, roll=0.0,
                 yaw=0.0, positionRoll=0.0, bragg_=None, extraPitch=None,
                 extraRoll=None, extraYaw=None, limPhysX=None,
                 limPhysY=None, limOptX=None, limOptY=None, material=None,
                 shape='rect', rotationSequence='RzRyRx',
                 extraRotationSequence='RzRyRx', order=1, curSurface=0,
                 overEdge='ymax', auto_material_kind='mirror'):
        self.name = name
        self.center = tuple(config.number(c) for c in center)
        self.pitch, self.roll, self.yaw = pitch, roll, yaw
        self.positionRoll = positionRoll
        self.bragg_ = bragg_
        self.extraPitch, self.extraRoll, self.extraYaw = \
            extraPitch, extraRoll, extraYaw
        self.limPhysX, self.limPhysY = limPhysX, limPhysY
        self.limOptX, self.limOptY = limOptX, limOptY
        self.material = material
        self.shape = shape
        self.rotationSequence = rotationSequence
        self.extraRotationSequence = extraRotationSequence
        self.order = order
        self.curSurface = curSurface
        self.overEdge = overEdge
        self.auto_material_kind = auto_material_kind

    @classmethod
    def create(cls, name='', center=(0, 0, 0), pitch=0.0, roll=0.0, yaw=0.0,
               positionRoll=0.0, bragg=None, extraPitch=0.0, extraRoll=0.0,
               extraYaw=0.0, limPhysX=(-math.inf, math.inf),
               limPhysY=(-math.inf, math.inf), limOptX=None, limOptY=None,
               alpha=None, material=None, figure_error=None, shape='rect',
               rotationSequence='RzRyRx', extraRotationSequence='RzRyRx',
               order=1, curSurface=0, overEdge='ymax',
               gratingDensity=None, **kwargs):
        if figure_error is not None or gratingDensity is not None or \
                alpha is not None:
            raise NotImplementedError(
                'figure errors, grating densities and crystal asymmetry '
                'are not ported yet (ROADMAP A5, A8)')
        if isinstance(bragg, str):
            raise NotImplementedError('bragg given as an energy or '
                                      "'auto' needs crystals (ROADMAP A8)")

        def ang(v):
            v = config.auto_units_angle(v)
            return None if v is None else config.number(v)
        hasExtra = any(isinstance(v, torch.Tensor) or v
                       for v in (extraPitch, extraRoll, extraYaw))
        return cls(name=name, center=center, pitch=ang(pitch),
                   roll=ang(roll), yaw=ang(yaw),
                   positionRoll=ang(positionRoll), bragg_=ang(bragg),
                   extraPitch=ang(extraPitch) if hasExtra else None,
                   extraRoll=ang(extraRoll) if hasExtra else None,
                   extraYaw=ang(extraYaw) if hasExtra else None,
                   limPhysX=_fvec(limPhysX), limPhysY=_fvec(limPhysY),
                   limOptX=_fvec(limOptX), limOptY=_fvec(limOptY),
                   material=material, shape=shape,
                   rotationSequence=rotationSequence,
                   extraRotationSequence=extraRotationSequence, order=order,
                   curSurface=curSurface, overEdge=overEdge, **kwargs)

    # ---- surface --------------------------------------------------------
    def local_z(self, x, y):
        """Surface height z(x, y) in the local frame; flat by default."""
        return torch.zeros_like(x)

    def local_n(self, x, y):
        """Surface normal [nx, ny, nz]; (0, 0, 1) by default."""
        zero = torch.zeros_like(x)
        return [zero, zero, torch.ones_like(x)]

    def _placement(self, is2ndXtal=False):
        pitch = self.pitch
        if self.bragg_ is not None:
            pitch = pitch + self.bragg_
        roll = self.roll + self.positionRoll
        return pitch, roll, self.yaw, None, None, None

    # ---- classification -------------------------------------------------
    def rays_good(self, x, y, state, lostNum=config.STATE_DEAD,
                  limits=None):
        """Good/out/over/dead classification against the physical and
        optical limits; returns the new state tensor."""
        if limits is not None:
            limPhysX, limPhysY, limOptX, limOptY = limits
        else:
            limPhysX, limPhysY = self.limPhysX, self.limPhysY
            limOptX, limOptY = self.limOptX, self.limOptY
        locState = torch.ones_like(state)
        if self.shape == 'rect':
            if limOptX is not None:
                out = ((limPhysX[0] <= x) & (x < limOptX[0])) | \
                      ((limOptX[1] <= x) & (x < limPhysX[1]))
                locState = torch.where(out, 2, locState)
            if limOptY is not None:
                out = ((limPhysY[0] <= y) & (y < limOptY[0])) | \
                      ((limOptY[1] <= y) & (y < limPhysY[1]))
                locState = torch.where(out, 2, locState)
            outside = (x < limPhysX[0]) | (x > limPhysX[1]) | \
                      (y < limPhysY[0]) | (y > limPhysY[1])
            over = torch.zeros_like(outside)
            if 'xmin' in self.overEdge:
                over = over | (x < limPhysX[0])
            if 'xmax' in self.overEdge:
                over = over | (x > limPhysX[1])
            if 'ymin' in self.overEdge:
                over = over | (y < limPhysY[0])
            if 'ymax' in self.overEdge:
                over = over | (y > limPhysY[1])
            locState = torch.where(outside, lostNum, locState)
            locState = torch.where(over, 3, locState)
        elif self.shape == 'round':
            centerX = (limPhysX[0] + limPhysX[1]) * 0.5
            radiusX = (limPhysX[1] - limPhysX[0]) * 0.5
            centerY = (limPhysY[0] + limPhysY[1]) * 0.5
            radiusY = (limPhysY[1] - limPhysY[0]) * 0.5
            rr = ((x - centerX) / radiusX) ** 2 + \
                ((y - centerY) / radiusY) ** 2
            locState = torch.where(rr > 1, lostNum, locState)
        else:
            raise ValueError(f'unknown OE shape {self.shape!r}')
        return torch.where(state == 1, locState, state).to(state.dtype)

    # ---- bracketing -----------------------------------------------------
    def _bracket(self, x, y, z, a, b, c):
        """(tMin, tMax) of the intersection search for each ray: where it
        enters and leaves the element's box along its dominant direction."""
        def set_t(xyz, abc, lim, defSize):
            limMin = -defSize if lim is None else max(lim[0], -defSize)
            limMax = defSize if lim is None else min(lim[1], defSize)
            abc_safe = torch.where(abc == 0, torch.full_like(abc, 1e-30),
                                   abc)
            tLo = (limMin - xyz) / abc_safe
            tHi = (limMax - xyz) / abc_safe
            pos = abc > 0
            return (torch.where(pos, tLo, tHi) - config.DT_MARGIN,
                    torch.where(pos, tHi, tLo) + config.DT_MARGIN)

        tx1, tx2 = set_t(x, a, self.limPhysX, config.MAX_HALF_SIZE_OF_OE)
        ty1, ty2 = set_t(y, b, self.limPhysY, config.MAX_HALF_SIZE_OF_OE)
        tz1, tz2 = set_t(z, c, None, config.MAX_DEPTH_OF_OE)
        absa, absb, absc = torch.abs(a), torch.abs(b), torch.abs(c)
        useX = (absa >= absb) & (absa >= absc)
        useY = (absb > absa) & (absb >= absc)
        tMin = torch.where(useX, tx1, torch.where(useY, ty1, tz1))
        tMax = torch.where(useX, tx2, torch.where(useY, ty2, tz2))
        # clip the start for near-coincident previous reflection points
        tMin = torch.clamp(tMin, min=-1e6 * _z_eps(x.dtype))
        tMax = torch.maximum(tMax, tMin)
        return tMin, tMax

    # ---- frames ---------------------------------------------------------
    def local_to_global(self, lb: Beam, is2ndXtal=False) -> Beam:
        """True-local beam -> global frame, rotating the polarization back
        by the local roll."""
        pitch, roll, yaw = self._placement()[0:3]
        if self.extraPitch is not None:
            lb = rotate_beam(
                lb, rotationSequence='-' + self.extraRotationSequence,
                pitch=self.extraPitch, roll=self.extraRoll,
                yaw=self.extraYaw)
        lb = rotate_beam(lb, rotationSequence='-' + self.rotationSequence,
                         pitch=pitch, roll=roll, yaw=yaw)
        normal = self.local_n(lb.x, lb.y)
        ones = torch.ones_like(lb.x)
        rollAngle = self.roll + self.positionRoll + \
            torch.atan2(normal[-3] * ones, normal[-1] * ones)
        Jss, Jpp, Jsp = rotate_coherency_matrix(lb.Jss, lb.Jpp, lb.Jsp,
                                                rollAngle)
        updates = dict(Jss=Jss, Jpp=Jpp, Jsp=Jsp)
        if lb.Es is not None:
            Es, Ep = rotate_y(lb.Es, lb.Ep, torch.cos(rollAngle),
                              torch.sin(rollAngle))
            updates.update(Es=Es, Ep=Ep)
        return virgin_local_to_global(lb.replace(**updates), self.center)

    # ---- reflection -----------------------------------------------------
    def reflect(self, beam: Beam, generator=None, needLocal=True,
                noIntersectionSearch=False, is2ndXtal=False,
                fromVacuum=True):
        """Reflect *beam* (global frame) off this OE; returns (beamGlobal,
        beamLocal).  With ``noIntersectionSearch=True`` the rays are taken
        to be on the surface already (the wave hops)."""
        if is2ndXtal or self.isParametric:
            raise NotImplementedError(
                'the second crystal of a DCM and parametric surfaces are '
                'not ported yet (ROADMAP A8)')
        good_in = beam.state > 0
        lb = global_to_virgin_local(beam, self.center)
        pitch, roll, yaw, dx, dy, dz = self._placement(is2ndXtal)
        if any(v is not None for v in (dx, dy, dz)):
            raise NotImplementedError(
                'element offsets dx, dy, dz are not ported yet (ROADMAP A8)')
        lb, out = self._reflect_local(
            lb, good_in, pitch, roll, yaw, fromVacuum=fromVacuum,
            noIntersectionSearch=noIntersectionSearch)
        glo = virgin_local_to_global(lb, self.center)
        merged = _merge_by_mask(beam, glo, good_in)
        if needLocal:
            return merged, out
        return merged

    def _reflect_local(self, lb, good, pitch, roll, yaw, fromVacuum=True,
                       noIntersectionSearch=False):
        """The virgin-local part of reflect.  Returns (virgin-local beam,
        true-local beam)."""
        lb = rotate_beam(lb, rotationSequence=self.rotationSequence,
                         pitch=-pitch, roll=-roll, yaw=-yaw)
        if self.extraPitch is not None:
            lb = rotate_beam(lb, rotationSequence=self.extraRotationSequence,
                             pitch=-self.extraPitch, roll=-self.extraRoll,
                             yaw=-self.extraYaw)
        if noIntersectionSearch:
            t = torch.zeros_like(lb.x)
            state = self.rays_good(lb.x, lb.y, lb.state)
        else:
            tMin, tMax = self._bracket(lb.x, lb.y, lb.z, lb.a, lb.b, lb.c)
            t, xx, yy, zz, lost = find_intersection(
                self.local_z, tMin, tMax, lb.x, lb.y, lb.z, lb.a, lb.b,
                lb.c, invertNormal=1 if fromVacuum else -1, active=good)
            lb = lb.replace(x=torch.where(good, xx, lb.x),
                            y=torch.where(good, yy, lb.y),
                            z=torch.where(good, zz, lb.z))
            state = self.rays_good(lb.x, lb.y, lb.state)
            state = torch.where(good & lost, config.STATE_DEAD, state)
        state = torch.where(good, state, lb.state)
        lb = lb.replace(state=state)
        goodN = state == 1
        lb = lb.replace(path=torch.where(goodN, lb.path + t, lb.path))
        lb, rollAngle = self._interact(lb, goodN, roll, fromVacuum, t,
                                       self.material)
        # back to virgin local; only the virgin-local copy rotates the
        # polarization back by the local roll, the true-local beam keeps
        # the surface s/p frame
        JssB, JppB, JspB = rotate_coherency_matrix(lb.Jss, lb.Jpp, lb.Jsp,
                                                   rollAngle)
        upd = dict(Jss=torch.where(goodN, JssB, lb.Jss),
                   Jpp=torch.where(goodN, JppB, lb.Jpp),
                   Jsp=torch.where(goodN, JspB, lb.Jsp))
        if lb.Es is not None:
            EsB, EpB = rotate_y(lb.Es, lb.Ep, torch.cos(rollAngle),
                                torch.sin(rollAngle))
            upd['Es'] = torch.where(goodN, EsB, lb.Es)
            upd['Ep'] = torch.where(goodN, EpB, lb.Ep)
        vlb = lb.replace(**upd)
        if self.extraPitch is not None:
            vlb = rotate_beam(
                vlb, rotationSequence='-' + self.extraRotationSequence,
                pitch=self.extraPitch, roll=self.extraRoll,
                yaw=self.extraYaw)
        vlb = rotate_beam(vlb, rotationSequence='-' + self.rotationSequence,
                          pitch=pitch, roll=roll, yaw=yaw)
        return vlb, lb

    def _interact(self, lb, goodN, roll, fromVacuum, tMax, material):
        """Direction update, reflectivity and polarization bookkeeping for
        rays with state == 1 (mirror kinds)."""
        matSur = material[self.curSurface] \
            if isinstance(material, (list, tuple)) else material
        kind = 'mirror' if matSur is None else \
            matSur.resolved_kind(self.auto_material_kind)
        if kind not in ('mirror', 'thin mirror'):
            raise NotImplementedError(
                f'OE physics of kind {kind!r} is not ported yet '
                '(ROADMAP A5, A8)')
        normal = list(self.local_n(lb.x, lb.y))
        ones = torch.ones_like(lb.x)
        nbx, nby, nbz = (normal[0] * ones, normal[1] * ones,
                         normal[2] * ones)
        nsx, nsz = normal[-3] * ones, normal[-1] * ones

        beamInDotNormal = torch.clamp(
            _dot3(lb.a, lb.b, lb.c, nbx, nby, nbz), -1.0, 1.0)
        theta_new = torch.arccos(beamInDotNormal) - math.pi / 2
        prev = lb.theta if lb.theta is not None else \
            torch.zeros_like(theta_new)
        lb = lb.replace(theta=torch.where(goodN, theta_new, prev))
        a_out = lb.a - nbx * 2 * beamInDotNormal
        b_out = lb.b - nby * 2 * beamInDotNormal
        c_out = lb.c - nbz * 2 * beamInDotNormal

        rollAngle = roll + torch.atan2(nsx, nsz)
        Jss_l, Jpp_l, Jsp_l = rotate_coherency_matrix(
            lb.Jss, lb.Jpp, lb.Jsp, -rollAngle)
        Es_l = Ep_l = None
        if lb.Es is not None:
            Es_l, Ep_l = rotate_y(lb.Es, lb.Ep, torch.cos(rollAngle),
                                  -torch.sin(rollAngle))
        if matSur is None:
            ras = rap = torch.ones_like(lb.x)
        else:
            ras, rap = matSur.get_amplitude(lb.E, beamInDotNormal,
                                            fromVacuum)[0:2]
        ras = torch.where(torch.isnan(torch.abs(ras)), 0.0, ras)
        rap = torch.where(torch.isnan(torch.abs(rap)), 0.0, rap)

        Jss_new = (Jss_l * ras * torch.conj(ras)).real
        Jpp_new = (Jpp_l * rap * torch.conj(rap)).real
        Jsp_new = Jsp_l * ras * torch.conj(rap)
        updates = dict(
            a=torch.where(goodN, a_out, lb.a),
            b=torch.where(goodN, b_out, lb.b),
            c=torch.where(goodN, c_out, lb.c),
            Jss=torch.where(goodN, Jss_new, lb.Jss),
            Jpp=torch.where(goodN, Jpp_new, lb.Jpp),
            Jsp=torch.where(goodN, Jsp_new, lb.Jsp))
        if Es_l is not None:
            arg = 1e7 * lb.E / CHBAR * tMax
            mPh = torch.complex(torch.cos(arg), torch.sin(arg))
            updates['Es'] = torch.where(goodN, Es_l * ras * mPh, lb.Es)
            updates['Ep'] = torch.where(goodN, Ep_l * rap * mPh, lb.Ep)
        return lb.replace(**updates), rollAngle
