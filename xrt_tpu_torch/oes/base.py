"""Optical element base: placement, ray-surface intersection, frames,
classification and the reflection physics at the surface.

Port of the reference package's ``oes/base.py``: ``OE.create`` (with a
crystal's asymmetry angle ``alpha`` and ``bragg`` given as an angle, an
alignment energy or 'auto'), the local/global frames, ``local_z``/
``local_n``, ``rays_good``, the bracketed intersection search
(``find_intersection``, ``find_intersection_dz``, ``OE._bracket``),
``reflect`` (with the search, or with ``noIntersectionSearch=True`` for
the wave hops, which reflect at the exact receiving samples), the element
offsets and the second crystal of a DCM (``is2ndXtal``), and ``_interact``
for the mirror kinds, for gratings and zone plates (the grating vector
``local_g`` of the element, or of any OE given a ``gratingDensity``, into
one order, several shared at random or a per-ray order, with tabulated
efficiencies) and for crystals: Bragg and Laue, symmetric or asymmetric
through the crystal's grating vector (``_grating_deflection``), mosaic
(``_mosaic_normal``), with the two-beam amplitudes.  Rays are never
filtered: the ``state`` mask selects which rays change.

The search (``find_intersection_dz``) is a vectorized Illinois (modified
regula falsi) iteration on all rays in lockstep with a convergence mask,
then two Newton steps.  The iteration runs under ``torch.no_grad()`` and
reads the count of active rays to the host once per iteration, stopping
at 0: one iteration is tens of kernel launches over the whole ray state,
so the read costs less than one more iteration would.  The Newton steps
are differentiable torch operations: they polish the root (float32 at t ~
1e4 mm has ~6e-4 mm ulps, so the bracket alone cannot give float32
accuracy) and carry the implicit-function gradient dt/dparams =
-dF/dparams / dF/dt.  The toroid crystals' own surfaces on a card go to
one CUDA kernel instead (``oes/toroid_search.py``): the same solve with no
host read and one launch a call, the Newton steps left on the tape when
autograd records.  While the profiler traces (``profiler.tracing``),
either search is the span ``oes.search`` and counts its calls,
iterations, rays evaluated and rays still active (``search.calls``,
``search.iterations``, ``search.ray_evals``, ``search.active``; the
kernel also ``search.fused``); ``reflect`` is the span ``oes.reflect``
and ``_interact`` within it ``oes.interact``.

Parametric surfaces (``isParametric``: ``xyz_to_param``, ``local_r``,
``param_to_xyz``, a normal in (s, phi)) are searched in their radial
coordinate and classified, reflected and reported in (s, phi, r); an OE
with ``analytic_intersect`` (the blazed grating) is intersected by it
instead of the search.  ``_interact`` also refracts through plates and
lenses (with absorption along the path inside), reflects off multilayers,
gives bent crystals their Takagi-Taupin amplitudes (``useTT``), diffracts
a volumetric crystal at a random depth with the lattice orientation there
(``local_n_depth``), and scatters off powders, monocrystals and crystal
harmonics, and takes a voxel-volume (TXM) material's refractive index at
the intersection and its attenuation and phase along the chord through
the volume.  A *figure_error* (``figure_error.FigureError``) adds its
height to the surface the search finds (in (s, phi) on a parametric
surface) and turns the normal by its slopes.  ``multiple_reflect``
bounces rays on one surface up to a fixed number of times (capillaries).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import config
from ..beam import Beam, rotate_coherency_matrix
from ..materials.crystal import _over
from ..ops.dd import sqrt_rn
from ..physconsts import CH, CHBAR
from ..profiler import count, stage
from ..sources.geometric import _draw
from ..transforms import (cos, global_to_virgin_local, rotate_beam, rotate_x,
                          rotate_y, sin,
                          virgin_local_to_global)
from . import toroid_search


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

    with stage('oes.search', device=x):
        with torch.no_grad():
            fa, fb = F(tMin), F(tMax)
            lost = active & (fa <= 0)     # started below the surface
            over = active & (fb >= 0)     # never crosses within the bracket
            good = active & ~(lost | over)
            # Illinois iteration on the bracket [ta, tb], f(ta) > 0 > f(tb)
            ta, tb = tMin, tMax
            ts = torch.where(good, 0.5 * (ta + tb), tMax)
            act = good
            count('search.calls')
            for _ in range(max_iterations):
                n_active = int(act.count_nonzero())
                if n_active == 0:
                    break
                count('search.iterations')
                count('search.ray_evals', act.numel())
                count('search.active', n_active)
                denom = fb - fa
                denom = torch.where(denom == 0, torch.ones_like(denom),
                                    denom)
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
                fa = torch.where(upd_a, fs,
                                 torch.where(upd_b, fa * 0.5, fa))
                fb = torch.where(upd_b, fs,
                                 torch.where(upd_a, fb * 0.5, fb))
                ta = torch.where(upd_a, tn, ta)
                tb = torch.where(upd_b, tn, tb)
                ts = torch.where(act, tn, ts)
                # the absolute eps is unreachable in float32 at beamline
                # scales, so the bracket width is also tested relative to
                # t; the Newton steps below restore full precision
                tol = eps + rel * (torch.abs(ta) + torch.abs(tb))
                act = act & (torch.abs(fs) > eps) & \
                    (torch.abs(tb - ta) > tol)
            t0 = torch.where(good, ts, torch.where(lost, tMin, tMax))

        t = t0
        for _ in range(2):   # quadratic: two steps reach machine precision
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


def _rng(generator, like):
    """*generator*, or a generator seeded with 0 on *like*'s device."""
    if generator is None:
        return torch.Generator(like.device).manual_seed(0)
    return generator


def _stream(generator, like):
    """A function that gives :func:`_rng`'s generator, made at its first
    call and the same at every later one: the draws of one reflect share
    one stream, and a reflect that draws nothing makes no generator."""
    made = []

    def get():
        if not made:
            made.append(_rng(generator, like))
        return made[0]
    return get


def _mosaic_normal(generator, mat, oeNormal, E, draws=None):
    """Crystallite normals of a mosaic crystal: the nominal Bragg-plane
    normal tilted by a normal draw of sigma ``mat.mosaicity`` about a
    uniformly drawn azimuth.  *draws*, (standard normals, uniforms in
    [0, 1)), replaces the draws from *generator*."""
    if draws is None:
        g = _rng(generator, E)
        draws = (_draw(torch.randn, g, E.shape[0], E.dtype, E.device),
                 _draw(torch.rand, g, E.shape[0], E.dtype, E.device))
    dtheta = mat.mosaicity * draws[0]
    phi = 2 * math.pi * draws[1]
    nx, ny, nz = oeNormal
    # an orthonormal basis (u, v) perpendicular to n
    side = torch.abs(nz) < 0.9
    zero = torch.zeros_like(nx)
    ux = torch.where(side, -ny, zero)
    uy = torch.where(side, nx, nz)
    uz = torch.where(side, zero, -ny)
    un = sqrt_rn(ux ** 2 + uy ** 2 + uz ** 2)
    un = torch.where(un == 0, torch.ones_like(un), un)
    ux, uy, uz = ux / un, uy / un, uz / un
    vx = ny * uz - nz * uy
    vy = nz * ux - nx * uz
    vz = nx * uy - ny * ux
    st, ct = torch.sin(dtheta), torch.cos(dtheta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    return (nx * ct + (ux * cp + vx * sp) * st,
            ny * ct + (uy * cp + vy * sp) * st,
            nz * ct + (uz * cp + vz * sp) * st)


class OE(config.Replaceable):
    """A general optical element.  Subclasses define the surface through
    ``local_z``/``local_n``.  Limits are Python floats.  The centre, the
    placement angles and a subclass's radii are Python floats, or the
    tensors that were passed in (to ``create``, the constructor or
    ``replace``): a gradient then flows to them through ``reflect``.  The
    host geometry of the wave samplers reads their detached values.
    Material tables are tensors on the material's device.  *alpha* is a
    crystal's asymmetry angle: the Bragg planes are turned by it about x,
    and ``local_n`` gives the Bragg-plane normal and the surface normal as
    six components.  *gratingDensity* (rho0, P0, P1, ...) makes the
    element a grating along *grooveAxis*: rho(t) = rho0 (P0 + 2 P1 t +
    3 P2 t^2 + ...) lines/mm."""

    isParametric = False
    #: the creation arguments of a class whose fields derive from them (the
    #: parametric conics): (name, value) pairs a layout records
    createArgs = None

    def __init__(self, name='', center=(0, 0, 0), pitch=0.0, roll=0.0,
                 yaw=0.0, positionRoll=0.0, bragg_=None, extraPitch=None,
                 extraRoll=None, extraYaw=None, limPhysX=None,
                 limPhysY=None, limOptX=None, limOptY=None, alpha=None,
                 material=None, shape='rect', rotationSequence='RzRyRx',
                 extraRotationSequence='RzRyRx', order=1, curSurface=0,
                 overEdge='ymax', auto_material_kind='mirror',
                 gratingDensity=None, grooveAxis='y', figure_error=None):
        self.name = name
        self.figure_error = figure_error
        self.center = tuple(config.number(c) for c in center)
        self.pitch, self.roll, self.yaw = pitch, roll, yaw
        self.positionRoll = positionRoll
        self.bragg_ = bragg_
        self.extraPitch, self.extraRoll, self.extraYaw = \
            extraPitch, extraRoll, extraYaw
        self.limPhysX, self.limPhysY = limPhysX, limPhysY
        self.limOptX, self.limOptY = limOptX, limOptY
        self.alpha = alpha
        self.material = material
        self.shape = shape
        self.rotationSequence = rotationSequence
        self.extraRotationSequence = extraRotationSequence
        self.order = order
        self.curSurface = curSurface
        self.overEdge = overEdge
        self.auto_material_kind = auto_material_kind
        self.gratingDensity = gratingDensity
        self.grooveAxis = grooveAxis

    @classmethod
    def create(cls, name='', center=(0, 0, 0), pitch=0.0, roll=0.0, yaw=0.0,
               positionRoll=0.0, bragg=None, extraPitch=0.0, extraRoll=0.0,
               extraYaw=0.0, limPhysX=(-math.inf, math.inf),
               limPhysY=(-math.inf, math.inf), limOptX=None, limOptY=None,
               alpha=None, material=None, figure_error=None, shape='rect',
               rotationSequence='RzRyRx', extraRotationSequence='RzRyRx',
               order=1, curSurface=0, overEdge='ymax',
               gratingDensity=None, **kwargs):
        """The reference's constructor arguments.  *bragg* adds to the
        pitch: an angle, or an alignment energy ('8000 eV') whose Bragg
        angle (less the refraction correction) the material gives, in the
        material's dtype; 'auto' leaves it out.  *gratingDensity* is the
        reference's [axis, rho0, P0, P1, ...]; *figure_error* a
        ``figure_error.FigureError``."""
        if gratingDensity is not None:
            kwargs['grooveAxis'] = str(gratingDensity[0])
            kwargs['gratingDensity'] = tuple(float(v)
                                             for v in gratingDensity[1:])
            kwargs.setdefault('auto_material_kind', 'grating')
        if isinstance(bragg, str):
            E_al = config.parse_energy(bragg)
            if E_al is not None:
                if material is None:
                    raise ValueError(
                        f'bragg={bragg!r} needs a material to resolve '
                        'the Bragg angle')
                bragg = float(material.get_Bragg_angle(E_al) -
                              material.get_dtheta(E_al))
            elif 'auto' in bragg.lower():
                bragg = None

        def ang(v):
            v = config.auto_units_angle(v)
            return None if v is None else config.number(v)
        if order is not None and not isinstance(order, (int, float, str)):
            # several diffraction orders: rays are shared among them at
            # random
            order = tuple(float(o) for o in np.ravel(order))
            if len(order) == 1:
                order = order[0]
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
                   alpha=ang(alpha), material=material, shape=shape,
                   rotationSequence=rotationSequence,
                   extraRotationSequence=extraRotationSequence, order=order,
                   curSurface=curSurface, overEdge=overEdge,
                   figure_error=figure_error, **kwargs)

    def _export_params(self):
        """A layout's (drop, extra): the grating density in the
        reference's [axis, rho0, P0, ...] form."""
        if self.gratingDensity is None:
            return (), {}
        return (('gratingDensity',),
                {'gratingDensity': [self.grooveAxis] +
                 [float(v) for v in self.gratingDensity]})

    # ---- surface --------------------------------------------------------
    def local_z(self, x, y):
        """Surface height z(x, y) in the local frame; flat by default."""
        return torch.zeros_like(x)

    def local_n(self, x, y):
        """Surface normal [nx, ny, nz]; (0, 0, 1) by default.  With an
        asymmetry angle *alpha*: [Bragg-plane normal, surface normal]."""
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        if self.alpha is not None:
            bA, cA = rotate_x(zero, one, cos(self.alpha), -sin(self.alpha))
            return [zero, bA, cA, zero, zero, one]
        return [zero, zero, one]

    def local_g(self, x, y):
        """The local groove vector (1/mm) of an element with a
        *gratingDensity*: -rho(t) along its groove axis."""
        gd = self.gratingDensity
        if gd is None:
            raise NotImplementedError(
                f'{type(self).__name__} has no grating vector: give it a '
                'gratingDensity')
        t = x if self.grooveAxis == 'x' else y
        rho = gd[0] * torch.ones_like(t)
        if len(gd) > 1:
            poly = gd[1] * torch.ones_like(t)
            for i in range(2, len(gd)):
                poly = poly + i * gd[i] * t ** (i - 1)
            rho = rho * poly
        zero = torch.zeros_like(t)
        if self.grooveAxis == 'x':
            return [-rho, zero, zero]
        return [zero, -rho, zero]

    def local_n_depth(self, x, y, z):
        """The Bragg-plane and surface normals at depth *z* inside a
        crystal, for volumetric diffraction; None: no depth dependence."""
        return None

    # ---- figure errors ---------------------------------------------------
    def local_r_distorted(self, s, phi):
        """The figure error's radial distortion of a parametric OE at
        (s, phi), or None."""
        if self.figure_error is not None:
            return self.figure_error.local_r_distorted(s, phi)
        return None

    def local_z_distorted(self, x, y):
        """The figure error's height at (x, y), mm, or None."""
        if self.figure_error is not None:
            return self.figure_error.local_z_distorted(x, y)
        return None

    def local_n_distorted(self, x, y):
        """The figure error's turn of the normal: None, (d_pitch, d_roll)
        angles, or a 3-vector added to the normal."""
        if self.figure_error is not None:
            return self.figure_error.local_n_distorted(x, y)
        return None

    def propagate_wave(self, wave=None, nrays='auto', generator=None,
                       fixedEnergy=None, prevOE=None, **kw):
        """One-call Kirchhoff hop onto this OE and reflection at its surface
        (see :func:`xrt_tpu_torch.waves.propagate_wave_to_oe`).  Returns
        (beamGlobal, beamLocal)."""
        from ..waves import propagate_wave_to_oe
        return propagate_wave_to_oe(self, wave, nrays=nrays,
                                    generator=generator,
                                    fixedEnergy=fixedEnergy, prevOE=prevOE,
                                    **kw)

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

    def _radial_distance(self, invertNormal):
        """dz(x, y, z) of the intersection search on a parametric surface:
        the radial distance local_r(s, phi) - r of the point inside it,
        with the figure error's distortion in (s, phi)."""
        def dz_fn(xx, yy, zz):
            s_, phi_, r_ = self.xyz_to_param(xx, yy, zz)
            surf = self.local_r(s_, phi_)
            dist = self.local_r_distorted(s_, phi_)
            if dist is not None:
                surf = surf + dist
            surf = torch.where(torch.isnan(surf), torch.zeros_like(surf),
                               surf)
            return (surf - r_) * invertNormal
        return dz_fn

    # ---- bracketing -----------------------------------------------------
    def _bracket(self, x, y, z, a, b, c, limPhysX=None, limPhysY=None):
        """(tMin, tMax) of the intersection search for each ray: where it
        enters and leaves the element's box (by default its physical
        limits) along its dominant direction."""
        if limPhysX is None:
            limPhysX = self.limPhysX
        if limPhysY is None:
            limPhysY = self.limPhysY

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

        tx1, tx2 = set_t(x, a, limPhysX, config.MAX_HALF_SIZE_OF_OE)
        ty1, ty2 = set_t(y, b, limPhysY, config.MAX_HALF_SIZE_OF_OE)
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

    def multiple_reflect(self, beam: Beam, generator=None, maxReflections=20,
                         draws=None):
        """Up to *maxReflections* bounces on this one (closed or strongly
        curved) surface: capillaries and whispering-gallery optics.  The
        first bounce searches forward from the ray as ``reflect`` does,
        every later one from past the ray's tangent point (``isMulti``);
        a ray that flies over keeps its coordinates from before that
        bounce, and converged rays pass through masked.  The loop has its
        fixed length.  *generator* draws for the bounces; *draws*, one
        ``draws`` dict (or None) a bounce, replaces them (the reference
        draws bounce i from its key folded with i).  Returns (beamGlobal
        with ``nRefl`` per ray, the true-local beam of each ray's last
        bounce)."""
        good_in = beam.state > 0
        lb = global_to_virgin_local(beam, self.center)
        pitch, roll, yaw, dx, dy, dz = self._placement()
        nRefl = torch.zeros_like(beam.state)
        good = good_in
        out_local = None
        for i in range(maxReflections):
            vlb, loc = self._reflect_local(
                lb, good, pitch, roll, yaw, dx, dy, dz, generator=generator,
                draws=None if draws is None else draws[i], isMulti=i > 0)
            flew = good & (vlb.state == 3)
            vlb = vlb.replace(**{k: torch.where(flew, getattr(lb, k),
                                                getattr(vlb, k))
                                 for k in 'xyz'})
            newGood = good & ((vlb.state == 1) | (vlb.state == 2))
            nRefl = nRefl + newGood.to(nRefl.dtype)
            lb = _merge_by_mask(lb, vlb, good)
            out_local = loc if out_local is None else \
                _merge_by_mask(out_local, loc, newGood)
            good = newGood
        hit = good_in & (nRefl > 0)
        merged = _merge_by_mask(beam, virgin_local_to_global(lb, self.center),
                                hit)
        merged = merged.replace(
            state=torch.where(hit, torch.ones_like(beam.state), beam.state),
            nRefl=nRefl)
        return merged, out_local

    # ---- frames ---------------------------------------------------------
    def local_to_global(self, lb: Beam, is2ndXtal=False) -> Beam:
        """True-local beam -> global frame, rotating the polarization back
        by the local roll.  A DCM's crystals (*is2ndXtal* for the second)
        are placed by its Bragg angle, rolls and offsets."""
        dx = dy = dz = None
        dcm = hasattr(self, 'braggAngle')
        if is2ndXtal and dcm:
            pitch = -self.pitch - self.braggAngle + self.cryst2pitch + \
                self.cryst2finePitch
            roll = self.roll + self.cryst2roll + self.positionRoll
            yaw = -self.yaw
            dx, dy, dz = -self.dxCryst, self.cryst2longTransl, \
                -self.cryst2perpTransl
        elif dcm:
            pitch = self.pitch + self.braggAngle
            roll = self.roll + self.positionRoll + self.cryst1roll
            yaw = self.yaw
            dx = self.dxCryst
        else:
            pitch, roll, yaw = self._placement()[0:3]
        lb = _shift(lb, dx, dy, dz, 1)
        if self.extraPitch is not None:
            sign = -1.0 if is2ndXtal else 1.0
            lb = rotate_beam(
                lb, rotationSequence='-' + self.extraRotationSequence,
                pitch=sign * self.extraPitch, roll=self.extraRoll,
                yaw=sign * self.extraYaw)
        lb = rotate_beam(lb, rotationSequence='-' + self.rotationSequence,
                         pitch=pitch, roll=roll, yaw=yaw)
        if is2ndXtal and dcm:
            lb = rotate_beam(lb, roll=math.pi)
        if self.isParametric:
            normal = self.local_n(*self.xyz_to_param(lb.x, lb.y, lb.z)[:2])
        else:
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
                fromVacuum=True, surfacePoints=None, draws=None):
        """Reflect *beam* (global frame) off this OE; returns (beamGlobal,
        beamLocal).  *generator* draws what a material needs at random (a
        mosaic crystal's crystallites, a grating's orders, a powder's
        crystallites and depths, a volumetric crystal's depths; seed 0 if
        None); *draws* replaces some of them (see ``_interact``).
        With ``noIntersectionSearch=True`` the rays are taken
        to be on the surface already (the wave hops); *surfacePoints*, the
        local (x, y, z) of those points, then replaces the positions that
        the global frame gives back, so that the surface (its normal, a
        grating's facet) is evaluated where the samples are: in float32 the
        round trip through global coordinates moves them by ulp(|centre|),
        ~2e-3 mm at 26 m, a grating period's scale."""
        with stage('oes.reflect', device=beam.x):
            good_in = beam.state > 0
            lb = global_to_virgin_local(beam, self.center)
            pitch, roll, yaw, dx, dy, dz = self._placement(is2ndXtal)
            lb, out = self._reflect_local(
                lb, good_in, pitch, roll, yaw, dx, dy, dz,
                fromVacuum=fromVacuum, is2ndXtal=is2ndXtal,
                noIntersectionSearch=noIntersectionSearch,
                surfacePoints=surfacePoints, generator=generator,
                draws=draws)
            glo = virgin_local_to_global(lb, self.center)
            merged = _merge_by_mask(beam, glo, good_in)
        if needLocal:
            return merged, out
        return merged

    def _reflect_local(self, lb, good, pitch, roll, yaw, dx=None, dy=None,
                       dz=None, fromVacuum=True, is2ndXtal=False,
                       noIntersectionSearch=False, surfacePoints=None,
                       local_z=None, local_n=None, material=None,
                       limits=None, generator=None, draws=None,
                       isMulti=False):
        """The virgin-local part of reflect.  *dx, dy, dz* are the
        element's offsets in its own frame; the second crystal of a DCM
        (*is2ndXtal*) is turned by pi in roll before and after and takes
        the extra angles mirrored.  *local_z*, *local_n*, *material* and
        *limits* (limPhysX, limPhysY, limOptX, limOptY) replace the
        element's own.  *isMulti* (a bounce after the first on one
        surface) starts the search past the ray's tangent point: the root
        of the search function's derivative along the ray.  Returns
        (virgin-local beam, true-local beam)."""
        if material is None:
            material = self.material
        own_z = local_z is None
        if own_z:
            local_z = self.local_z
        if local_n is None:
            local_n = self.local_n
        if limits is None:
            limits = (self.limPhysX, self.limPhysY, self.limOptX,
                      self.limOptY)
        extraSign = -1.0 if is2ndXtal else 1.0
        if is2ndXtal:
            lb = rotate_beam(lb, roll=math.pi)
        lb = rotate_beam(lb, rotationSequence=self.rotationSequence,
                         pitch=-pitch, roll=-roll, yaw=-yaw)
        if self.extraPitch is not None:
            lb = rotate_beam(lb, rotationSequence=self.extraRotationSequence,
                             pitch=-extraSign * self.extraPitch,
                             roll=-self.extraRoll,
                             yaw=-extraSign * self.extraYaw)
        lb = _shift(lb, dx, dy, dz, -1)
        param = self.isParametric
        if noIntersectionSearch:
            t = torch.zeros_like(lb.x)
            lost = torch.zeros_like(good)
            if surfacePoints is not None:
                lb = lb.replace(**{k: torch.where(good, v, getattr(lb, k))
                                   for k, v in zip('xyz', surfacePoints)})
        else:
            tMin, tMax = self._bracket(lb.x, lb.y, lb.z, lb.a, lb.b, lb.c,
                                       limits[0], limits[1])
            ray = (lb.x, lb.y, lb.z, lb.a, lb.b, lb.c)
            inv = getattr(self, 'invertNormal', None)
            if inv is None:   # a hyperboloid's outer surface sets -1
                inv = 1 if fromVacuum else -1
            if param:
                dz_fn = self._radial_distance(inv)
            else:
                def dz_fn(xx, yy, zz):
                    surf = local_z(xx, yy)
                    dist = self.local_z_distorted(xx, yy)
                    if dist is not None:
                        surf = surf + dist
                    surf = torch.where(torch.isnan(surf),
                                       torch.zeros_like(surf), surf)
                    return (zz - surf) * inv
            if isMulti:
                tMin = _tangent_point(dz_fn, tMax, ray, good) + 1e-6
            if hasattr(self, 'analytic_intersect'):
                t, xx, yy, zz, lost = self.analytic_intersect(tMin, tMax,
                                                              *ray)
            elif toroid_search.engages(self, lb.x.device, lb.x.dtype,
                                       None if own_z else local_z, isMulti,
                                       inv):
                t, xx, yy, zz, lost = toroid_search.search(
                    self, tMin, tMax, *ray, good, inv, dz_fn)
            else:
                t, xx, yy, zz, lost = find_intersection_dz(
                    dz_fn, tMin, tMax, *ray, active=good)
            lb = lb.replace(x=torch.where(good, xx, lb.x),
                            y=torch.where(good, yy, lb.y),
                            z=torch.where(good, zz, lb.z))
        if param:
            # classify at the surface point of the hit, then carry the
            # parametric coordinates (s, phi, r) in x, y, z through the
            # physics: the normal is a function of (s, phi)
            sP, phiP, rP = self.xyz_to_param(lb.x, lb.y, lb.z)
            tX, tY, _ = self.param_to_xyz(sP, phiP, rP)
            state = self.rays_good(tX, tY, lb.state, limits=limits)
            lb = lb.replace(x=torch.where(good, sP, lb.x),
                            y=torch.where(good, phiP, lb.y),
                            z=torch.where(good, rP, lb.z))
        else:
            state = self.rays_good(lb.x, lb.y, lb.state, limits=limits)
        state = torch.where(good & lost, config.STATE_DEAD, state)
        state = torch.where(good, state, lb.state)
        lb = lb.replace(state=state)
        goodN = state == 1
        lb = lb.replace(path=torch.where(goodN, lb.path + t, lb.path))
        with stage('oes.interact', device=lb.x):
            lb, rollAngle = self._interact(lb, goodN, roll, fromVacuum, t,
                                           material, local_n, generator,
                                           draws, is2ndXtal=is2ndXtal)
        if param:
            # back to cartesian, keeping the parametric impact coordinates
            xC, yC, zC = self.param_to_xyz(lb.x, lb.y, lb.z)
            lb = lb.replace(s=lb.x, phi=lb.y, r=lb.z,
                            x=torch.where(good, xC, lb.x),
                            y=torch.where(good, yC, lb.y),
                            z=torch.where(good, zC, lb.z))
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
        vlb = _shift(lb.replace(**upd), dx, dy, dz, 1)
        if self.extraPitch is not None:
            vlb = rotate_beam(
                vlb, rotationSequence='-' + self.extraRotationSequence,
                pitch=extraSign * self.extraPitch, roll=self.extraRoll,
                yaw=extraSign * self.extraYaw)
        vlb = rotate_beam(vlb, rotationSequence='-' + self.rotationSequence,
                          pitch=pitch, roll=roll, yaw=yaw)
        if is2ndXtal:
            vlb = rotate_beam(vlb, roll=math.pi)
        return vlb, lb

    # ---- the physics at the surface ------------------------------------
    def _grating_deflection(self, generator, a, b, c, E, g, oeNormal,
                            beamInDotNormal, order=1, sig=None):
        """Directions after diffraction by the grating vector *g* (1/mm)
        into *order* (a number, a tuple of orders shared among the rays at
        random, or a per-ray tensor); returns (a, b, c, order)."""
        gx, gy, gz = g[0], g[1], g[2]
        beamInDotG = a * gx + b * gy + c * gz
        G2 = gx ** 2 + gy ** 2 + gz ** 2
        if isinstance(order, (int, float)):
            locOrder = torch.full_like(a, order)
        elif isinstance(order, (tuple, list)):
            g_ = _rng(generator, a)
            idx = torch.randint(0, len(order), a.shape, generator=g_,
                                device=g_.device).to(a.device)
            locOrder = torch.as_tensor(order, dtype=a.dtype,
                                       device=a.device)[idx]
        else:
            locOrder = order
        orderLambda = locOrder * CH / E * 1e-7
        u = beamInDotNormal ** 2 - 2 * beamInDotG * orderLambda - \
            G2 * orderLambda ** 2
        gs = torch.sign(beamInDotNormal) if sig is None else sig
        dn = beamInDotNormal + gs * sqrt_rn(torch.abs(u))
        nsx, nsy, nsz = oeNormal[-3], oeNormal[-2], oeNormal[-1]
        a_out = a - nsx * dn + gx * orderLambda
        b_out = b - nsy * dn + gy * orderLambda
        c_out = c - nsz * dn + gz * orderLambda
        norm = sqrt_rn(a_out ** 2 + b_out ** 2 + c_out ** 2)
        return a_out / norm, b_out / norm, c_out / norm, locOrder

    def _interact(self, lb, goodN, roll, fromVacuum, tMax, material,
                  local_n=None, generator=None, draws=None,
                  is2ndXtal=False):
        """Direction update, amplitudes and polarization bookkeeping for
        rays with state == 1: the mirror kinds, gratings and zone plates,
        Bragg and Laue crystals (flat, mosaic, bent by Takagi-Taupin
        integration, or diffracting through the depth), multilayers,
        refracting plates and lenses, and the multi-reflex materials
        (powder, monocrystal, crystal harmonics).  *draws* (a dict of
        tensors: 'orientation', a pair of uniforms, 'depth', uniforms, and
        'gumbel', one (N, 16) tensor a reflex chunk) replaces the draws
        from *generator*.  A voxel-volume material (TXM) refracts with its
        index at the point and, on the exit surface (*is2ndXtal* for the
        second surface of a plate), attenuates by the chord's integrals
        through the volume.  A figure error turns the normal first."""
        if local_n is None:
            local_n = self.local_n
        draws = {} if draws is None else draws
        rng = _stream(generator, lb.x)   # one stream for every draw
        matSur = material[self.curSurface] \
            if isinstance(material, (list, tuple)) else material
        kind = 'mirror' if matSur is None else \
            matSur.resolved_kind(self.auto_material_kind)
        volume = getattr(matSur, 'needsSpatialAmplitude', False)
        crystal = kind == 'crystal'
        normal = list(local_n(lb.x, lb.y))
        n_dist = self.local_n_distorted(lb.x, lb.y)
        if n_dist is not None:
            if len(n_dist) == 2:
                normal[-2], normal[-1] = rotate_x(
                    normal[-2], normal[-1], torch.cos(n_dist[0]),
                    torch.sin(n_dist[0]))
                normal[-3], normal[-1] = rotate_y(
                    normal[-3], normal[-1], torch.cos(n_dist[1]),
                    torch.sin(n_dist[1]))
            else:
                nx = normal[-3] + n_dist[0]
                ny = normal[-2] + n_dist[1]
                nz = normal[-1] + n_dist[2]
                nn = sqrt_rn(nx ** 2 + ny ** 2 + nz ** 2)
                normal[-3], normal[-2], normal[-1] = nx / nn, ny / nn, \
                    nz / nn
        ones = torch.ones_like(lb.x)
        nbx, nby, nbz = (normal[0] * ones, normal[1] * ones,
                         normal[2] * ones)
        nsx, nsy, nsz = (normal[-3] * ones, normal[-2] * ones,
                         normal[-1] * ones)
        isAsymmetric = len(normal) == 6

        if kind == 'powder':
            # both normals become the crystallite's, and the interaction
            # point moves to a random depth of the powder layer
            nbx, nby, nbz = matSur.random_orientation(
                rng(), lb.x.shape[0], lb.x.dtype, lb.x.device,
                draws=draws.get('orientation'))
            nsx, nsy, nsz = nbx, nby, nbz
            isAsymmetric = False
            if matSur.t is not None:
                lb = _move(lb, goodN, _uniform_draw(
                    rng, draws, 'depth', lb.x) * matSur.t)

        beamInDotNormal = torch.clamp(
            _dot3(lb.a, lb.b, lb.c, nbx, nby, nbz), -1.0, 1.0)
        theta_new = torch.arccos(beamInDotNormal) - math.pi / 2
        prev = lb.theta if lb.theta is not None else \
            torch.zeros_like(theta_new)
        lb = lb.replace(theta=torch.where(goodN, theta_new, prev))
        beamInDotSurfaceNormal = _dot3(lb.a, lb.b, lb.c, nsx, nsy, nsz) \
            if isAsymmetric else beamInDotNormal

        crystalVD = crystal and isAsymmetric and \
            matSur.volumetricDiffraction and matSur.t is not None
        if crystalVD:
            # diffraction at a random depth through the crystal, with the
            # lattice orientation there
            thMax = _over(-matSur.t, torch.where(
                beamInDotSurfaceNormal == 0, -torch.ones_like(ones),
                beamInDotSurfaceNormal))
            lb = _move(lb, goodN, _uniform_draw(
                rng, draws, 'depth', lb.x) * thMax)
            deep = self.local_n_depth(lb.x, lb.y, lb.z)
            if deep is not None:
                nbx, nby, nbz = (deep[0] * ones, deep[1] * ones,
                                 deep[2] * ones)
                beamInDotNormal = torch.clamp(
                    _dot3(lb.a, lb.b, lb.c, nbx, nby, nbz), -1.0, 1.0)
                theta_new = torch.arccos(beamInDotNormal) - math.pi / 2
                lb = lb.replace(theta=torch.where(goodN, theta_new,
                                                  lb.theta))
        mosaic = crystal and matSur.mosaicity is not None
        order_arr = poly = None
        a_out, b_out, c_out = lb.a, lb.b, lb.c

        if kind in ('powder', 'monocrystal', 'crystal harmonics'):
            a_out, b_out, c_out, *poly = matSur.reflect_multi_hkl(
                rng(), lb.E, (lb.a, lb.b, lb.c), (nbx, nby, nbz),
                (nsx, nsy, nsz), gumbel=draws.get('gumbel'))
        elif kind in ('grating', 'FZP'):
            # draws (the one draw of the reflect) only for a tuple of
            # orders, from its own stream then
            a_out, b_out, c_out, order_arr = self._grating_deflection(
                generator, lb.a, lb.b, lb.c, lb.E, self.local_g(lb.x, lb.y),
                normal, beamInDotSurfaceNormal, self.order,
                1 if kind == 'FZP' else -1)
        elif kind in ('mirror', 'thin mirror') or (
                crystalVD and not matSur.geom.endswith('transmitted')):
            # a volumetric crystal reflects about the depth's Bragg planes
            a_out = lb.a - nbx * 2 * beamInDotNormal
            b_out = lb.b - nby * 2 * beamInDotNormal
            c_out = lb.c - nbz * 2 * beamInDotNormal
        elif kind in ('crystal', 'multilayer'):
            if matSur.geom.endswith('transmitted'):
                pass
            elif mosaic:
                mx, my, mz = _mosaic_normal(rng(), matSur,
                                            (nbx, nby, nbz), lb.E)
                mdot = _dot3(lb.a, lb.b, lb.c, mx, my, mz)
                a_out = lb.a - mx * 2 * mdot
                b_out = lb.b - my * 2 * mdot
                c_out = lb.c - mz * 2 * mdot
            else:
                # reflection through the crystal's "grating" vector, the
                # Bragg-plane normal's part along the surface (zero for a
                # multilayer: a specular reflection); its sign follows
                # the mean incidence of all rays, the dead ones included,
                # and is taken on the device
                nDotNs = nbx * nsx + nby * nsy + nbz * nsz
                sgbdn = torch.where(torch.mean(beamInDotNormal) < 0, 1.0,
                                    -1.0)
                wHd = 1.0 / (matSur.d * 1e-7)
                gx = (nbx - nDotNs * nsx) * wHd * sgbdn
                gy = (nby - nDotNs * nsy) * wHd * sgbdn
                gz = (nbz - nDotNs * nsz) * wHd * sgbdn
                sg = 1 if matSur.geom.startswith('Laue') else -1
                a_out, b_out, c_out, _ = self._grating_deflection(
                    generator, lb.a, lb.b, lb.c, lb.E, (gx, gy, gz), normal,
                    beamInDotSurfaceNormal, 1, sg)
        elif kind in ('plate', 'lens'):
            if volume:   # the voxel's index at the intersection point
                n = matSur.get_refractive_index(lb.E, lb.x, lb.y, lb.z).real
            else:
                n = matSur.get_refractive_index(lb.E).real
            n1overn2 = _over(1.0, n) if fromVacuum else n
            signN = torch.sign(-beamInDotNormal)
            n1overn2cosTheta1 = -n1overn2 * beamInDotNormal
            cosTheta2 = signN * sqrt_rn(torch.clamp(
                1 - n1overn2 * n1overn2 +
                n1overn2cosTheta1 * n1overn2cosTheta1, min=0.0))
            dn = n1overn2cosTheta1 - cosTheta2
            a_out = lb.a * n1overn2 + nbx * dn
            b_out = lb.b * n1overn2 + nby * dn
            c_out = lb.c * n1overn2 + nbz * dn

        rollAngle = roll + torch.atan2(nsx, nsz)
        Jss_l, Jpp_l, Jsp_l = rotate_coherency_matrix(
            lb.Jss, lb.Jpp, lb.Jsp, -rollAngle)
        Es_l = Ep_l = None
        if lb.Es is not None:
            Es_l, Ep_l = rotate_y(lb.Es, lb.Ep, torch.cos(rollAngle),
                                  -torch.sin(rollAngle))
        mu = nreal = None
        if matSur is None:
            ras = rap = torch.ones_like(lb.x)
        elif poly is not None:
            ras, rap = poly
        elif crystal:
            beamOutDotSurfaceNormal = _dot3(a_out, b_out, c_out,
                                            nsx, nsy, nsz)
            if mosaic:
                ras, rap = matSur.get_amplitude_mosaic(
                    lb.E, beamInDotSurfaceNormal, beamOutDotSurfaceNormal,
                    beamInDotNormal)
            elif matSur.useTT:
                Ry, Rx = self._bending_radii()
                ras, rap = matSur.get_amplitude_pytte(
                    lb.E, beamInDotSurfaceNormal, beamOutDotSurfaceNormal,
                    beamInDotNormal, alphaAsym=self.alpha, Ry=Ry, Rx=Rx)
            else:
                ras, rap = matSur.get_amplitude(
                    lb.E, beamInDotSurfaceNormal, beamOutDotSurfaceNormal,
                    beamInDotNormal)
        elif kind == 'multilayer':
            ras, rap = matSur.get_amplitude(lb.E, beamInDotSurfaceNormal,
                                            lb.x, lb.y)[0:2]
        elif kind == 'grating' and getattr(matSur, 'efficiency_orders', ()):
            ras, rap = matSur.get_grating_efficiency(lb.E, order_arr)
        elif volume:
            # the volume's frame: the entry surface at z = 0, the beam
            # along +z, samples in z in [0, t]; a plate's exit (second
            # surface) frame relates to it by (x, y, z) -> (-x, y, z + t)
            tm = getattr(self, 't', None)
            if tm is None:
                tm = getattr(matSur, 't', None)
            tshift = 0.0 if (tm is None or not is2ndXtal) else tm
            sx = -1.0 if is2ndXtal else 1.0
            if fromVacuum:
                ras, rap, mu, nreal = matSur.get_amplitude(
                    lb.E, beamInDotNormal, fromVacuum, sx * lb.x, lb.y,
                    lb.z + tshift)
            else:
                ras, rap, mu, nreal = matSur.get_amplitude(
                    lb.E, beamInDotNormal, fromVacuum,
                    sx * (lb.x - lb.a * tMax), lb.y - lb.b * tMax,
                    (lb.z - lb.c * tMax) + tshift, sx * lb.a, lb.b, lb.c,
                    tMax)
        else:
            ras, rap, mu, nreal = matSur.get_amplitude(
                lb.E, beamInDotNormal, fromVacuum)
        ras = torch.where(torch.isnan(torch.abs(ras)), 0.0, ras)
        rap = torch.where(torch.isnan(torch.abs(rap)), 0.0, rap)

        Jss_new = (Jss_l * ras * torch.conj(ras)).real
        Jpp_new = (Jpp_l * rap * torch.conj(rap)).real
        Jsp_new = Jsp_l * ras * torch.conj(rap)
        mPh = None
        if not fromVacuum and mu is not None:
            # absorption (mu in 1/cm) and phase along the path inside
            att = torch.exp(-mu * tMax * 0.1)
            Jss_new, Jpp_new, Jsp_new = (Jss_new * att, Jpp_new * att,
                                         Jsp_new * att)
            if Es_l is not None:
                arg = 0.1 * nreal * tMax
                mPh = sqrt_rn(att) * torch.complex(torch.cos(arg),
                                                   torch.sin(arg))
        elif Es_l is not None:
            arg = 1e7 * lb.E / CHBAR * tMax
            mPh = torch.complex(torch.cos(arg), torch.sin(arg))
        updates = dict(
            a=torch.where(goodN, a_out, lb.a),
            b=torch.where(goodN, b_out, lb.b),
            c=torch.where(goodN, c_out, lb.c),
            Jss=torch.where(goodN, Jss_new, lb.Jss),
            Jpp=torch.where(goodN, Jpp_new, lb.Jpp),
            Jsp=torch.where(goodN, Jsp_new, lb.Jsp))
        if Es_l is not None:
            updates['Es'] = torch.where(goodN, Es_l * ras * mPh, lb.Es)
            updates['Ep'] = torch.where(goodN, Ep_l * rap * mPh, lb.Ep)
        if order_arr is not None:
            prev = lb.order if lb.order is not None else \
                torch.zeros_like(lb.x)
            updates['order'] = torch.where(goodN, order_arr, prev)
        return lb.replace(**updates), rollAngle

    def _bending_radii(self):
        """(Ry, Rx) of a bent crystal for its Takagi-Taupin amplitudes, as
        floats or None: Ry is the element's R, else its Rm (doubled for the
        Johansson and ground-bent classes, whose planes are bent to twice
        the surface's radius), Rx its Rs."""
        Ry = getattr(self, 'R', None)
        if Ry is None:
            Ry = getattr(self, 'Rm', None)
        lcname = type(self).__name__.lower()
        if Ry is not None and ('johansson' in lcname or 'ground' in lcname):
            Ry = Ry * 2
        Rx = getattr(self, 'Rs', None)
        return (None if Ry is None else config.host_float(Ry),
                None if Rx is None else config.host_float(Rx))


def _tangent_point(dz_fn, tMax, ray, good):
    """The t of each ray's tangent point on the surface of *dz_fn*: the
    root of d dz / dt along the ray (*ray* = x, y, z, a, b, c) in
    [0, tMax], by the same search."""
    x, y, z, a, b, c = ray

    def ddz_fn(xx, yy, zz):
        def g(t):
            return dz_fn(xx + a * t, yy + b * t, zz + c * t)
        zero = torch.zeros_like(xx)
        return torch.func.jvp(g, (zero,), (torch.ones_like(xx),))[1]
    with torch.no_grad():
        return find_intersection_dz(ddz_fn, torch.zeros_like(tMax), tMax,
                                    *ray, active=good)[0]


def _uniform_draw(rng, draws, name, like):
    """*draws[name]*, or uniforms in [0, 1) from the generator that *rng*
    gives (:func:`_stream`), one a ray."""
    if name in draws:
        return draws[name]
    return _draw(torch.rand, rng(), like.shape[0], like.dtype, like.device)


def _move(lb, mask, dist):
    """The rays of *mask* moved by *dist* along their directions."""
    return lb.replace(**{k: torch.where(mask, getattr(lb, k) +
                                        getattr(lb, d) * dist,
                                        getattr(lb, k))
                         for k, d in zip('xyz', 'abc')})


def _shift(lb, dx, dy, dz, sign):
    """*lb* moved by sign * (dx, dy, dz); None components stay."""
    upd = {k: getattr(lb, k) + sign * v
           for k, v in zip('xyz', (dx, dy, dz)) if v is not None}
    return lb.replace(**upd) if upd else lb
