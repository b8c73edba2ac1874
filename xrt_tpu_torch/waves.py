"""Fresnel-Kirchhoff wave propagation between optical elements.

Port of the reference package's ``waves.py``: the receiving-surface
samplers (``prepare_wave_on_{screen,aperture,oe}``), the Kirchhoff
integral dispatch (:func:`diffract`), the direction extraction by the
conjugate-phase trick, the flux normalization and the re-rotation into a
receiving OE's frame, plus :func:`reflect_wave` and
:func:`rescale_field` for multi-hop chains.

Receiving geometry is computed in host float64 (numpy): global coordinates
are O(1e4) mm, and f32 rounding there would be hundreds of wavelengths of
per-sample phase noise.  For float32 runs the f64 residuals of the
receiving points travel in ``*Diffr_lo`` to the double-float Kirchhoff
kernels (:mod:`xrt_tpu_torch.ops.kirchhoff`); float64 runs use the plain
:func:`kirchhoff_integral_xla`.

Gradients.  :func:`diffract`, :func:`reflect_wave` and
:func:`rescale_field` are differentiable tensor code: with respect to the
source field, to the receiving coordinates ``*Diffr`` (shift them by a
tensor), to the source surface coordinates and to tensor placement angles
and radii of the elements.  The host placement transforms stay float64
numpy and read detached values, so the gradient with respect to a
placement angle comes through linearized retargeting: a host
finite-difference Jacobian of the exact transforms
(:func:`_placement_jacobian`) times the angle offset, added to the
receiving coordinates.

Blockwise tiling (``diffract(tile_modes=...)``, modes from
:func:`choose_tile_modes`) runs each (destination tile, source tile) pair
of a float32 stage through the kernel mode chosen for it.

The one-call hops (:func:`propagate_wave_to_oe`,
:func:`expose_wave_on_screen`, :func:`propagate_wave_to_aperture`; the
methods ``OE.propagate_wave``, ``Screen.expose_wave`` and
``propagate_wave`` of the apertures) sample the receiver, fill it from the
incoming wave (a synchrotron source shines its filament field there) and,
onto an OE, reflect at the samples.  Not in this module yet:
``diffract(mesh=...)`` (multi-device), which raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from . import config
from .beam import Beam, rotate_coherency_matrix
from .physconsts import CH, CHBAR, PI
from .ops.dd import sqrt_rn
from .transforms import cos, rotate_xyz, rotate_y, sin

Tensor = torch.Tensor
SRC_CHUNK = 256   # source samples per step of the float64 plain path

_MESH_TODO = ('multi-device diffract / WaveChain (mesh=...) is not ported '
              'yet: ROADMAP A10')


def pad1d_edge(v, npad):
    """Pad a 1-D tensor by repeating its last element (position arrays:
    zero padding would drag the recentring reference points)."""
    if not npad:
        return v
    return torch.cat([v, v[-1:].expand(npad)])


def pad1d_zero(v, npad):
    """Zero-pad a 1-D tensor (fields/weights contribute nothing)."""
    if not npad:
        return v
    return torch.cat([v, torch.zeros((npad,), dtype=v.dtype,
                                     device=v.device)])


@dataclass
class Wave(Beam):
    """A Beam that also carries the receiving-sample geometry and the
    accumulators of repeated diffraction passes."""
    xDiffr: Optional[Tensor] = None   # receiving points, fromOE-local
    yDiffr: Optional[Tensor] = None
    zDiffr: Optional[Tensor] = None
    rDiffr: Optional[Tensor] = None
    # f64 residuals of the receiving points for float32 runs
    xDiffr_lo: Optional[Tensor] = None
    yDiffr_lo: Optional[Tensor] = None
    zDiffr_lo: Optional[Tensor] = None
    EsAcc: Optional[Tensor] = None
    EpAcc: Optional[Tensor] = None
    aEacc: Optional[Tensor] = None
    bEacc: Optional[Tensor] = None
    cEacc: Optional[Tensor] = None
    areaNormal: Optional[Tensor] = None
    # after a diffract onto an OE receiver the wave carries toOE-local
    # directions and fields; the *Glo fields keep the global-frame ones
    aGlo: Optional[Tensor] = None
    bGlo: Optional[Tensor] = None
    cGlo: Optional[Tensor] = None
    EsGlo: Optional[Tensor] = None
    EpGlo: Optional[Tensor] = None
    JssGlo: Optional[Tensor] = None
    JppGlo: Optional[Tensor] = None
    JspGlo: Optional[Tensor] = None
    beamReflRays: Optional[Tensor] = None
    beamReflSumJ: Optional[Tensor] = None
    beamReflSumJnl: Optional[Tensor] = None
    diffract_repeats: Optional[Tensor] = None
    fromOE: Any = None
    toOE: Any = None


_BEAM_FIELDS = tuple(f.name for f in dataclasses.fields(Beam))


def _is_oe(el):
    return hasattr(el, 'rotationSequence')


def _np_rotate_xyz(x, y, z, rotationSequence='RzRyRx', pitch=0.0, roll=0.0,
                   yaw=0.0):
    """float64 numpy rotation (the host geometry path)."""
    seq = rotationSequence
    if seq[0] == '-':
        letters = (seq[6], seq[4], seq[2])
    else:
        letters = (seq[1], seq[3], seq[5])
    angles = {'z': float(yaw), 'y': float(roll), 'x': float(pitch)}
    for s in letters:
        cA, sA = math.cos(angles[s]), math.sin(angles[s])
        if s == 'x':
            y, z = cA * y - sA * z, sA * y + cA * z
        elif s == 'y':
            x, z = cA * x + sA * z, -sA * x + cA * z
        else:
            x, y = cA * x - sA * y, sA * x + cA * y
    return x, y, z


def _to_fromOE_local64(fromOE, x64, y64, z64):
    """Global points -> fromOE-local coordinates, float64 numpy (an OE's
    placement rotations, a screen/aperture frame, or a source's centred
    global frame)."""
    c = _center64(fromOE)
    x = np.asarray(x64, np.float64) - c[0]
    y = np.asarray(y64, np.float64) - c[1]
    z = np.asarray(z64, np.float64) - c[2]
    if _is_oe(fromOE):
        pitch, roll, yaw = fromOE._placement()[0:3]
        x, y, z = _np_rotate_xyz(x, y, z, fromOE.rotationSequence,
                                 pitch=-float(pitch), roll=-float(roll),
                                 yaw=-float(yaw))
        if fromOE.extraPitch is not None:
            x, y, z = _np_rotate_xyz(
                x, y, z, fromOE.extraRotationSequence,
                pitch=-float(fromOE.extraPitch),
                roll=-float(fromOE.extraRoll),
                yaw=-float(fromOE.extraYaw))
    elif hasattr(fromOE, 'ex'):
        ex = np.asarray(fromOE.ex, np.float64)
        ez = np.asarray(fromOE.ez, np.float64)
        ey = np.cross(ez, ex)
        lx = x * ex[0] + y * ex[1] + z * ex[2]
        ly = x * ey[0] + y * ey[1] + z * ey[2]
        lz = x * ez[0] + y * ez[1] + z * ez[2]
        x, y, z = lx, ly, lz
    return x, y, z


def _np_local_to_global64(oe, x64, y64, z64):
    """float64 numpy forward transform (positions only) matching
    OE.local_to_global — the exact inverse of :func:`_to_fromOE_local64`.
    The f32 local surface coordinates are exact inputs to it."""
    x64 = np.asarray(x64, np.float64)
    y64 = np.asarray(y64, np.float64)
    z64 = np.asarray(z64, np.float64)
    pitch, roll, yaw = (float(v) for v in oe._placement()[0:3])
    if oe.extraPitch is not None:
        x64, y64, z64 = _np_rotate_xyz(
            x64, y64, z64, '-' + oe.extraRotationSequence,
            pitch=float(oe.extraPitch), roll=float(oe.extraRoll),
            yaw=float(oe.extraYaw))
    x64, y64, z64 = _np_rotate_xyz(x64, y64, z64, '-' + oe.rotationSequence,
                                   pitch=pitch, roll=roll, yaw=yaw)
    c = _center64(oe)
    return x64 + c[0], y64 + c[1], z64 + c[2]


def _center64(el) -> np.ndarray:
    """The element's centre as host float64 (detached where a component is
    a tensor)."""
    return np.array([config.host_float(c) for c in el.center], np.float64)


def _frame_to_global64(el, x, y, z):
    """float64 numpy global coordinates of points given in the frame of a
    screen or an aperture."""
    c = _center64(el)
    ex = np.asarray(el.ex, np.float64)
    ez = np.asarray(el.ez, np.float64)
    ey = np.cross(ez, ex)
    return tuple(c[i] + x * ex[i] + y * ey[i] + z * ez[i] for i in range(3))


def _placement_jacobian(el, fromOE, x, y, z, param='pitch', h=1e-7,
                        vary='el'):
    """d(receiving coordinates in the *fromOE* frame) / d(*param*), (3, N)
    float64, for samples (x, y, z) in the local frame of *el*: a central
    finite difference of the exact host float64 placement transforms.
    *vary* 'el' moves the receiving element, 'from' the element the
    coordinates are referred to.  Adding ``J * dp`` to a wave's ``*Diffr``
    retargets it to first order in the offset ``dp`` (alignment-scale
    angles) and keeps the double-float phase coherence of the prepared
    geometry."""
    x, y, z = (np.asarray(v, np.float64) for v in (x, y, z))

    def pos(el_, from_):
        if _is_oe(el_):
            g = _np_local_to_global64(el_, x, y, z)
        else:
            g = _frame_to_global64(el_, x, y, z)
        return np.stack(_to_fromOE_local64(from_, *g))
    moved = el if vary == 'el' else fromOE
    p = config.host_float(getattr(moved, param))
    hi, lo = moved.replace(**{param: p + h}), moved.replace(**{param: p - h})
    if vary == 'el':
        return (pos(hi, fromOE) - pos(lo, fromOE)) / (2 * h)
    return (pos(el, hi) - pos(el, lo)) / (2 * h)


def wave_frame_rotation(oe, fromOE) -> np.ndarray:
    """(3, 3) float64 rotation mapping a displacement of a receiving sample
    in *oe*'s local frame into the *fromOE*-local frame in which
    :func:`prepare_wave` stores the receiving coordinates."""
    pts = np.concatenate([np.zeros((1, 3)), np.eye(3)], axis=0)
    gx, gy, gz = _np_local_to_global64(oe, pts[:, 0], pts[:, 1], pts[:, 2])
    lx, ly, lz = _to_fromOE_local64(fromOE, gx, gy, gz)
    P = np.stack([lx, ly, lz])
    return P[:, 1:] - P[:, :1]


def _host64(v):
    """A writable float64 numpy copy of *v* (tensor or array-like)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to('cpu', torch.float64).numpy().copy()
    return np.array(v, np.float64)


def prepare_wave(fromOE, wave: Wave, xglo, yglo, zglo) -> Wave:
    """Attach the receiving geometry to *wave*: the global receiving
    points are taken to the fromOE-local frame in float64 on the host and,
    for float32 waves, the f64 residuals are kept in ``*Diffr_lo``."""
    dt = wave.x.dtype
    dev = wave.x.device
    x64, y64, z64 = _to_fromOE_local64(fromOE, _host64(xglo),
                                       _host64(yglo), _host64(zglo))
    r64 = np.sqrt(x64 ** 2 + y64 ** 2 + z64 ** 2)

    def T(v):
        return torch.as_tensor(v, dtype=dt, device=dev)
    x, y, z, r = T(x64), T(y64), T(z64), T(r64)
    los = {}
    if dt == torch.float32:
        from .ops import dd as _dd
        los = dict(xDiffr_lo=T(_dd.from_f64(x64)[1]),
                   yDiffr_lo=T(_dd.from_f64(y64)[1]),
                   zDiffr_lo=T(_dd.from_f64(z64)[1]))
    cdt = config.cdtype(dt)
    zero_c = torch.zeros_like(x, dtype=cdt)
    zero = torch.zeros_like(x)
    zs = torch.zeros((), dtype=dt, device=dev)
    return wave.replace(
        xDiffr=x, yDiffr=y, zDiffr=z, rDiffr=r,
        a=T(x64 / r64), b=T(y64 / r64), c=T(z64 / r64),
        path=torch.zeros_like(x), Es=zero_c, Ep=zero_c,
        EsAcc=zero_c, EpAcc=zero_c, aEacc=zero_c, bEacc=zero_c,
        cEacc=zero_c, Jss=zero, Jpp=zero, Jsp=zero_c,
        beamReflRays=zs, beamReflSumJ=zs, beamReflSumJnl=zs,
        diffract_repeats=zs, fromOE=fromOE, **los)


def _blank_wave(nrays, dt, dev, **kw):
    z = torch.zeros((nrays,), dtype=dt, device=dev)
    return Wave(x=kw.pop('x', z), y=kw.pop('y', z), z=kw.pop('z', z),
                a=z, b=torch.ones((nrays,), dtype=dt, device=dev), c=z,
                E=torch.full((nrays,), config.DEFAULT_ENERGY, dtype=dt,
                             device=dev),
                state=torch.ones((nrays,), dtype=torch.int32, device=dev),
                path=z, Jss=z, Jpp=z,
                Jsp=torch.zeros((nrays,), dtype=config.cdtype(dt),
                                device=dev), **kw)


# ---------------------------------------------------------------------------
# receiving-surface samplers
# ---------------------------------------------------------------------------

def prepare_wave_on_screen(screen, prevOE, dim1, dim2, dy=0.0,
                           condition=None, dtype=None, device=None) -> Wave:
    """Pixel-grid wave samples on a flat screen."""
    dt = config.resolve_dtype(dtype)
    dev = config.resolve_device(device)
    dim1 = np.asarray(dim1, float)
    dim2 = np.asarray(dim2, float)
    d1s, d2s = np.meshgrid(dim1, dim2)
    d1s = d1s.flatten()
    d2s = d2s.flatten()
    dS = (dim1[1] - dim1[0]) * (dim2[1] - dim2[0]) \
        if dim1.size > 1 and dim2.size > 1 else 1.0
    if condition is not None:
        d1s, d2s = condition(d1s, d2s)
    nrays = len(d1s)
    xloc, yloc, zloc = d1s, np.zeros_like(d1s) + dy, d2s
    xglo, yglo, zglo = _frame_to_global64(screen, xloc, yloc, zloc)

    def T(v):
        return torch.as_tensor(v, dtype=dt, device=dev)
    dS_arr = T(np.full((nrays,), dS))
    wave = _blank_wave(nrays, dt, dev, x=T(xloc), y=T(np.zeros_like(d1s)),
                       z=T(zloc), dS=dS_arr, area=torch.sum(dS_arr),
                       toOE=screen)
    return prepare_wave(prevOE, wave, xglo, yglo, zglo)


def _uniform64(generator, n):
    """n float64 uniforms in [0, 1) from *generator* (drawn on the CPU in
    float64, so one seed gives the same samples on any device and dtype)."""
    return torch.rand(n, generator=generator, dtype=torch.float64).numpy()


def prepare_wave_on_aperture(aperture, prevOE, nrays, generator=None,
                             samples=None, dtype=None,
                             device=None) -> Wave:
    """Uniform random wave samples in an aperture opening.

    *generator*: a ``torch.Generator`` (seed 0 if None).  *samples*:
    optional (x, z) local sample coordinates replacing the random draw
    (parity runs feed another implementation's receiver samples)."""
    from .apertures import RoundAperture
    dt = config.resolve_dtype(dtype)
    dev = config.resolve_device(device)
    if not isinstance(aperture, RoundAperture):
        left, right, bottom, top = (config.host_float(v)
                                    for v in aperture.opening)
    if samples is not None:
        x64 = _host64(samples[0])
        z64 = _host64(samples[1])
        nrays = len(x64)
        if isinstance(aperture, RoundAperture):
            area = math.pi * config.host_float(aperture.r) ** 2
        else:
            area = (right - left) * (top - bottom)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        nrays = int(nrays)
        u1 = _uniform64(generator, nrays)
        u2 = _uniform64(generator, nrays)
        if isinstance(aperture, RoundAperture):
            r = np.sqrt(u1) * config.host_float(aperture.r)
            phi = u2 * 2 * math.pi
            x64, z64 = r * np.cos(phi), r * np.sin(phi)
            area = math.pi * config.host_float(aperture.r) ** 2
        else:
            dX = right - left
            dZ = top - bottom
            x64 = u1 * dX + left
            z64 = u2 * dZ + bottom
            area = dX * dZ
    x = torch.as_tensor(x64, dtype=dt, device=dev)
    z = torch.as_tensor(z64, dtype=dt, device=dev)
    # global sample coordinates in float64 from the exact f32/f64 locals
    xl, zl = _host64(x), _host64(z)
    xglo, yglo, zglo = _frame_to_global64(aperture, xl, np.zeros_like(xl),
                                          zl)
    area_t = torch.as_tensor(area, dtype=dt, device=dev)
    wave = _blank_wave(nrays, dt, dev, x=x, z=z,
                       dS=torch.full((nrays,), 1.0, dtype=dt, device=dev) *
                       area_t / nrays, area=area_t, toOE=aperture)
    return prepare_wave(prevOE, wave, xglo, yglo, zglo)


def _prev_center(prevOE, dt, dev):
    """The point the incoming directions come from: the previous OE's
    surface-limit centre on its surface, or the previous element's
    centre."""
    if _is_oe(prevOE):
        from .beam import new_beam
        cx = 0.5 * (prevOE.limPhysX[0] + prevOE.limPhysX[1])
        cy = 0.5 * (prevOE.limPhysY[0] + prevOE.limPhysY[1])
        cxa = torch.tensor([cx], dtype=dt, device=dev)
        cya = torch.tensor([cy], dtype=dt, device=dev)
        if prevOE.isParametric:
            s0, phi0, _ = prevOE.xyz_to_param(cxa, cya, torch.zeros_like(cxa))
            cza = prevOE.param_to_xyz(s0, phi0, prevOE.local_r(s0, phi0))[2]
        else:
            cza = prevOE.local_z(cxa, cya)
        lbc = new_beam(1, dtype=dt, device=dev).replace(x=cxa, y=cya, z=cza)
        lbc = prevOE.local_to_global(lbc)
        return (lbc.x[0], lbc.y[0], lbc.z[0])
    return tuple(torch.as_tensor(v, dtype=dt, device=dev)
                 for v in prevOE.center)


def prepare_wave_on_oe(oe, prevOE, nrays, generator=None, sort=None,
                       samples=None, dtype=None, device=None) -> Wave:
    """Wave samples on an OE surface: random (int *nrays*) or a mesh
    ((nx, ny) tuple) in the physical limits, placed on the surface
    z = local_z(x, y).

    *samples*: explicit (x, y[, z]) surface coordinates; the optional
    third member pins the surface z (float32 runs would otherwise
    re-derive it with cancellation, e.g. a toroid's r - sqrt(r^2 - x^2)).
    *sort='y'* orders random samples along y.

    The samples are on the surface by construction, so no ray is landed
    on it: the reference package traces rays from the previous element
    with its intersection solver, which returns the same points to the
    solver's tolerance."""
    from .beam import new_beam
    dt = config.resolve_dtype(dtype)
    dev = config.resolve_device(device)

    def T(v):
        return torch.as_tensor(v, dtype=dt, device=dev)
    z_given = None
    if samples is not None:
        x, y = T(_host64(samples[0])), T(_host64(samples[1]))
        if len(samples) > 2:
            z_given = T(_host64(samples[2]))
    elif isinstance(nrays, (tuple, list)):
        if isinstance(nrays[0], np.ndarray):
            xx, yy = np.asarray(nrays[0]), np.asarray(nrays[1])
        else:
            xx = np.linspace(float(oe.limPhysX[0]), float(oe.limPhysX[1]),
                             int(nrays[0]))
            yy = np.linspace(float(oe.limPhysY[0]), float(oe.limPhysY[1]),
                             int(nrays[1]))
        X, Y = np.meshgrid(xx, yy)
        x, y = T(X.ravel()), T(Y.ravel())
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        n = int(nrays)
        dX = oe.limPhysX[1] - oe.limPhysX[0]
        dY = oe.limPhysY[1] - oe.limPhysY[0]
        x64 = _uniform64(generator, n) * dX + oe.limPhysX[0]
        y64 = _uniform64(generator, n) * dY + oe.limPhysY[0]
        if sort == 'y':
            order = np.argsort(y64, kind='stable')
            x64, y64 = x64[order], y64[order]
        x, y = T(x64), T(y64)
    nsamples = x.shape[0]
    area0 = (oe.limPhysX[1] - oe.limPhysX[0]) * \
        (oe.limPhysY[1] - oe.limPhysY[0])
    s = phi = None
    if z_given is not None:
        z = z_given
        if oe.isParametric:
            s, phi, _ = oe.xyz_to_param(x, y, z)
    elif oe.isParametric:
        # the z = 0 projection lands ~1e-4 mm off a tilted parametric
        # surface, enough to scramble grazing-incidence phases; two more
        # re-projections from the surface z converge to ~nm
        z = torch.zeros_like(x)
        for _ in range(3):
            s, phi, _ = oe.xyz_to_param(x, y, z)
            z = oe.param_to_xyz(s, phi, oe.local_r(s, phi))[2]
    else:
        z = oe.local_z(x, y)

    # surface-normal projection factor: |cos| between the incoming central
    # direction and the global surface normal at the OE origin
    prevCenter = _prev_center(prevOE, dt, dev)
    one = torch.ones(1, dtype=dt, device=dev)
    zero1 = torch.zeros(1, dtype=dt, device=dev)
    lbn = oe.local_to_global(new_beam(1, dtype=dt, device=dev).replace(
        b=zero1, c=one))
    an = lbn.x - prevCenter[0]
    bn = lbn.y - prevCenter[1]
    cn = lbn.z - prevCenter[2]
    nrm = torch.sqrt(an ** 2 + bn ** 2 + cn ** 2)
    areaNormalFact = torch.abs(
        (an * lbn.a[0] + bn * lbn.b[0] + cn * lbn.c[0]) / nrm)[0]

    st = oe.rays_good(x, y, torch.ones((nsamples,), dtype=torch.int32,
                                       device=dev))
    good = (st == 1) | (st == 2)
    area = area0 * torch.mean(good.to(dt))
    ngood = torch.clamp(torch.sum(good), min=1)
    wave = _blank_wave(nsamples, dt, dev, x=x, y=y, z=z, s=s, phi=phi)
    wave = wave.replace(Jss=torch.ones_like(x), area=area,
                        areaNormal=area * areaNormalFact,
                        dS=torch.ones((nsamples,), dtype=dt, device=dev) *
                        area / ngood,
                        state=torch.where(good, 1, 0).to(torch.int32),
                        toOE=oe)
    gx, gy, gz = _np_local_to_global64(oe, _host64(x), _host64(y),
                                       _host64(z))
    return prepare_wave(prevOE, wave, gx, gy, gz)


# ---------------------------------------------------------------------------
# the Kirchhoff integral
# ---------------------------------------------------------------------------

def kirchhoff_integral_xla(xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl,
                           weights):
    """The five Kirchhoff accumulators by a chunked loop over source
    samples, in the tensors' own (float64) precision — the counterpart of
    the reference package's XLA path; no kernel (the k*r phase needs
    float64).  dst tensors (Nd,), src tensors (Ns,); *weights* masks dead
    source samples (0/1).

    While autograd records, each chunk runs under
    ``torch.utils.checkpoint``: the tape keeps the five (Nd,) chunk sums
    and recomputes the (Nd, chunk) intermediates of one chunk at a time in
    the backward pass, instead of holding those of every chunk (O(Nd x Ns)
    complex values, several times over).  This path is the float64 truth
    the float32 gradients are held to, at sizes where the plain tape would
    not fit."""
    Ns = xs.shape[0]
    npad = (-Ns) % SRC_CHUNK
    n = [torch.broadcast_to(torch.as_tensor(ni, dtype=xs.dtype,
                                            device=xs.device), (Ns,))
         for ni in n]
    if npad:
        xs, ys, zs, k, nl, weights, Es, Ep = (
            pad1d_zero(v, npad) for v in (xs, ys, zs, k, nl, weights, Es,
                                          Ep))
        n = [pad1d_zero(ni, npad) for ni in n]
    cdt = Es.dtype
    acc = [torch.zeros(xd.shape, dtype=cdt, device=xd.device)
           for _ in range(5)]
    def chunk_sums(xs_, ys_, zs_, Esc, Epc, kk, n0, n1, n2, nl_, w_):
        a = xd[:, None] - xs_[None]
        b = yd[:, None] - ys_[None]
        c = zd[:, None] - zs_[None]
        pathAfter = sqrt_rn(a ** 2 + b ** 2 + c ** 2)
        ns = (a * n0[None] + b * n1[None] + c * n2[None]) / pathAfter
        kk, Esc, Epc = kk[None], Esc[None], Epc[None]
        U = kk * 1j / (4 * PI) * (nl_[None] + ns) * \
            torch.exp(1j * kk * pathAfter) / pathAfter * w_[None]
        abcU = kk ** 2 / (4 * PI) * (Esc + Epc) * U / pathAfter
        return (torch.sum(Esc * U, dim=1), torch.sum(Epc * U, dim=1),
                torch.sum(abcU * a, dim=1), torch.sum(abcU * b, dim=1),
                torch.sum(abcU * c, dim=1))
    for j in range(0, Ns + npad, SRC_CHUNK):
        sl = slice(j, j + SRC_CHUNK)
        args = (xs[sl], ys[sl], zs[sl], Es[sl], Ep[sl], k[sl], n[0][sl],
                n[1][sl], n[2][sl], nl[sl], weights[sl])
        if torch.is_grad_enabled():
            part = torch.utils.checkpoint.checkpoint(
                chunk_sums, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            part = chunk_sums(*args)
        acc = [a_ + p_ for a_, p_ in zip(acc, part)]
    return tuple(acc)


def estimate_footprint_area(x, y, good):
    """Convex-hull area of the beam footprint (host helper); pass the
    result via ``beam.replace(area=...)``."""
    from scipy.spatial import ConvexHull
    g = np.asarray(_host64(good), bool)
    pts = np.vstack([_host64(x)[g], _host64(y)[g]]).T
    hull = ConvexHull(pts)
    outer = pts[hull.vertices, :]
    x1, y1 = outer[:, 0], outer[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    return 0.5 * abs(np.sum(x1 * y2 - x2 * y1))


#: 1e7 / CHBAR as a double-float constant (k [1/mm] = E [eV] * KC)
_KC = 1e7 / CHBAR
_KC_HI = np.float32(_KC)
_KC_LO = np.float32(_KC - np.float64(_KC_HI))


def _surface_terms(oeLocal, wave):
    """(good, weights, surface normal n, n . direction) of the source
    samples of a Kirchhoff stage."""
    good = oeLocal.state == 1
    w = good.to(wave.xDiffr.dtype)
    oe = wave.fromOE
    if _is_oe(oe) and oe.isParametric and oeLocal.s is not None:
        n = oe.local_n(oeLocal.s, oeLocal.phi)[-3:]
    elif _is_oe(oe):
        n = oe.local_n(oeLocal.x, oeLocal.y)[-3:]
    else:
        n = [torch.zeros_like(oeLocal.x), torch.ones_like(oeLocal.x),
             torch.zeros_like(oeLocal.x)]
    nl = oeLocal.a * n[0] + oeLocal.b * n[1] + oeLocal.c * n[2]
    return good, w, n, nl


def kirchhoff_kernel_args(oeLocal, wave):
    """The positional arguments of :func:`~xrt_tpu_torch.ops.kirchhoff.
    kirchhoff_integral_kernel` for a float32 stage oeLocal -> wave: dd
    (hi, lo) receiving points and source points, fields, k as a
    double-float from E (1e7/CHBAR as a two-part constant), the surface
    normal, n . direction and the weights."""
    from .ops import dd as _dd
    _, w, n, nl = _surface_terms(oeLocal, wave)
    kh, kl = _dd.two_prod(oeLocal.E, torch.full_like(oeLocal.E,
                                                     float(_KC_HI)))
    kl = kl + oeLocal.E * float(_KC_LO)
    zero = torch.zeros_like(wave.xDiffr)
    src_zero = torch.zeros_like(oeLocal.x)

    def lo(v, z):
        return z if v is None else v
    dst_t = [(wave.xDiffr, lo(wave.xDiffr_lo, zero)),
             (wave.yDiffr, lo(wave.yDiffr_lo, zero)),
             (wave.zDiffr, lo(wave.zDiffr_lo, zero))]
    src_t = [(oeLocal.x, src_zero), (oeLocal.y, src_zero),
             (oeLocal.z, src_zero)]
    return (*dst_t, *src_t, oeLocal.Es, oeLocal.Ep, (kh, kl), n, nl, w)


def diffract(oeLocal: Beam, wave: Wave, phase_mode='recentred',
             monochromatic=False, accumulate='mxu', tile_modes=None,
             mesh=None, narrowband='auto', check_envelope=True) -> Wave:
    """Diffract the surface field *oeLocal* onto the receiving *wave*
    samples; returns the updated wave (accumulating over repeated calls
    through the Acc fields).

    float32 waves go through :func:`~xrt_tpu_torch.ops.kirchhoff.
    kirchhoff_integral_kernel` (the CUDA kernels on the card) with
    *phase_mode* 'recentred' (default), 'fast' or 'exact'; *accumulate*,
    *narrowband* and *check_envelope* are passed on to it.  float64 waves
    use the plain :func:`kirchhoff_integral_xla`.  *oeLocal.area* should
    be set (else a bounding-box estimate is used).

    *tile_modes* (from :func:`choose_tile_modes`; the samples of both
    clouds sorted along the beam, ``sort='y'``): blockwise evaluation of a
    float32 stage, each (destination tile, source tile) pair with its own
    (phase_mode, accumulate), overriding the stage's; see
    :func:`_tiled_integral`.  A float64 wave ignores it (its plain path is
    exact at any geometry).  *mesh* is not ported yet and raises
    ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    oe = wave.fromOE
    good, w, n, nl = _surface_terms(oeLocal, wave)
    if oeLocal.area is not None:
        area = oeLocal.area
    else:
        secondDim = oeLocal.y if _is_oe(oe) else oeLocal.z
        big = 1e30
        area = (torch.max(torch.where(good, oeLocal.x, -big)) -
                torch.min(torch.where(good, oeLocal.x, big))) * \
            (torch.max(torch.where(good, secondDim, -big)) -
             torch.min(torch.where(good, secondDim, big)))
    sumJ = torch.sum((oeLocal.Jss + oeLocal.Jpp) * w)
    sumJnl = torch.abs(torch.sum((oeLocal.Jss + oeLocal.Jpp) * nl * w))

    if wave.xDiffr.dtype == torch.float32:
        from .ops.kirchhoff import kirchhoff_integral_kernel
        args = kirchhoff_kernel_args(oeLocal, wave)
        if tile_modes is not None:
            # 'auto' resolves to False, as under the reference's jit: its
            # error bound would be one more host read per tile pair
            Es, Ep, aE, bE, cE = _tiled_integral(
                args, tile_modes, monochromatic,
                False if narrowband == 'auto' else narrowband)
        else:
            Es, Ep, aE, bE, cE = kirchhoff_integral_kernel(
                *args, phase_mode=phase_mode, monochromatic=monochromatic,
                accumulate=accumulate, narrowband=narrowband,
                check_envelope=check_envelope)
    else:
        k = oeLocal.E / CHBAR * 1e7  # 1/mm
        Es, Ep, aE, bE, cE = kirchhoff_integral_xla(
            wave.xDiffr, wave.yDiffr, wave.zDiffr,
            oeLocal.x, oeLocal.y, oeLocal.z, oeLocal.Es, oeLocal.Ep, k,
            n, nl, w)

    EsAcc = wave.EsAcc + Es
    EpAcc = wave.EpAcc + Ep
    aEacc = wave.aEacc + aE
    bEacc = wave.bEacc + bE
    cEacc = wave.cEacc + cE
    beamReflRays = wave.beamReflRays + torch.sum(w)
    beamReflSumJ = wave.beamReflSumJ + sumJ
    beamReflSumJnl = wave.beamReflSumJnl + sumJnl
    repeats = wave.diffract_repeats + 1.0

    Jss = (EsAcc * torch.conj(EsAcc)).real
    Jpp = (EpAcc * torch.conj(EpAcc)).real
    Jsp = EsAcc * torch.conj(EpAcc)

    # directions from the conjugate-phase trick
    if _is_oe(oe):
        useC = torch.abs(cEacc[0]) > torch.abs(bEacc[0])
        toRealComp = torch.where(useC, cEacc, bEacc)
    else:
        toRealComp = bEacc
    ang = torch.angle(toRealComp)
    toReal = torch.complex(torch.cos(ang), -torch.sin(ang))
    a = (aEacc * toReal).real
    b = (bEacc * toReal).real
    c = (cEacc * toReal).real
    # rescale to O(1) before normalizing: the accumulators carry the field
    # scale, and their squares could overflow float32
    mag = torch.maximum(torch.maximum(torch.abs(a), torch.abs(b)),
                        torch.abs(c))
    maginv = torch.where(mag > 0, 1.0 / mag, torch.zeros_like(mag))
    a, b, c = a * maginv, b * maginv, c * maginv
    norm = torch.sqrt(a ** 2 + b ** 2 + c ** 2)
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    a, b, c = a / norm, b / norm, c / norm

    # flux normalization
    de = beamReflRays * beamReflSumJnl * repeats
    fnorm = torch.where(de > 0, wave.dS * area * beamReflSumJ / de,
                        torch.zeros_like(wave.dS))
    Jss = Jss * fnorm
    Jpp = Jpp * fnorm
    Jsp = Jsp * fnorm
    sq = torch.sqrt(fnorm)
    out = wave.replace(
        E=oeLocal.E[0].expand_as(wave.E).clone(),
        Es=EsAcc * sq, Ep=EpAcc * sq,
        Jss=Jss, Jpp=Jpp, Jsp=Jsp, a=a, b=b, c=c,
        EsAcc=EsAcc, EpAcc=EpAcc, aEacc=aEacc, bEacc=bEacc, cEacc=cEacc,
        beamReflRays=beamReflRays, beamReflSumJ=beamReflSumJ,
        beamReflSumJnl=beamReflSumJnl, diffract_repeats=repeats,
        accepted=oeLocal.accepted, acceptedE=oeLocal.acceptedE,
        seeded=oeLocal.seeded, seededI=oeLocal.seededI)

    toOE = wave.toOE
    if (toOE is None or not _is_oe(toOE)) and _is_oe(oe):
        # aperture/screen receiver fed by an OE: rotate the accumulators
        # from the fromOE's rolled s/p basis to the virgin/global basis
        rollAngle = oe.roll + getattr(oe, 'positionRoll', 0.0)
        if isinstance(rollAngle, torch.Tensor) or rollAngle != 0.0:
            cosY, sinY = cos(rollAngle), sin(rollAngle)
            EsR, EpR = rotate_y(out.Es, out.Ep, cosY, sinY)
            JssR, JppR, JspR = rotate_coherency_matrix(
                out.Jss, out.Jpp, out.Jsp, rollAngle)
            out = out.replace(Es=EsR, Ep=EpR, Jss=JssR, Jpp=JppR, Jsp=JspR)
    if toOE is not None and _is_oe(toOE):
        # the receiver is an OE: rotate into its frame and project the flux
        # onto the (generally grazing) surface; the *Glo fields keep the
        # global-frame beam that reflect() consumes next
        glo = wave_to_global(out)
        ones = torch.ones_like(out.xDiffr)
        if toOE.isParametric:
            nrm = toOE.local_n(*toOE.xyz_to_param(wave.x, wave.y,
                                                  wave.z)[:2])
        else:
            nrm = toOE.local_n(wave.x, wave.y)
        n1 = nrm[-3] * ones
        n2 = nrm[-2] * ones
        n3 = nrm[-1] * ones
        pitchT, rollT, yawT = toOE._placement()[0:3]
        rollAngle = rollT + torch.atan2(n1, n3)
        JssR, JppR, JspR = rotate_coherency_matrix(
            glo.Jss, glo.Jpp, glo.Jsp, -rollAngle)
        cosY, sinY = torch.cos(rollAngle), torch.sin(rollAngle)
        EsR, EpR = rotate_y(glo.Es, glo.Ep, cosY, -sinY)
        al, bl_, cl_ = rotate_xyz(
            glo.a, glo.b, glo.c, rotationSequence=toOE.rotationSequence,
            pitch=-pitchT, roll=-rollT, yaw=-yawT)
        if toOE.extraPitch is not None:
            al, bl_, cl_ = rotate_xyz(
                al, bl_, cl_, rotationSequence=toOE.extraRotationSequence,
                pitch=-toOE.extraPitch, roll=-toOE.extraRoll,
                yaw=-toOE.extraYaw)
        proj = torch.abs(al * n1 + bl_ * n2 + cl_ * n3)
        sqp = torch.sqrt(proj).to(glo.Es.dtype)
        out = out.replace(
            a=al, b=bl_, c=cl_,
            Es=EsR * sqp, Ep=EpR * sqp,
            Jss=JssR * proj, Jpp=JppR * proj, Jsp=JspR * proj,
            aGlo=glo.a, bGlo=glo.b, cGlo=glo.c,
            EsGlo=glo.Es * sqp, EpGlo=glo.Ep * sqp,
            JssGlo=glo.Jss * proj, JppGlo=glo.Jpp * proj,
            JspGlo=glo.Jsp * proj)
    return out


def wave_to_global(wave: Wave) -> Beam:
    """The diffracted beam with global positions of the receiving points.
    After a diffract onto an OE receiver, the stored *Glo fields give the
    global-frame directions and fields."""
    oe = wave.fromOE
    glo = Beam(**{f: getattr(wave, f) for f in _BEAM_FIELDS})
    xD, yD, zD = wave.xDiffr, wave.yDiffr, wave.zDiffr
    if wave.aGlo is not None:
        glo = glo.replace(a=wave.aGlo, b=wave.bGlo, c=wave.cGlo,
                          Es=wave.EsGlo, Ep=wave.EpGlo, Jss=wave.JssGlo,
                          Jpp=wave.JppGlo, Jsp=wave.JspGlo)
        from .beam import new_beam
        tmp = new_beam(xD.shape[0], dtype=xD.dtype,
                       device=xD.device).replace(x=xD, y=yD, z=zD)
        if _is_oe(oe):
            tmp = oe.local_to_global(tmp)
            return glo.replace(x=tmp.x, y=tmp.y, z=tmp.z)
        return glo.replace(x=_frame_to_global(oe, xD, yD, zD, 0),
                           y=_frame_to_global(oe, xD, yD, zD, 1),
                           z=_frame_to_global(oe, xD, yD, zD, 2))
    glo = glo.replace(x=xD, y=yD, z=zD)
    if _is_oe(oe):
        return oe.local_to_global(glo)
    return glo.replace(x=_frame_to_global(oe, xD, yD, zD, 0),
                       y=_frame_to_global(oe, xD, yD, zD, 1),
                       z=_frame_to_global(oe, xD, yD, zD, 2))


def _frame_to_global(el, x, y, z, i):
    """Component *i* of the global position of local (x, y, z) in the
    frame of a screen/aperture (or a source: centred global)."""
    if hasattr(el, 'ex'):
        ex, ey, ez = el.ex, el.ey, el.ez
        return el.center[i] + x * ex[i] + y * ey[i] + z * ez[i]
    return (x, y, z)[i] + el.center[i]


MXU_FAST_FIELD_ERR = 2e-3   # incoherent relative field error of the
                            # single-pass bf16 TPU accumulation


def choose_kirchhoff_mode(dst_xyz, src_xyz, k=None, error_budget=None):
    """(phase_mode, accumulate) for a Kirchhoff stage with the given
    concrete geometry (host, float64): checks the 1/A direction-series
    envelope and the transverse delta-series phase error of the
    recentred scheme, and falls back to the per-pair double-float 'fast'
    phase outside both.  *dst_xyz*, *src_xyz* in the same (source-local)
    frame.  *error_budget*: the relative field error the caller tolerates;
    when it covers :data:`MXU_FAST_FIELD_ERR`, 'mxu-fast' is chosen."""
    from .ops.kirchhoff import (recentred_series_e_max, SERIES_E_MAX,
                                SERIES_E2_MAX)
    d = np.stack([_host64(v) for v in dst_xyz])
    s = np.stack([_host64(v) for v in src_xyz])
    e = recentred_series_e_max((d[0],), (d[1],), (d[2],),
                               (s[0],), (s[1],), (s[2],))
    C = d.mean(axis=1) - s.mean(axis=1)
    R0 = float(np.sqrt(np.sum(C * C)))
    if R0 == 0.0:
        return 'fast', 'vpu'
    L = C / R0
    du = d - d.mean(axis=1)[:, None]
    sv = s - s.mean(axis=1)[:, None]
    tdu = du - L[:, None] * (L @ du)
    tsv = sv - L[:, None] * (L @ sv)
    tmax = float(np.max(np.linalg.norm(tdu, axis=0)) +
                 np.max(np.linalg.norm(tsv, axis=0)))
    Amin = R0 * max(1e-3, 1.0 - e)
    xmax = (tmax / Amin) ** 2
    kv = 1.42e6 if k is None else float(k)
    phase_err = kv * Amin * 0.027 * xmax ** 4
    if e > 0.25 or phase_err > 0.03:
        return 'fast', 'vpu'
    if e > SERIES_E_MAX:
        return 'recentred', 'vpu'
    fast_ok = error_budget is not None and \
        error_budget >= MXU_FAST_FIELD_ERR
    if e > SERIES_E2_MAX:
        return 'recentred', 'mxu-fast' if fast_ok else 'mxu'
    return 'recentred', 'mxu-fast' if fast_ok else 'mxu2'


def _tile_bounds(N, ntiles):
    """(tile_size, starts): uniform ceil-division tiling of range(N).  The
    last tile may extend past N: :func:`_tiled_integral` edge-pads the
    arrays to ntiles * tile_size, :func:`choose_tile_modes` clips it."""
    T = -(-N // ntiles)
    return T, [i * T for i in range(ntiles)]


def choose_tile_modes(dst_xyz, src_xyz, n_dst_tiles, n_src_tiles, k=None,
                      error_budget=None):
    """Per-tile-pair kernel modes for ``diffract(tile_modes=...)``: a
    (n_dst_tiles, n_src_tiles) nested list of (phase_mode, accumulate) from
    :func:`choose_kirchhoff_mode` on each pair of contiguous sample slices
    (host float64).  The samples must be sorted along the beam
    (``sort='y'``), so that slices are spatial tiles: a short stage whose
    whole geometry breaks the recentred envelopes then keeps them on most
    tile pairs, and only the pairs near contact run the per-pair 'fast'
    phase."""
    d = np.stack([_host64(v) for v in dst_xyz])
    s = np.stack([_host64(v) for v in src_xyz])
    Nd, Ns = d.shape[1], s.shape[1]
    Td, dstarts = _tile_bounds(Nd, n_dst_tiles)
    Ts, sstarts = _tile_bounds(Ns, n_src_tiles)
    modes = []
    for d0 in dstarts:
        dt_ = d[:, d0:min(d0 + Td, Nd)]
        row = []
        for s0 in sstarts:
            st_ = s[:, s0:min(s0 + Ts, Ns)]
            if dt_.shape[1] == 0 or st_.shape[1] == 0:
                # an empty clipped tile contributes nothing
                row.append(('recentred', 'mxu'))
            else:
                row.append(choose_kirchhoff_mode(tuple(dt_), tuple(st_), k,
                                                 error_budget=error_budget))
        modes.append(row)
    return modes


def tile_pair_args(args, tile_modes):
    """The tile pairs of a float32 stage, in the order they run: yields
    ((di, si), (phase_mode, accumulate), pair_args, dst_slice), where
    *pair_args* are the :func:`kirchhoff_kernel_args` of the pair.

    *args* are :func:`kirchhoff_kernel_args` of the whole stage.  The
    clouds are cut into ``len(tile_modes)`` x ``len(tile_modes[0])``
    uniform tiles (ceiling division); positions, k and the normals are
    edge-padded and the fields and weights zero-padded to whole tiles, so
    the padded samples add nothing but enter each tile's recentring means as
    the reference's do (zero positions would drag them toward the origin).
    The pairs are grouped by mode, the groups in sorted order."""
    xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, w = args
    ntd, nts = len(tile_modes), len(tile_modes[0])
    Nd, Ns = xd[0].shape[0], xs[0].shape[0]
    Td, _ = _tile_bounds(Nd, ntd)
    Ts, _ = _tile_bounds(Ns, nts)
    pad_d, pad_s = ntd * Td - Nd, nts * Ts - Ns
    dst = [tuple(pad1d_edge(v, pad_d) for v in hl) for hl in (xd, yd, zd)]
    src = [tuple(pad1d_edge(v, pad_s) for v in hl) for hl in (xs, ys, zs)]
    kp = tuple(pad1d_edge(v, pad_s) for v in k)
    n_p = [pad1d_edge(torch.broadcast_to(torch.as_tensor(
        ni, dtype=xs[0].dtype, device=xs[0].device), (Ns,)), pad_s)
        for ni in n]
    nlp = pad1d_edge(nl, pad_s)
    Esp, Epp, wp = (pad1d_zero(v, pad_s) for v in (Es, Ep, w))
    groups = {}
    for di in range(ntd):
        for si in range(nts):
            groups.setdefault(tuple(tile_modes[di][si]), []).append((di, si))
    for mode, pairs in sorted(groups.items()):
        for di, si in pairs:
            ds = slice(di * Td, (di + 1) * Td)
            ss = slice(si * Ts, (si + 1) * Ts)
            yield (di, si), mode, (
                *[(h[ds], l[ds]) for h, l in dst],
                *[(h[ss], l[ss]) for h, l in src], Esp[ss], Epp[ss],
                (kp[0][ss], kp[1][ss]), [ni[ss] for ni in n_p], nlp[ss],
                wp[ss]), ds


def _tiled_integral(args, tile_modes, monochromatic, narrowband):
    """The five accumulators of a float32 stage evaluated by tile pairs
    (:func:`tile_pair_args`): each pair one call of
    :func:`~xrt_tpu_torch.ops.kirchhoff.kirchhoff_integral_kernel` on
    slices (B1 or B2 on the card), added into its destination tile.  The
    modes were chosen on the host at build time, so no pair reads anything
    back: the envelope check is skipped."""
    from .ops.kirchhoff import kirchhoff_integral_kernel
    ntd = len(tile_modes)
    Nd = args[0][0].shape[0]
    acc = [[None] * 5 for _ in range(ntd)]
    for (di, _), (pm, am), pair, _ in tile_pair_args(args, tile_modes):
        out = kirchhoff_integral_kernel(
            *pair, phase_mode=pm, monochromatic=monochromatic,
            accumulate=am, narrowband=narrowband, check_envelope=False)
        acc[di] = [o if a is None else a + o for a, o in zip(acc[di], out)]
    return tuple(torch.cat([acc[di][i] for di in range(ntd)])[:Nd]
                 for i in range(5))


def tile_pairs_by_mode(tile_modes):
    """{(phase_mode, accumulate): number of tile pairs} of a tile map."""
    counts = {}
    for row in tile_modes:
        for m in row:
            counts[tuple(m)] = counts.get(tuple(m), 0) + 1
    return counts


def rescale_field(beam: Beam, target_rms=1.0):
    """(beam', log_scale): scale the field (Es, Ep and the coherency
    matrix) so that the RMS good-sample amplitude is *target_rms*.  Float32
    chains rescale between stages and undo the accumulated scale on the
    final result, J_true = J * exp(-2 * logs); diffract's flux
    normalization is scale-invariant, so the chain stays exact."""
    good = (beam.state == 1).to(beam.Jss.dtype)
    ng = torch.clamp(torch.sum(good), min=1.0)
    p2 = torch.abs(beam.Es) ** 2 + torch.abs(beam.Ep) ** 2
    rms = torch.sqrt(torch.sum(torch.where(good > 0, p2,
                                           torch.zeros_like(p2))) / ng)
    s = torch.where(rms > 0, target_rms / rms, torch.ones_like(rms))
    s = s.to(beam.Jss.dtype)
    sc = s.to(beam.Es.dtype)
    out = beam.replace(
        Es=beam.Es * sc, Ep=beam.Ep * sc,
        Jss=beam.Jss * s * s, Jpp=beam.Jpp * s * s,
        Jsp=beam.Jsp * (sc * sc))
    return out, torch.log(s)


def _shine_or_diffract(wave, waveOnSelf, generator=None, fixedEnergy=None,
                       **dkw):
    """Fill *waveOnSelf* from *wave*: a synchrotron source shines its
    filament field at *fixedEnergy* (else the energy of *wave*), an
    analytic source its field; anything else Kirchhoff-diffracts the
    surface field."""
    prevOE = waveOnSelf.fromOE
    if hasattr(prevOE, 'shine_wave'):
        E = fixedEnergy if fixedEnergy is not None else \
            float(wave.E[0]) if wave is not None else None
        return prevOE.shine_wave(generator, waveOnSelf, fixedEnergy=E)
    if hasattr(prevOE, 'shine') and not hasattr(prevOE, 'reflect'):
        return prevOE.shine(generator, waveOnSelf)
    return diffract(wave, waveOnSelf, **dkw)


def reflect_wave(oe, b, generator=None, **kwargs):
    """Reflect a diffracted wave at its receiving OE surface, keeping the
    receiver's exact local sample coordinates, and s/phi on a parametric
    surface (a round trip through f32 global coordinates would quantize
    them at ulp(|center|)).  Returns
    (beamGlobal, beamLocal) like ``oe.reflect``."""
    glo, loc = oe.reflect(wave_to_global(b), generator,
                          noIntersectionSearch=True,
                          surfacePoints=(b.x, b.y, b.z), **kwargs)
    loc = loc.replace(x=b.x, y=b.y, z=b.z)
    if b.s is not None:
        loc = loc.replace(s=b.s, phi=b.phi)
    return glo, loc


def qualify_sampling(wave: Wave, E, goodlen):
    """(Fresnel number, samples per Fresnel zone) of a receiving *wave*
    at energy *E* with *goodlen* good samples."""
    a = wave.xDiffr / wave.rDiffr
    c = wave.zDiffr / wave.rDiffr
    NAx = (torch.max(a) - torch.min(a)) * 0.5
    NAz = (torch.max(c) - torch.min(c)) * 0.5
    invLambda = E / CH * 1e7
    fn = (NAx ** 2 + NAz ** 2) * torch.mean(wave.rDiffr) * invLambda
    return fn, torch.abs(goodlen / fn)


def _hop_setup(wave, prevOE, dtype, device):
    """(prevOE, dtype, device) of a one-call hop: the element the incoming
    samples live on (*wave.toOE* unless given), and the incoming wave's
    dtype and device unless given."""
    if prevOE is None:
        prevOE = getattr(wave, 'toOE', None) if wave is not None else None
    if prevOE is None:
        raise ValueError('the incoming beam has no toOE (e.g. it came out '
                         'of reflect); pass prevOE= explicitly')
    if wave is not None:
        dtype = wave.x.dtype if dtype is None else dtype
        device = wave.x.device if device is None else device
    return prevOE, dtype, device


def _hop_nrays(wave, nrays):
    """The samples of a hop: as many as *wave* has for 'auto', else
    *nrays* (a number, or a mesh's (nx, ny))."""
    if isinstance(nrays, str):
        return wave.xDiffr.shape[0]
    return nrays if isinstance(nrays, (tuple, list)) else int(nrays)


def propagate_wave_to_oe(oe, wave, nrays='auto', generator=None,
                         fixedEnergy=None, prevOE=None, samples=None,
                         dtype=None, device=None, **dkw):
    """One-call wave hop onto an OE: samples its surface (*nrays* random
    samples, a mesh (nx, ny), 'auto' as many as *wave* has, or
    *samples*), diffracts the
    incoming *wave* onto them (or shines the filament field of a source
    parent at *fixedEnergy*, *wave* then may be None), and reflects at the
    samples without an intersection search.  *generator* draws the samples,
    then what the source or the material draws; *dkw* goes to
    :func:`diffract`.  Returns (beamGlobal, beamLocal) like reflect."""
    prevOE, dtype, device = _hop_setup(wave, prevOE, dtype, device)
    waveOnSelf = prepare_wave_on_oe(
        oe, prevOE, None if samples is not None else _hop_nrays(wave, nrays),
        generator=generator, samples=samples, dtype=dtype, device=device)
    waveOnSelf = _shine_or_diffract(wave, waveOnSelf, generator,
                                    fixedEnergy=fixedEnergy, **dkw)
    retGlo, retLoc = reflect_wave(oe, waveOnSelf, generator)
    if retLoc.area is None:
        retLoc = retLoc.replace(area=waveOnSelf.area)
    return retGlo, retLoc


def expose_wave_on_screen(screen, wave, dim1, dim2, generator=None,
                          fixedEnergy=None, prevOE=None, dtype=None,
                          device=None, **dkw):
    """One-call wave hop onto the pixel grid *dim1* x *dim2* of a screen.
    Returns the filled Wave."""
    prevOE, dtype, device = _hop_setup(wave, prevOE, dtype, device)
    waveOnSelf = prepare_wave_on_screen(screen, prevOE, dim1, dim2,
                                        dtype=dtype, device=device)
    return _shine_or_diffract(wave, waveOnSelf, generator,
                              fixedEnergy=fixedEnergy, **dkw)


def propagate_wave_to_aperture(aperture, wave, nrays='auto', generator=None,
                               fixedEnergy=None, prevOE=None, samples=None,
                               dtype=None, device=None, **dkw):
    """One-call wave hop onto samples inside an aperture's opening (drawn
    inside it, so nothing is masked).  Returns the filled Wave."""
    prevOE, dtype, device = _hop_setup(wave, prevOE, dtype, device)
    waveOnSelf = prepare_wave_on_aperture(
        aperture, prevOE,
        None if samples is not None else _hop_nrays(wave, nrays),
        generator=generator, samples=samples, dtype=dtype, device=device)
    return _shine_or_diffract(wave, waveOnSelf, generator,
                              fixedEnergy=fixedEnergy, **dkw)
