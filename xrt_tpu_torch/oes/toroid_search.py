"""The intersection search of the toroid crystals in one CUDA kernel.

``OE._reflect_local`` asks :func:`engages` whether an element's search can
go to ``csrc/toroid_search.cu`` and then calls :func:`search` in place of
``base.find_intersection_dz``.  The kernel runs the same solve, step for
step (``csrc/toroid_search.cuh``): both bracket ends, the Illinois loop,
the two Newton steps, one ray a thread in registers, with no host read,
no launch an iteration and no temporaries.  It implements two surfaces:
``JohannToroid.local_z`` (``JohannToroid``, ``JohanssonToroid``,
``GeneralBraggToroid``) and ``_DicedMethods.local_z`` with the facet
functions of ``DicedJohannToroid`` and ``DicedJohanssonToroid``.  Every
other element, a subclass that overrides one of these functions, a
replaced ``local_z=``, a figure error, radii given as tensors, a bounce
after the first (``isMulti``) and rays on the CPU keep
``find_intersection_dz``: its per-operation form serves any ``dz_fn`` and
autograd.

Gradients: when autograd would record (grad mode on and a ray tensor
that requires grad), the kernel returns the bracket's result t0 only and
the two Newton steps run on the tape through ``torch.func.jvp``, as
``find_intersection_dz`` takes them, so dt/dparams is unchanged.

While the profiler traces, the search is the span ``oes.search``; it
counts ``search.calls`` and ``search.fused`` (calls this kernel served),
and the kernel adds to a three-number device buffer, read once a call:
``search.iterations`` (the call's largest per-ray Illinois count, the
lockstep count of the loop it replaces), ``search.active`` (the sum of
the per-ray counts) and ``search.ray_evals`` (32 x each warp's largest
count, the lanes the warps run).  Tracing off, nothing is read.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from .. import config
from ..ops import _cuda
from ..profiler import count, is_tracing, stage
from . import base

#: kernel launches by dtype (``LAUNCHES.clear()`` before a run, read after)
LAUNCHES: collections.Counter = collections.Counter()

#: the surfaces of csrc/toroid_search.cuh (xts::Kind)
TOROID, DICED_JOHANN, DICED_JOHANSSON = 0, 1, 2

_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_double] * 11 +
             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_int] + [ctypes.c_void_p] * 5)


def surface_kind(oe):
    """The kernel's surface for *oe*'s own ``local_z``, or None: the
    functions it calls must be the ones the kernel implements."""
    from . import bragg

    def fn(name):
        return getattr(getattr(oe, name, None), '__func__', None)
    if fn('local_z_distorted') is not base.OE.local_z_distorted:
        return None
    if fn('local_z') is bragg.JohannToroid.local_z:
        return TOROID
    if (fn('local_z') is bragg._DicedMethods.local_z and
            fn('_facets') is bragg._DicedMethods._facets and
            fn('facet_center_z') is bragg.DicedJohannToroid.facet_center_z
            and fn('facet_center_n') in (
                bragg.DicedJohannToroid.facet_center_n,
                bragg.DicedJohanssonToroid.facet_center_n) and
            fn('local_n_toroid') is bragg.JohannToroid.local_n_toroid):
        delta = fn('facet_delta_z')
        if delta is bragg._DicedMethods.facet_delta_z:
            return DICED_JOHANN
        if delta is bragg.DicedJohanssonToroid.facet_delta_z:
            return DICED_JOHANSSON
    return None


def engages(oe, device, dtype, local_z=None, isMulti=False, inv=1):
    """Whether ``OE._reflect_local`` searches *oe* with the kernel: rays
    of float32 or float64 on a card, *oe*'s own surface of a kind the
    kernel implements (no ``local_z=`` from the caller, no figure error),
    its radii Python numbers, the sign *inv* of its search function a
    number, the first bounce (not *isMulti*) and no analytic
    intersection."""
    return (torch.device(device).type == 'cuda' and
            dtype in (torch.float32, torch.float64) and
            local_z is None and not isMulti and
            getattr(oe, 'figure_error', None) is None and
            not hasattr(oe, 'analytic_intersect') and
            isinstance(inv, (int, float)) and
            isinstance(getattr(oe, 'Rm', None), float) and
            isinstance(getattr(oe, 'Rs', None), float) and
            surface_kind(oe) is not None)


def _launch(args, device):
    """Launch the kernel with the C arguments *args* on *device*'s
    current stream."""
    _cuda.launch('toroid_search', 'toroid_search_launch', _ARGTYPES, device,
                 *args)


def _solve(oe, kind, rays, active, inv, newton):
    """One launch over the flattened rays: (t, [x2, y2, z2] or Nones,
    lost, good or None), shaped as the rays; *newton* False leaves t at
    the bracket's result and writes no points but ``good``.  While
    tracing, the kernel's counts are read and counted."""
    shape = rays[0].shape
    flat = [v.detach().reshape(-1).contiguous() for v in rays]
    act = active.reshape(-1).contiguous()
    n = act.numel()
    t = torch.empty_like(flat[0])
    pts = [torch.empty_like(t) for _ in range(3)] if newton else [None] * 3
    lost = torch.empty(n, dtype=torch.bool, device=t.device)
    good = None if newton else torch.empty_like(lost)
    counts = torch.zeros(3, dtype=torch.int64, device=t.device) \
        if is_tracing() else None

    def ptrs(vs):
        return (ctypes.c_void_p * len(vs))(
            *[None if v is None else v.data_ptr() for v in vs])
    ins, outs = ptrs(flat), ptrs([t] + pts)
    if n:
        _launch((int(t.dtype == torch.float64), kind,
                 int(t.device.type == 'cuda'),
                 config.MAX_INTERSECTION_ITERATIONS, oe.Rm, oe.Rs,
                 oe.Rm ** 2, oe.Rm - oe.Rs,
                 getattr(oe, 'dxFacet', 0.0), getattr(oe, 'dxGap', 0.0),
                 getattr(oe, 'dyFacet', 0.0), getattr(oe, 'dyGap', 0.0),
                 float(inv), base._z_eps(t.dtype), base._rel_eps(t.dtype),
                 ins, act.data_ptr(), n, int(newton), outs, lost.data_ptr(),
                 None if good is None else good.data_ptr(),
                 None if counts is None else counts.data_ptr()), t.device)
        LAUNCHES[f'toroid_search:{t.dtype}'] += 1
    if counts is not None:
        for name, v in zip(('search.iterations', 'search.active',
                            'search.ray_evals'), counts.tolist()):
            count(name, v)
    return (t.reshape(shape), [p if p is None else p.reshape(shape)
                               for p in pts], lost.reshape(shape),
            None if good is None else good.reshape(shape))


def search(oe, tMin, tMax, x, y, z, a, b, c, active, inv, dz_fn):
    """``find_intersection_dz(dz_fn, tMin, tMax, x, y, z, a, b, c,
    active)`` for an element :func:`engages` accepts, in one launch;
    *dz_fn* is the search function, for the Newton steps on the tape when
    autograd records.  Returns (t, x2, y2, z2, lost)."""
    kind = surface_kind(oe)
    rays = (x, y, z, a, b, c, tMin, tMax)
    if kind is None:
        raise ValueError(f'{type(oe).__name__}: no surface of the kernel')
    if any(v.shape != x.shape or v.dtype != x.dtype or v.device != x.device
           for v in rays) or active.shape != x.shape or \
            active.dtype != torch.bool:
        raise ValueError('the search kernel takes rays of one shape, dtype '
                         'and device and a bool active mask')
    grad = torch.is_grad_enabled() and any(v.requires_grad for v in rays)
    with stage('oes.search', device=x):
        count('search.calls')
        count('search.fused')
        t0, pts, lost, good = _solve(oe, kind, rays, active, inv, not grad)
        if not grad:
            return (t0, *pts, lost)
        # the Newton steps on the tape, as find_intersection_dz takes them

        def F(tt):
            return dz_fn(x + a * tt, y + b * tt, z + c * tt)
        t = t0
        for _ in range(2):
            Ft, dFt = torch.func.jvp(F, (t,), (torch.ones_like(t),))
            dFt = torch.where(torch.abs(dFt) < 1e-12,
                              torch.full_like(dFt, 1e-12), dFt)
            t = t - Ft / dFt
        ok = good & (t >= tMin) & (t <= tMax) & torch.isfinite(t)
        t = torch.where(ok, t, t0)
        return t, x + a * t, y + b * t, z + c * t, lost
