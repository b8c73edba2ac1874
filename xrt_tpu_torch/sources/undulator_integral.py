"""The undulator's radiation integral in one CUDA kernel.

``Undulator.build_I_map`` asks :func:`engages` whether a call can go to
``csrc/undulator_integral.cu`` and then calls :func:`integrate` in place of
``Undulator._integrate``.  The kernel evaluates the plain loop's
expressions one ray a thread (``csrc/undulator_integral.cuh``): the ray's
terms once, then every node of nonzero weight of every copy of the node
grid, with Bs and Bp summed in double, in one launch a call and with no
temporaries.  The variant (far field, taper, near field) is the one the
source itself is: ``taper_val`` set, ``R0`` set, or neither.

It serves rays of float32 or float64 whose call autograd would not record:
no ray tensor and no tensor ``Kx`` / ``Ky`` requires grad.  A source both
tapered and in the near field (which the plain loop does not compute
either), rays on the CPU and a call that needs a gradient keep
``Undulator._integrate``.

The node table (the nodes' positions in the period, their weights and
the sines and cosines of their trajectory phases, in double and rounded
to the rays' dtype) is made once per grid, phase, dtype and card and kept
(:data:`TABLES` of them).  While the profiler traces, ``build_I_map``
counts ``integral.calls`` on every call and ``integral.fused`` on every
call this kernel serves.
"""
from __future__ import annotations

import collections
import ctypes
import numbers

import numpy as np
import torch

from .. import config
from ..ops import _cuda
from ..physconsts import E2WC, PI, PI2

#: kernel launches by variant and dtype (``LAUNCHES.clear()`` before a run,
#: read after)
LAUNCHES: collections.Counter = collections.Counter()

#: the variants of csrc/undulator_integral.cuh (xund::Mode)
FAR, TAPER, NEAR = 0, 1, 2
MODES = {FAR: 'far', TAPER: 'taper', NEAR: 'near'}
#: the numbers of a call, in csrc/undulator_integral.cuh's order (xund::Num)
NUMBERS = ('Kx', 'Ky', 'alphaS', 'R0n', 'omb', 'PI', 'PI2')
#: node tables kept, the most recently used
TABLES = 8

_P = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, _P, _P, ctypes.c_longlong, _P, _P, _P]

#: {(grid bytes, phase, dtype, device): table}, least recently used first
_TABLES: collections.OrderedDict = collections.OrderedDict()


def mode(und):
    """The variant of *und*'s integral (FAR, TAPER or NEAR), or None where
    the kernel has none: tapered and in the near field at once, or a
    taper or distance that is not a number."""
    taper, near = und.taper_val is not None, und.R0 is not None
    if (taper and near) or not all(isinstance(v, numbers.Real) for v in (
            und.taper_val, und.R0) if v is not None):
        return None
    return TAPER if taper else NEAR if near else FAR


def engages(und, ww1, w, wu, gamma, ddphi, ddpsi):
    """Whether ``build_I_map`` runs the integral of these rays in the
    kernel: rays on a card that :func:`handles`."""
    return w.device.type == 'cuda' and \
        handles(und, ww1, w, wu, gamma, ddphi, ddpsi)


def handles(und, ww1, w, wu, gamma, ddphi, ddpsi):
    """Whether the kernel computes the call, wherever the rays lie: the
    six ray tensors of one shape, device and dtype, float32 or float64, a
    source of a variant (:func:`mode`) with some node of nonzero weight,
    and nothing autograd would record."""
    rays = (ww1, w, wu, gamma, ddphi, ddpsi)
    if w.dtype not in (torch.float32, torch.float64) or \
            any(v.dtype != w.dtype or v.device != w.device or
                v.shape != w.shape for v in rays) or \
            mode(und) is None or und.ag is None or \
            not np.any(np.asarray(und.ag)):
        return False
    Ks = [v for v in (und.Kx, und.Ky) if isinstance(v, torch.Tensor)]
    if any(v.numel() != 1 for v in Ks):
        return False
    return not (torch.is_grad_enabled() and any(
        v.requires_grad for v in rays + tuple(Ks)))


def node_table(und, dtype, device):
    """(8, nodes) of *dtype* on *device*: the rows of
    csrc/undulator_integral.cuh's Row for *und*'s nodes of nonzero weight
    (tg, the weight, sin and cos of tg and of tg + phase, sin 2 tg and
    sin 2 (tg + phase)), made in double.  Kept for the :data:`TABLES`
    grids used last."""
    tg, ag = np.asarray(und.tg, np.float64), np.asarray(und.ag, np.float64)
    key = (tg.tobytes(), ag.tobytes(), float(und.phase), dtype, device)
    table = _TABLES.get(key)
    if table is not None:
        _TABLES.move_to_end(key)
        return table
    nz = ag != 0
    x, w = tg[nz], ag[nz]
    xph = x + und.phase
    sinx, cosx, sinxph, cosxph = np.sin(x), np.cos(x), np.sin(xph), \
        np.cos(xph)
    table = torch.as_tensor(np.stack(
        [x, w, sinx, cosx, sinxph, cosxph, 2 * sinx * cosx,
         2 * sinxph * cosxph]), dtype=dtype, device=device)
    _TABLES[key] = table
    while len(_TABLES) > TABLES:
        _TABLES.popitem(last=False)
    return table


def _launch(args, device):
    """Launch the kernel with the C arguments *args* on *device*'s current
    stream."""
    _cuda.launch('undulator_integral', 'undulator_integral_launch',
                 _ARGTYPES, device, *args)


def integrate(und, ww1, w, wu, gamma, ddphi, ddpsi):
    """``und._integrate(ww1, w, wu, gamma, ddphi, ddpsi)`` for a call
    :func:`handles` accepts, in one launch: (Is, Ip), complex of the rays'
    dtype and shape."""
    m = mode(und)
    dt, dev, shape = w.dtype, w.device, w.shape
    table = node_table(und, dt, dev)
    Kx, Ky = config.host_float(und.Kx), config.host_float(und.Ky)
    nums = dict(Kx=Kx, Ky=Ky,
                alphaS=und.taper_val / E2WC if m == TAPER else 0.0,
                R0n=und.R0 * PI2 / und.L0 if m == NEAR else 0.0,
                omb=(1. + 0.5 * Kx ** 2 + 0.5 * Ky ** 2) * 0.5, PI=PI,
                PI2=PI2)
    ncopies = und._node_copies()
    ins = [v.detach().reshape(-1).contiguous()
           for v in (ww1, w, wu, gamma, ddphi, ddpsi)]
    n = ins[0].numel()
    outs = [torch.empty((n, 2), dtype=dt, device=dev) for _ in range(2)]

    def ptrs(ctype, vs):
        return (ctype * len(vs))(*vs)
    if n:
        _launch((int(dt == torch.float64),
                 ptrs(ctypes.c_double, [nums[k] for k in NUMBERS]),
                 ptrs(ctypes.c_int, [m, ncopies, table.shape[1]]), n,
                 ptrs(_P, [v.data_ptr() for v in ins]), table.data_ptr(),
                 ptrs(_P, [v.data_ptr() for v in outs])), dev)
        LAUNCHES[f'undulator_integral:{MODES[m]}:{dt}'] += 1
    Is, Ip = (torch.view_as_complex(v).reshape(shape) for v in outs)
    return Is, Ip
