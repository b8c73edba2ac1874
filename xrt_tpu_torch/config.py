"""Global configuration for xrt_tpu_torch: defaults, ray states, and the
dtype/device policy.

The reference package picks its float type from a global x64 switch
(``xrt_tpu/config.py:33-40``).  Here every entry point takes an explicit
``dtype=`` (``torch.float32`` by default, ``torch.float64`` allowed) and
``device=`` (``'cuda'`` by default).  Entry points run on the card: without
CUDA they raise unless the caller asked for the CPU with ``device='cpu'``.
"""
from __future__ import annotations

import copy

import torch

#: default photon energy, eV
DEFAULT_ENERGY = 9.0e3

#: default number of rays in a generated beam
NRAYS = 100000

#: maximum number of iterations of the ray-surface intersection solver
MAX_INTERSECTION_ITERATIONS = 64

#: bracketing of the intersection search, mm: the largest half size and
#: depth an element is taken to have, and the margin added around it
MAX_HALF_SIZE_OF_OE = 1000.0
MAX_DEPTH_OF_OE = 100.0
DT_MARGIN = 1e-5

# ray state codes (cf. reference xrt/backends/raycing/__init__.py:84-97)
STATE_GOOD = 1       # ray hits within optical limits
STATE_OUT = 2        # outside optical limits but within physical limits
STATE_OVER = 3       # outside physical limits (missed the element)
STATE_DEAD = -1      # absorbed / lost

DEFAULT_DTYPE = torch.float32
DEFAULT_DEVICE = 'cuda'


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.  ``None`` means the card; a CUDA
    device without CUDA raises instead of quietly running on the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'xrt_tpu_torch runs on a CUDA device and none is available; '
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    dt = DEFAULT_DTYPE if dtype is None else dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f'dtype must be torch.float32 or torch.float64, '
                         f'not {dt}')
    return dt


def cdtype(dtype) -> torch.dtype:
    """The complex dtype matching a real *dtype*."""
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def number(v):
    """A geometry parameter as an element stores it: a tensor stays the
    tensor that was passed in (so a gradient can flow to it), any other
    number becomes a Python float."""
    return v if isinstance(v, torch.Tensor) else float(v)


def host_float(v) -> float:
    """The detached Python float of a parameter, for the host geometry."""
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)


class Replaceable:
    """``replace(**updates)``: a shallow copy with some attributes set, as
    the reference package's elements have it.  A tensor that is passed in is
    kept as it is."""

    def replace(self, **updates):
        new = copy.copy(self)
        for name, value in updates.items():
            if not hasattr(new, name):
                raise AttributeError(
                    f'{type(self).__name__} has no parameter {name!r}')
            setattr(new, name, value)
        return new


def auto_units_angle(angle, defaultFactor=1.0):
    """Parse angle values given as strings with units — '0.2 deg',
    '4 mrad', '250 urad', '10 nrad', '0.004 rad' — into radians
    (reference _flow_utils.py:74-98).  Plain numbers pass through scaled
    by *defaultFactor*; None and 'auto' pass through unchanged."""
    if angle is None or not isinstance(angle, str):
        if isinstance(angle, (int, float)) and defaultFactor != 1.0:
            return angle * defaultFactor
        return angle
    import math
    t = angle.strip().lower()
    if 'auto' in t:
        return angle
    if 'mrad' in t:
        return float(t.split('m')[0]) * 1e-3
    if 'urad' in t:
        return float(t.split('u')[0]) * 1e-6
    if 'nrad' in t:
        return float(t.split('n')[0]) * 1e-9
    if 'rad' in t:
        return float(t.split('r')[0])
    if 'deg' in t:
        return math.radians(float(t.split('d')[0]))
    return float(t) * defaultFactor
