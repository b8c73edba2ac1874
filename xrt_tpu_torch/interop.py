"""Carry beams and prepared waves across from numpy arrays.

The parity tests run the reference package and the port on the same
state: its beams and prepared waves are turned into dicts of numpy arrays
and rebuilt here as the port's :class:`~xrt_tpu_torch.beam.Beam` /
:class:`~xrt_tpu_torch.waves.Wave`.  Only tensor-valued fields are read;
the element references of a wave (``fromOE``, ``toOE``) are passed
separately, since elements are rebuilt in the port from the same
``create(...)`` arguments.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config
from .beam import Beam


def _tensors(cls, arrays, device, dtype):
    dt = config.resolve_dtype(dtype)
    dev = config.resolve_device(device)
    cdt = config.cdtype(dt)
    out = {}
    for f in dataclasses.fields(cls):
        v = arrays.get(f.name)
        if v is None or f.name in ('fromOE', 'toOE'):
            continue
        a = np.array(v)      # a writable copy
        if np.iscomplexobj(a):
            t = torch.as_tensor(a, dtype=cdt)
        elif a.dtype.kind in 'iub':
            t = torch.as_tensor(a.astype(np.int32))
        else:
            t = torch.as_tensor(a, dtype=dt)
        out[f.name] = t.to(dev)
    return out


def beam_from_numpy(arrays, device=None, dtype=None) -> Beam:
    """A :class:`Beam` from a mapping of field name -> array (missing
    optional fields stay None)."""
    return Beam(**_tensors(Beam, arrays, device, dtype))


def wave_from_numpy(arrays, device=None, dtype=None, fromOE=None,
                    toOE=None):
    """A :class:`~xrt_tpu_torch.waves.Wave` from a mapping of field name
    -> array, attached to the port's elements *fromOE* / *toOE*."""
    from .waves import Wave
    return Wave(**_tensors(Wave, arrays, device, dtype), fromOE=fromOE,
                toOE=toOE)


def to_numpy(obj) -> dict:
    """{field: numpy array} of the tensor fields of a Beam or Wave (the
    inverse of :func:`beam_from_numpy` / :func:`wave_from_numpy`)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
    return out
