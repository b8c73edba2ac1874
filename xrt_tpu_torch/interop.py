"""Carry beams, prepared waves and histograms across as numpy arrays.

The parity tests run the reference package and the port on the same
state: its beams and prepared waves are turned into dicts of numpy arrays
and rebuilt here as the port's :class:`~xrt_tpu_torch.beam.Beam` /
:class:`~xrt_tpu_torch.waves.Wave`.  Only tensor-valued fields are read;
the element references of a wave (``fromOE``, ``toOE``) are passed
separately, since elements are rebuilt in the port from the same
``create(...)`` arguments.  Integer fields (the ray ``state``) become
int32 whatever width they were dumped with.  :func:`hists_to_numpy` is the
way back for the histograms of a pass.
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


def hists_to_numpy(hists) -> dict:
    """The output of :func:`xrt_tpu_torch.runner.histogram_plot` with every
    tensor as a numpy array (0-dim ones as Python numbers), the nested
    ``counters`` included."""
    out = {}
    for k, v in hists.items():
        if isinstance(v, dict):
            out[k] = hists_to_numpy(v)
        elif isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            out[k] = a.item() if a.ndim == 0 else a
        else:
            out[k] = v
    return out
