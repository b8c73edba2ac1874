"""Beam persistence and file-based sources.

Port of the reference package's ``beamio.py`` (the beam save and load
paths of xrt's sources/beams.py, Beam.__init__ copyFrom branch:88-118 and
export_beam:154-192, and its BeamFromFile source, sources/geoms.py:
979-1039).

Formats: numpy ``.npy`` (a pickled dict of arrays, the round-trip
format), Matlab ``.mat`` (scipy.io; arrays come back 2-D from Matlab, so
they are squeezed on load) and Python ``.pickle``.  The files hold numpy
arrays under the Beam's field names, as the reference package writes
them, so either package reads the other's files.
"""
from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from . import config
from .beam import Beam

#: per-ray fields: a 0-d array of one of them is one ray
_PER_RAY = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'state', 'path', 'Jss',
            'Jpp', 'Jsp', 'Es', 'Ep')


def beam_to_dict(beam: Beam) -> dict:
    """The Beam as a dict of numpy arrays, without its ``None`` fields."""
    out = {}
    for f in dataclasses.fields(beam):
        v = getattr(beam, f.name)
        if v is None:
            continue
        out[f.name] = v.detach().cpu().numpy() if isinstance(
            v, torch.Tensor) else np.asarray(v)
    return out


def beam_from_dict(d: dict, device=None) -> Beam:
    """Inverse of :func:`beam_to_dict`, on *device* (the card by default)
    in the arrays' own dtypes; unknown keys are ignored (the extra
    attributes of the reference xrt's beam files are dropped)."""
    dev = config.resolve_device(device)
    names = {f.name for f in dataclasses.fields(Beam)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        v = np.squeeze(np.asarray(v))   # .mat round-trip makes (1, n)
        if v.ndim == 0 and k in _PER_RAY:
            v = v[None]
        kwargs[k] = torch.as_tensor(np.ascontiguousarray(v), device=dev)
    return Beam(**kwargs)


def export_beam(beam: Beam, fileName: str, fformat: str = 'npy') -> str:
    """Save *beam* to *fileName*; returns the path written."""
    outputDict = beam_to_dict(beam)
    fmt = str(fformat).lower()
    if fmt in ('npy', 'np', 'numpy'):
        if not fileName.endswith('npy'):
            fileName += '.npy'
        np.save(fileName, outputDict)  # stored as a 0-d object array
    elif fmt in ('mat', 'matlab'):
        import scipy.io as io
        if not fileName.endswith('mat'):
            fileName += '.mat'
        io.savemat(fileName, outputDict)
    else:
        if not fileName.endswith('pickle'):
            fileName += '.pickle'
        with open(fileName, 'wb') as f:
            pickle.dump(outputDict, f)
    return fileName


def load_beam(fileName: str, device=None) -> Beam:
    """A beam saved by :func:`export_beam` (either package's, or the
    reference xrt's ``Beam.export_beam``) in any of the three formats, on
    *device*."""
    if fileName.endswith('mat'):
        import scipy.io as io
        d = {k: v for k, v in io.loadmat(fileName).items()
             if not k.startswith('__')}
    elif fileName.endswith('npy'):
        d = np.load(fileName, allow_pickle=True).item()
    else:
        with open(fileName, 'rb') as f:
            d = pickle.load(f)
    return beam_from_dict(d, device)


class BeamFromFile(config.Replaceable):
    """A source that replays a previously exported beam (xrt's
    geoms.py:979-1039): ``shine()`` returns the stored beam, read once at
    ``create``."""

    def __init__(self, fbeam: Beam, name: str = ''):
        self.fbeam = fbeam
        self.name = name

    @classmethod
    def create(cls, fileName: str, name: str = '', device=None):
        return cls(load_beam(fileName, device), name=name)

    def shine(self, generator=None) -> Beam:
        return self.fbeam
