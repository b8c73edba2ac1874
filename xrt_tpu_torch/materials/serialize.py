"""Material dictionaries for beamline layouts.

Port of the reference package's ``materials/serialize.py``.  A material
becomes ``{'__material__': True, 'class', 'module', 'params', 'raw'}``:
*params* are the JSON-safe ``create()`` keyword arguments read back from
the material's fields, *raw* the fields ``create()`` cannot take (a
tabulated refractive index, grating efficiency tables, graded multilayer
thicknesses), set by ``replace`` after creation.  Nested materials (a
multilayer's layers and substrate) recurse.  The dictionaries equal the
reference package's for the same material, and either package reads the
other's: the module is resolved inside the reading package
(``beamline._layout_module``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..beamline import _create_signature_names, _fields, _layout_module
from .crystal import Crystal
from .material import EmptyMaterial, Material
from .multilayer import Multilayer

_RENAMES = {'b_': 'b', 'atoms_Z': 'atoms'}
#: fields create() cannot accept but that carry user data; restored by
#: replace() after create().  Complex values are tagged in JSON.
_RAW_FIELDS = ('riE', 'riN', 'efficiency_orders', 'efficiency_I',
               'efficiency_E', 'dti', 'dbi')
#: the raw fields that are tuples, not tensors
_RAW_TUPLES = ('efficiency_orders',)


def _encode(val):
    if hasattr(val, 'tolist'):
        val = val.tolist()
    if isinstance(val, complex):
        return {'__complex__': [val.real, val.imag]}
    if isinstance(val, (list, tuple)):
        return [_encode(v) for v in val]
    return val


def _decode(val, dtype=None, device=None):
    if isinstance(val, dict) and '__complex__' in val:
        return complex(*val['__complex__'])
    if isinstance(val, dict) and val.get('__material__'):
        return material_from_dict(val, dtype=dtype, device=device)
    if isinstance(val, list):
        return [_decode(v, dtype, device) for v in val]
    return val


def material_to_dict(mat):
    """A JSON-safe description of *mat* sufficient to rebuild it."""
    if mat is None:
        return None
    cls = type(mat)
    if cls.__name__ == 'TXMMaterial':
        raise ValueError(
            'TXMMaterial holds voxel volumes and is not layout-'
            'serializable; rebuild it from its source images and pass it '
            'via the materials= argument of load_from_json/load_from_xml')
    accepted = _create_signature_names(cls)
    if isinstance(mat, Crystal):
        accepted.discard('kind')   # Crystal.create sets kind='crystal'
    params, raw = {}, {}
    for fname in _fields(mat):
        val = getattr(mat, fname)
        if val is None:
            continue
        cname = _RENAMES.get(fname, fname)
        if cname not in accepted:
            enc = _encode(val) if fname in _RAW_FIELDS else None
            if enc is not None and enc != []:
                raw[fname] = enc
            continue
        if isinstance(val, (Material, EmptyMaterial, Multilayer)):
            params[cname] = material_to_dict(val)
        elif fname == 'elements':
            params[cname] = [el.name for el in val]
        else:
            params[cname] = _encode(val)
    if isinstance(mat, Multilayer):
        # uniform stacks round-trip through create(tThickness=,
        # bThickness=); only graded profiles need the raw arrays
        for fname, pname in (('dti', 'tThickness'), ('dbi', 'bThickness')):
            v = np.asarray(raw.get(fname, ()))
            if v.size and np.all(v == v.flat[0]):
                params[pname] = float(v.flat[0])
                del raw[fname]
    return {'__material__': True, 'class': cls.__name__,
            'module': cls.__module__, 'params': params, 'raw': raw}


def material_from_dict(d, dtype=None, device=None):
    """The inverse of :func:`material_to_dict`: the material in *dtype* on
    *device* (the package defaults if None)."""
    if d is None:
        return None
    cls = getattr(_layout_module(d['module']), d['class'])
    params = {k: _decode(v, dtype, device) for k, v in d['params'].items()}
    accepted = _create_signature_names(cls)
    params.update({k: v for k, v in (('dtype', dtype), ('device', device))
                   if k in accepted})
    mat = cls.create(**params) if hasattr(cls, 'create') else cls(**params)
    raw = d.get('raw') or {}
    if raw:
        dt = config.resolve_dtype(dtype)
        dev = config.resolve_device(device)
        upd = {}
        for fname, val in raw.items():
            val = _decode(val)
            if fname in _RAW_TUPLES:
                upd[fname] = tuple(val) if isinstance(val, list) else val
            elif _has_complex(val):
                arr = np.asarray(val, complex)
                upd[fname] = torch.complex(
                    torch.as_tensor(arr.real, dtype=dt, device=dev),
                    torch.as_tensor(arr.imag, dtype=dt, device=dev))
            else:
                upd[fname] = torch.as_tensor(val, dtype=dt, device=dev)
        mat = mat.replace(**upd)
    return mat


def _has_complex(val):
    if isinstance(val, list):
        return any(_has_complex(v) for v in val)
    return isinstance(val, complex)
