"""Predefined material catalogs: 38 crystals, 92 elemental materials and 76
compounds.

Port of the reference package's ``materials/catalogs.py``.  The data is
``data/catalogs.json`` (a byte-identical copy of the reference package's),
and factory functions build the port's material objects on demand:

    >>> from xrt_tpu_torch.materials import catalogs
    >>> si = catalogs.crystal('Si', hkl=(1, 1, 1), device='cpu')
    >>> au = catalogs.elemental('Au', kind='mirror', device='cpu')
    >>> catalogs.crystals.Ge(hkl=(3, 3, 3), dtype=torch.float64)

Keyword arguments go on to the material's ``create`` (``dtype=``,
``device=`` among them).
"""
from __future__ import annotations

import functools
import json
import os

from .crystal import CrystalDiamond, CrystalFcc, CrystalFromCell
from .data import DATA_DIR
from .material import Material


@functools.lru_cache(maxsize=None)
def _data():
    with open(os.path.join(DATA_DIR, 'catalogs.json')) as f:
        return json.load(f)


def list_crystals():
    return sorted(_data()['crystals'])


def list_elemental():
    return sorted(_data()['elemental'])


def list_compounds():
    return sorted(_data()['compounds'])


def crystal(name, hkl=(1, 1, 1), **kwargs):
    """A predefined crystal by its catalog name: a cell with its atoms, or
    a diamond or fcc lattice of its elements."""
    d = dict(_data()['crystals'][name])
    base = d.pop('base', 'CrystalFromCell')
    if 'atoms' in d:
        return CrystalFromCell.create(
            name=name, hkl=hkl, a=d['a'], b=d['b'], c=d['c'],
            alpha=d['alpha'], beta=d['beta'], gamma=d['gamma'],
            atoms=d['atoms'], atomsXYZ=d['atomsXYZ'],
            atomsFraction=d['atomsFraction'], **kwargs)
    cls = CrystalDiamond if base in ('CrystalDiamond', 'CrystalSi') \
        else CrystalFcc
    return cls.create(hkl=hkl, a=d['a'], elements=tuple(d['elements']),
                      rho=d.get('rho', 0.0), name=name, **kwargs)


def _amorphous(section, name, kind, kwargs):
    d = _data()[section][name]
    return Material.create(tuple(d['elements']), tuple(d['quantities']),
                           kind=kind, rho=d['rho'], table=d['table'],
                           name=name, **kwargs)


def elemental(name, kind='auto', **kwargs):
    """A predefined elemental material."""
    return _amorphous('elemental', name, kind, kwargs)


def compound(name, kind='auto', **kwargs):
    """A predefined compound material."""
    return _amorphous('compounds', name, kind, kwargs)


class _CatalogNamespace:
    """Attribute access into a catalog: ``crystals.Si(hkl=(1, 1, 1))``,
    ``elements.Au(kind='mirror')``."""

    def __init__(self, factory, lister):
        self._factory = factory
        self._lister = lister

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        avail = self._lister()
        if name not in avail:
            raise AttributeError(
                f'{name!r} not in catalog; available: {sorted(avail)[:8]}...')
        return functools.partial(self._factory, name)

    def __dir__(self):
        return sorted(self._lister())


crystals = _CatalogNamespace(crystal, list_crystals)
elements = _CatalogNamespace(elemental, list_elemental)
compounds = _CatalogNamespace(compound, list_compounds)
