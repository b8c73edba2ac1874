"""Atomic data tables: scattering factors f0 (the Waasmaier-Kirfel
parameterization of XOP's ``f0_xop.dat``), f1/f2 vs E (Henke / Chantler /
Brennan-Cowan) and atomic masses.

The tables ship with this package, in its ``data/`` directory
(``Henke.npz``, ``Chantler.npz``, ``BrCo.npz``, ``AtomicData.dat`` and
``f0_xop.dat``): byte-identical copies of the reference package's tables,
so the port reads nothing outside its own tree.
"""
import functools
import os

import numpy as np

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'data')

ELEMENTS_LIST = (
    'none', 'H', 'He', 'Li', 'Be', 'B', 'C', 'N', 'O', 'F', 'Ne',
    'Na', 'Mg', 'Al', 'Si', 'P', 'S', 'Cl', 'Ar', 'K', 'Ca', 'Sc', 'Ti', 'V',
    'Cr', 'Mn', 'Fe', 'Co', 'Ni', 'Cu', 'Zn', 'Ga', 'Ge', 'As', 'Se', 'Br',
    'Kr', 'Rb', 'Sr', 'Y', 'Zr', 'Nb', 'Mo', 'Tc', 'Ru', 'Rh', 'Pd', 'Ag',
    'Cd', 'In', 'Sn', 'Sb', 'Te', 'I', 'Xe', 'Cs', 'Ba', 'La', 'Ce', 'Pr',
    'Nd', 'Pm', 'Sm', 'Eu', 'Gd', 'Tb', 'Dy', 'Ho', 'Er', 'Tm', 'Yb', 'Lu',
    'Hf', 'Ta', 'W', 'Re', 'Os', 'Ir', 'Pt', 'Au', 'Hg', 'Tl', 'Pb', 'Bi',
    'Po', 'At', 'Rn', 'Fr', 'Ra', 'Ac', 'Th', 'Pa', 'U')


@functools.lru_cache(maxsize=None)
def _f0_table():
    """{symbol: [a1..a5, c, b1..b5]} from ``f0_xop.dat``."""
    f0data = {}
    symbol = None
    with open(os.path.join(DATA_DIR, 'f0_xop.dat')) as f:
        it = iter(f)
        for line in it:
            if line.startswith('#S'):
                symbol = line.split()[-1].strip()
            elif line.startswith('#UP') and symbol is not None:
                f0data[symbol] = [float(v) for v in next(it).split()]
                symbol = None
    return f0data


@functools.lru_cache(maxsize=None)
def _f1f2_table(table_name: str):
    with open(os.path.join(DATA_DIR, table_name + '.npz'), 'rb') as f:
        res = np.load(f)
        return {k: np.array(v) for k, v in res.items()}


@functools.lru_cache(maxsize=None)
def _atomic_mass_table():
    masses = {}
    with open(os.path.join(DATA_DIR, 'AtomicData.dat')) as f:
        for line in f:
            fields = line.split()
            if fields and int(fields[0]) > 0:
                masses[int(fields[0])] = float(fields[3])
    return masses


def element_z(elem) -> int:
    if isinstance(elem, str):
        return ELEMENTS_LIST.index(elem)
    return int(elem)


def element_name(elem) -> str:
    if isinstance(elem, str):
        return elem
    return ELEMENTS_LIST[int(elem)]


def atomic_mass(elem) -> float:
    return _atomic_mass_table()[element_z(elem)]


def f0_coefficients(elem) -> np.ndarray:
    """[a1..a5, c, b1..b5] of the element's Waasmaier-Kirfel f0
    parameterization."""
    return np.asarray(_f0_table()[element_name(elem)])


def f1f2_arrays(elem, table='Chantler total'):
    """(E, f1, f2) arrays of the element from the named tabulation;
    'total' selects total (not only photoelectric) cross-sections."""
    data = _f1f2_table(table.split()[0])
    f2key = '_f2tot' if 'total' in table else '_f2'
    name = element_name(elem)
    return (np.array(data[name + '_E']), np.array(data[name + '_f1']),
            np.array(data[name + f2key]))
