"""Typed parameter arrays and the unit registry.

The port's own copy of the reference package's ``units.py``: host-side
configuration metadata, the display units (EGU) of element fields, unit
conversion tables, and small named parameter containers (``Center``,
``Limits``, ``Opening``, ``Image2D``) that behave like tuples anywhere the
elements accept one but expose named components for control layers
(reference xrt's _named_arrays.py:1-76 and _sets_units.py:1-132).  Nothing
here is a tensor: elements convert these to numbers at ``create()``.
"""
import dataclasses
import numpy as np

# ---------------------------------------------------------------- units
# scale factors to the framework's canonical units (rad, mm, eV, nm*rad,
# A) and the display strings used for PV EGUs and plot labels
# (reference _sets_units.py:46-97)
ANGLE_UNITS = {'rad': 1.0, 'mrad': 1e-3, 'urad': 1e-6, 'nrad': 1e-9,
               'deg': np.pi / 180., 'mdeg': 1e-3 * np.pi / 180.,
               'arcsec': np.pi / 180. / 3600.}
ANGLE_STR = {'rad': 'rad', 'mrad': 'mrad', 'urad': u'µrad',
             'deg': u'°', 'mdeg': u'm°', 'arcsec': 'arcsec'}
LENGTH_UNITS = {'angstroem': 1e-7, 'nm': 1e-6, 'um': 1e-3, 'mm': 1.0,
                'm': 1e3, 'km': 1e6}
LENGTH_STR = {'angstroem': u'Å', 'nm': 'nm', 'um': u'µm',
              'mm': 'mm', 'm': 'm', 'km': 'km'}
ENERGY_UNITS = {'meV': 1e-3, 'eV': 1.0, 'keV': 1e3, 'MeV': 1e6, 'GeV': 1e9}
EMITTANCE_UNITS = {'pmrad': 1e-3, 'nmrad': 1.0}
CURRENT_UNITS = {'mA': 1e-3, 'A': 1.0}

_KIND_TABLES = {'angle': ANGLE_UNITS, 'length': LENGTH_UNITS,
                'energy': ENERGY_UNITS, 'emittance': EMITTANCE_UNITS,
                'current': CURRENT_UNITS}


def convert(value, unit, kind):
    """*value* given in *unit* -> canonical units of *kind*
    ('angle' -> rad, 'length' -> mm, 'energy' -> eV, ...)."""
    table = _KIND_TABLES[kind]
    if unit not in table:
        raise KeyError(f'unknown {kind} unit {unit!r}; '
                       f'one of {sorted(table)}')
    return value * table[unit]


#: element/source field -> (kind, canonical EGU string): the engineering
#: units of a control layer's process variables (reference records.py EGU
#: fields via _sets_units.py:99-110) and of the control server's output.
FIELD_UNITS = {
    # orientation (canonical: rad, mm)
    'pitch': ('angle', 'rad'), 'roll': ('angle', 'rad'),
    'yaw': ('angle', 'rad'), 'positionRoll': ('angle', 'rad'),
    'braggAngle': ('angle', 'rad'), 'bragg_': ('angle', 'rad'),
    'azimuth': ('angle', 'rad'), 'blaze': ('angle', 'rad'),
    'center': ('length', 'mm'),
    # shape
    'R': ('length', 'mm'), 'r': ('length', 'mm'),
    'Rm': ('length', 'mm'), 'Rs': ('length', 'mm'),
    'limPhysX': ('length', 'mm'), 'limPhysY': ('length', 'mm'),
    'limPhysX2': ('length', 'mm'), 'limPhysY2': ('length', 'mm'),
    'limOptX': ('length', 'mm'), 'limOptY': ('length', 'mm'),
    'p': ('length', 'mm'), 'q': ('length', 'mm'),
    'f1': ('length', 'mm'), 'f2': ('length', 'mm'),
    'focus': ('length', 'mm'), 'workingDistance': ('length', 'mm'),
    'dx': ('length', 'mm'), 'dz': ('length', 'mm'),
    'px': ('length', 'mm'), 'pz': ('length', 'mm'),
    't': ('length', 'mm'), 'zmax': ('length', 'mm'),
    'left': ('length', 'mm'), 'right': ('length', 'mm'),
    'bottom': ('length', 'mm'), 'top': ('length', 'mm'),
    'fixedOffset': ('length', 'mm'), 'cryst2perpTransl': ('length', 'mm'),
    'cryst2longTransl': ('length', 'mm'),
    # source e-beam / photon
    'eE': ('energy', 'GeV'), 'eI': ('current', 'A'),
    'eMin': ('energy', 'eV'), 'eMax': ('energy', 'eV'),
    'alignE': ('energy', 'eV'), 'E0': ('energy', 'eV'),
    'eEpsilonX': ('emittance', 'nmrad'), 'eEpsilonZ': ('emittance',
                                                       'nmrad'),
    'betaX': ('length', 'm'), 'betaZ': ('length', 'm'),
    'period': ('length', 'mm'),
    'xPrimeMax': ('angle', 'rad'), 'zPrimeMax': ('angle', 'rad'),
    'dxprime': ('angle', 'rad'), 'dzprime': ('angle', 'rad'),
    'R0': ('length', 'mm'),
}


def unit_of(field):
    """EGU display string for an element/source field ('' if unitless
    or unknown)."""
    kind_unit = FIELD_UNITS.get(field)
    return kind_unit[1] if kind_unit else ''


# ------------------------------------------------- named parameter arrays
@dataclasses.dataclass
class _NamedArray:
    """Tuple-compatible container with named components
    (reference _named_arrays.py:5-76).  Accepted anywhere the elements
    take a sequence: iteration and ``np.asarray`` see the values in
    declaration order."""

    def __iter__(self):
        return (getattr(self, f.name)
                for f in dataclasses.fields(self))

    def __len__(self):
        return len(dataclasses.fields(self))

    def __getitem__(self, i):
        return tuple(self)[i]

    def __array__(self, dtype=None, copy=None):
        return np.array(tuple(self), dtype=dtype or float)

    def __eq__(self, other):
        try:
            return np.array_equal(np.asarray(self), np.asarray(other))
        except Exception:
            return NotImplemented


@dataclasses.dataclass(eq=False)
class Center(_NamedArray):
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclasses.dataclass(eq=False)
class Limits(_NamedArray):
    lmin: float = 0.0
    lmax: float = 0.0


@dataclasses.dataclass(eq=False)
class Opening(_NamedArray):
    left: float = 0.0
    right: float = 0.0
    bottom: float = 0.0
    top: float = 0.0


@dataclasses.dataclass(eq=False)
class Image2D(_NamedArray):
    width: int = 0
    height: int = 0

    def __array__(self, dtype=None, copy=None):
        return np.array(tuple(self), dtype=dtype or int)
