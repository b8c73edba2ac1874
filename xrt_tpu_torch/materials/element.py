"""Chemical elements with their anomalous x-ray scattering factors: the
tabulated (E, f1, f2) as tensors, interpolated on the device."""
from __future__ import annotations

import torch

from .. import config
from ..ops.interp import fast_interp
from . import data as _data


class Element:
    def __init__(self, Z, name, mass, Etable, f1table, f2table):
        self.Z, self.name, self.mass = Z, name, mass
        self.Etable = Etable            # tabulated energies, eV (sorted)
        self.f1table = f1table
        self.f2table = f2table

    @classmethod
    def create(cls, elem, table='Chantler total', dtype=None, device=None):
        dt = config.resolve_dtype(dtype)
        dev = config.resolve_device(device)
        E, f1, f2 = _data.f1f2_arrays(elem, table)

        def T(v):
            return torch.as_tensor(v, dtype=dt, device=dev)
        return cls(_data.element_z(elem), _data.element_name(elem),
                   _data.atomic_mass(elem), T(E), T(f1), T(f2))

    def get_f1f2(self, E):
        """Complex anomalous scattering factor f1 + i f2 at E [eV];
        energies outside the table are clamped to its ends."""
        f1 = fast_interp(E, self.Etable, self.f1table)
        f2 = fast_interp(E, self.Etable, self.f2table)
        return torch.complex(f1, f2)
