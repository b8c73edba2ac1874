"""Chemical elements with their x-ray scattering factors: the f0
parameterization and the tabulated (E, f1, f2) as tensors, evaluated on the
device."""
from __future__ import annotations

import torch

from .. import config
from ..ops.interp import fast_interp
from . import data as _data


class Element:
    def __init__(self, Z, name, mass, Etable, f1table, f2table,
                 f0coeffs=None, tableDtype=None):
        self.Z, self.name, self.mass = Z, name, mass
        self.Etable = Etable            # tabulated energies, eV (sorted)
        self.f1table = f1table
        self.f2table = f2table
        self.f0coeffs = f0coeffs        # [a1..a5, c, b1..b5]
        # the dtype the tables were stored in (float32)
        self.tableDtype = Etable.dtype if tableDtype is None else tableDtype

    @classmethod
    def create(cls, elem, table='Chantler total', dtype=None, device=None):
        dt = config.resolve_dtype(dtype)
        dev = config.resolve_device(device)
        E, f1, f2 = _data.f1f2_arrays(elem, table)

        def T(v):
            return torch.as_tensor(v, dtype=dt, device=dev)
        return cls(_data.element_z(elem), _data.element_name(elem),
                   _data.atomic_mass(elem), T(E), T(f1), T(f2),
                   T(_data.f0_coefficients(elem)),
                   torch.from_numpy(E).dtype)

    def get_f0(self, qOver4pi=0.0):
        """f0(q / 4 pi), q / 4 pi = sin(theta) / lambda [1/A], by the
        Waasmaier-Kirfel parameterization."""
        c = self.f0coeffs[5]
        a = self.f0coeffs[0:5]
        b = self.f0coeffs[6:11]
        q2 = torch.as_tensor(qOver4pi, dtype=c.dtype, device=c.device) ** 2
        return c + torch.sum(a * torch.exp(-b * q2[..., None]), dim=-1)

    def get_f1f2(self, E):
        """Complex anomalous scattering factor f1 + i f2 at E [eV];
        energies outside the table are clamped to its ends.  A tensor *E*
        is interpolated in the element's dtype.  A Python number is
        interpolated, and returned, in the dtype the tables are stored in
        (float32), as the reference does with a scalar energy (there a
        weakly typed scalar takes the tables' type): the Bragg angle a
        monochromator takes at creation then carries the same float32
        rounding of f1 and f2 in both packages (~1e-12 rad at Si(111),
        9 keV)."""
        dt, dev = self.Etable.dtype, self.Etable.device
        if not isinstance(E, torch.Tensor):
            tdt = self.tableDtype
            E = torch.as_tensor(E, dtype=tdt, device=dev)
            f1 = fast_interp(E, self.Etable.to(tdt), self.f1table.to(tdt))
            f2 = fast_interp(E, self.Etable.to(tdt), self.f2table.to(tdt))
            return torch.complex(f1, f2)
        E = E.to(dtype=dt, device=dev)
        f1 = fast_interp(E, self.Etable, self.f1table)
        f2 = fast_interp(E, self.Etable, self.f2table)
        return torch.complex(f1, f2)
