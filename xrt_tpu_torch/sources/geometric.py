"""Sampling helpers of the geometric sources: energy distributions and
named polarizations.

Port of ``make_energy`` and ``polarization_matrix`` from the reference
package's ``sources/geometric.py``; the geometric source itself belongs to
the ray-trace slice.  Random draws take an explicit ``torch.Generator``
(on the CPU, so a seed gives the same draw on any device).
"""
from __future__ import annotations

import math

import torch


def make_energy(generator, distE, energies, nrays, energyWeights=None,
                dtype=torch.float32, device='cpu'):
    """Sample the energy distribution: *distE* is 'normal'
    ((center, sigma)), 'flat' ((min, max)) or 'lines' (a sequence of E with
    optional weights)."""
    energies = torch.as_tensor(energies, dtype=torch.float64).reshape(-1)
    if distE == 'normal':
        E = energies[0] + energies[1] * torch.randn(
            nrays, generator=generator, dtype=torch.float64)
    elif distE == 'flat':
        E = energies[0] + (energies[1] - energies[0]) * torch.rand(
            nrays, generator=generator, dtype=torch.float64)
    elif distE == 'lines':
        if energies.shape[0] == 1:
            E = energies.expand(nrays)
        else:
            w = torch.ones_like(energies) if energyWeights is None else \
                torch.as_tensor(energyWeights, dtype=torch.float64)
            idx = torch.multinomial(w / torch.sum(w), nrays,
                                    replacement=True, generator=generator)
            E = energies[idx]
    else:
        raise ValueError(f'unknown distE {distE!r}')
    return E.to(device=device, dtype=dtype)


def polarization_matrix(polarization):
    """(Jss, Jpp, Jsp, Es, Ep) scalars for the named polarization.  For
    unpolarized light Es = 1/sqrt(2) and Ep (None) carries a random phase
    applied by the caller when amplitudes are requested."""
    if polarization is None:
        return 0.5, 0.5, 0j, 2 ** -0.5, None
    if isinstance(polarization, (tuple, list)) and len(polarization) == 4:
        Jss, Jpp, ReJsp, ImJsp = polarization
        return float(Jss), float(Jpp), ReJsp + 1j * ImJsp, None, None
    if isinstance(polarization, str):
        p = polarization.lower()
        if p.startswith('un'):
            return 0.5, 0.5, 0j, 2 ** -0.5, None
        if p.startswith('r'):
            return 0.5, 0.5, 0.5j, 2 ** -0.5, -1j * 2 ** -0.5
        if p.startswith('l'):
            return 0.5, 0.5, -0.5j, 2 ** -0.5, 1j * 2 ** -0.5
        if p.startswith('h'):
            angle = 0.0
        elif p.startswith('v'):
            angle = math.pi / 2
        else:
            angle = math.radians(float(p))
    else:
        angle = math.radians(float(polarization))
    Es = math.cos(angle)
    Ep = math.sin(angle)
    return Es * Es, Ep * Ep, complex(Es * Ep), Es, Ep
