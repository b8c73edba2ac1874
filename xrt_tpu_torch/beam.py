"""The Beam — a dataclass of per-ray tensors.

Port of ``xrt_tpu/beam.py``.  Shapes are static: rays are never filtered
by boolean indexing; the integer ``state`` tensor masks dead rays.
Coordinates are in mm, (a, b, c) is the unit direction, E the photon
energy in eV, ``path`` the accumulated path length in mm.  Polarization is
carried by the coherency matrix (Jss, Jpp, Jsp with Jsp complex) and
optionally by complex field amplitudes (Es, Ep).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from . import config
from .config import STATE_GOOD
from .physconsts import CHBAR

Tensor = torch.Tensor


@dataclass
class Beam:
    x: Tensor
    y: Tensor
    z: Tensor
    a: Tensor
    b: Tensor
    c: Tensor
    E: Tensor
    state: Tensor
    path: Tensor
    Jss: Tensor
    Jpp: Tensor
    Jsp: Tensor
    Es: Optional[Tensor] = None
    Ep: Optional[Tensor] = None
    # incidence angle at the last OE (rad, from surface) and grating order
    theta: Optional[Tensor] = None
    order: Optional[Tensor] = None
    # number of reflections in multiple-reflection elements
    nRefl: Optional[Tensor] = None
    # parametric coordinates of the last impact point (parametric OEs)
    s: Optional[Tensor] = None
    phi: Optional[Tensor] = None
    r: Optional[Tensor] = None
    # accumulated flux bookkeeping for Monte-Carlo sources (scalars)
    accepted: Optional[Tensor] = None
    acceptedE: Optional[Tensor] = None
    seeded: Optional[Tensor] = None
    seededI: Optional[Tensor] = None
    # receiving-surface data for wave propagation (set by prepare_wave)
    area: Optional[Tensor] = None       # total receiving area, mm^2
    dS: Optional[Tensor] = None         # per-sample area elements, mm^2

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    @property
    def degree_of_polarization(self) -> Tensor:
        from .ops.dd import sqrt_rn
        I = self.Jss + self.Jpp
        det = self.Jss * self.Jpp - torch.abs(self.Jsp) ** 2
        return sqrt_rn(torch.clamp(
            1.0 - 4.0 * det / torch.clamp(I, min=1e-300) ** 2, 0.0, 1.0))


def new_beam(nrays: int, energy: float = None, withAmplitudes=False,
             dtype=None, device=None) -> Beam:
    """A fresh beam of ``nrays`` rays pointing along +y, s-polarized."""
    if energy is None:
        energy = config.DEFAULT_ENERGY
    dt = config.resolve_dtype(dtype)
    dev = config.resolve_device(device)
    cdt = config.cdtype(dt)
    z = torch.zeros(nrays, dtype=dt, device=dev)
    cz = torch.zeros(nrays, dtype=cdt, device=dev)
    return Beam(
        x=z, y=z, z=z, a=z, b=torch.ones(nrays, dtype=dt, device=dev), c=z,
        E=torch.full((nrays,), energy, dtype=dt, device=dev),
        state=torch.full((nrays,), STATE_GOOD, dtype=torch.int32,
                         device=dev),
        path=z, Jss=torch.ones(nrays, dtype=dt, device=dev), Jpp=z, Jsp=cz,
        Es=cz if withAmplitudes else None,
        Ep=cz if withAmplitudes else None)


def rotate_coherency_matrix(Jss, Jpp, Jsp, roll):
    """Rotate the 2x2 coherency matrix by angle ``roll`` about the beam
    axis, J' = R J R^-1 (cf. reference beams.py:394-425)."""
    c = torch.cos(roll) if isinstance(roll, Tensor) else \
        torch.cos(torch.as_tensor(roll, dtype=Jss.dtype, device=Jss.device))
    s = torch.sin(roll) if isinstance(roll, Tensor) else \
        torch.sin(torch.as_tensor(roll, dtype=Jss.dtype, device=Jss.device))
    c2, s2, cs = c * c, s * s, c * s
    JssN = Jss * c2 + Jpp * s2 + 2 * Jsp.real * cs
    JppN = Jss * s2 + Jpp * c2 - 2 * Jsp.real * cs
    JspN = torch.complex((Jpp - Jss) * cs + Jsp.real * (c2 - s2), Jsp.imag)
    return JssN, JppN, JspN


def propagated_amplitudes(beam: Beam, path) -> dict:
    """{Es, Ep} of *beam* advanced by *path* mm, with the propagation
    phase exp(1e7j * k * path) (path mm -> A); {} for a beam without
    amplitudes."""
    if beam.Es is None:
        return {}
    arg = 1e7 * (beam.E / CHBAR) * path
    propPhase = torch.complex(torch.cos(arg), torch.sin(arg))
    return dict(Es=beam.Es * propPhase, Ep=beam.Ep * propPhase)
