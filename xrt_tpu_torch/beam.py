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
    def nrays(self) -> int:
        return self.x.shape[0]

    @property
    def good(self) -> Tensor:
        """The rays with state 1."""
        return self.state == STATE_GOOD

    @property
    def alive(self) -> Tensor:
        """The rays that carry flux (good or outside the optical
        limits)."""
        return self.state > 0

    @property
    def intensity(self) -> Tensor:
        return self.Jss + self.Jpp

    @property
    def flux_good(self) -> Tensor:
        """The total intensity of the good rays."""
        return torch.sum(torch.where(self.good, self.intensity, 0.0))

    def with_amplitudes(self) -> "Beam":
        """The beam with zero field amplitudes if it has none."""
        if self.Es is not None:
            return self
        zeros = torch.zeros_like(self.x, dtype=self.Jsp.dtype)
        return self.replace(Es=zeros, Ep=zeros)

    def masked_replace(self, mask, **fields) -> "Beam":
        """The beam with the listed fields replaced where *mask*."""
        return self.replace(**{name: torch.where(mask, val,
                                                 getattr(self, name))
                                for name, val in fields.items()})

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


def _map(fn, beam: Beam, *others: Beam) -> Beam:
    """*fn* over the per-ray fields (the scalars pass as they are)."""
    out = {}
    for f in dataclasses.fields(Beam):
        v = getattr(beam, f.name)
        if v is None:
            out[f.name] = None
        elif v.ndim == 0:
            out[f.name] = v
        else:
            out[f.name] = fn(v, *(getattr(o, f.name) for o in others))
    return Beam(**out)


def concatenate(b1: Beam, b2: Beam) -> Beam:
    """The rays of *b1* and then those of *b2*; scalar fields add."""
    out = {}
    for f in dataclasses.fields(Beam):
        u, v = getattr(b1, f.name), getattr(b2, f.name)
        if u is None or v is None:
            out[f.name] = None
        elif u.ndim == 0:
            out[f.name] = u + v
        else:
            out[f.name] = torch.cat([u, v])
    return Beam(**out)


def filter_by_index(beam: Beam, indarr) -> Beam:
    """Only the rays that *indarr* (indices or a boolean mask) selects."""
    indarr = torch.as_tensor(indarr, device=beam.x.device)
    return _map(lambda v: v[indarr], beam)


def filter_good(beam: Beam) -> Beam:
    """Only the rays with state 1."""
    return filter_by_index(beam, beam.state == 1)


def replace_by_index(beam: Beam, indarr, source: Beam) -> Beam:
    """The rays at *indarr* (a boolean mask or indices) taken from
    *source*."""
    indarr = torch.as_tensor(indarr, device=beam.x.device)
    if indarr.dtype == torch.bool:
        return _map(lambda a, b: torch.where(indarr, b, a), beam, source)

    def put(a, b):
        a = a.clone()
        a[indarr] = b[indarr]
        return a
    return _map(put, beam, source)


def copy_beam(beam: Beam) -> Beam:
    """An independent copy of a beam (its tensors cloned)."""
    return _map(torch.clone, beam)


def absorb_intensity(outBeam: Beam, inBeam: Beam, sign=1.0) -> Beam:
    """The coherency matrix of the power absorbed at an element: the
    incoming less the outgoing."""
    return outBeam.replace(
        Jss=(inBeam.Jss - outBeam.Jss) * sign,
        Jpp=(inBeam.Jpp - outBeam.Jpp) * sign,
        Jsp=(inBeam.Jsp - outBeam.Jsp) * sign)


def project_energy_to_band(beam: Beam, EnewMin, EnewMax) -> Beam:
    """The energies mapped linearly onto [EnewMin, EnewMax]."""
    EoldMin = torch.min(beam.E)
    EoldMax = torch.max(beam.E)
    scale = torch.where(EoldMax > EoldMin, (EnewMax - EnewMin) /
                        torch.clamp(EoldMax - EoldMin, min=1e-300), 0.0)
    return beam.replace(E=EnewMin + (beam.E - EoldMin) * scale)


def make_uniform_energy_band(beam: Beam, generator, EnewMin, EnewMax,
                             draws=None) -> Beam:
    """Energies drawn uniformly from [EnewMin, EnewMax); *draws*, uniforms
    in [0, 1), replaces the draws from *generator*."""
    if draws is None:
        draws = torch.rand(beam.E.shape, generator=generator,
                           dtype=beam.E.dtype,
                           device=generator.device).to(beam.E.device)
    return beam.replace(E=EnewMin + draws * (EnewMax - EnewMin))


def add_wave(beam: Beam, wave: Beam, sign=1.0) -> Beam:
    """The wave's amplitudes added, the coherency matrix made anew."""
    Es = beam.Es + sign * wave.Es
    Ep = beam.Ep + sign * wave.Ep
    return beam.replace(
        Es=Es, Ep=Ep,
        Jss=(Es * Es.conj()).real, Jpp=(Ep * Ep.conj()).real,
        Jsp=Es * Ep.conj())
