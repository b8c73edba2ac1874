"""Amorphous materials: refractive index, absorption and Fresnel
amplitudes.

Port of ``Material`` from the reference package's
``materials/material.py`` for the mirror kinds ('mirror', 'thin mirror',
'grating'), whose Fresnel reflectivity the mirrors need, and as the base
of the crystals (``materials/crystal.py``: kind 'crystal', which needs the
refractive index and the absorption coefficient).  The transmitting kinds,
tabulated refractive-index files and grating-efficiency tables come with
later slices (ROADMAP A8).
"""
from __future__ import annotations

import torch

from .. import config
from ..physconsts import AVOGADRO, CH, CHBAR, PI2, R0
from .element import Element

_MIRROR_KINDS = ('mirror', 'thin mirror', 'grating')


class Material:
    """A material given by chemical formula and density.

    *kind*: 'mirror', 'thin mirror' or 'grating' ('auto' resolves to the
    hosting element's preference).  *rho* in
    g/cm^3, *t* thickness in mm (for 'thin mirror')."""

    def __init__(self, elements, quantities, rho, t=None, kind='auto',
                 name='', table='Chantler total', refractiveIndex=None):
        self.elements = elements
        self.quantities = quantities
        self.rho = rho
        self.t = t
        self.kind = kind
        self.name = name
        self.table = table
        self.refractiveIndex = refractiveIndex

    @classmethod
    def create(cls, elements, quantities=None, kind='auto', rho=0.0, t=None,
               table='Chantler total', name='', refractiveIndex=None,
               dtype=None, device=None):
        dt = config.resolve_dtype(dtype)
        dev = config.resolve_device(device)
        if isinstance(elements, str):
            elements = (elements,)
        els = tuple(Element.create(e, table, dtype=dt, device=dev)
                    for e in elements)
        if quantities is None:
            quantities = [1.0] * len(els)
        if name == '':
            name = ''.join(el.name for el in els)
        return cls(els, tuple(float(q) for q in quantities), float(rho),
                   t=None if t is None else float(t), kind=kind, name=name,
                   table=table,
                   refractiveIndex=None if refractiveIndex is None
                   else complex(refractiveIndex))

    @property
    def mass(self):
        """Molar mass of the formula unit, g/mol."""
        return sum(q * e.mass for q, e in zip(self.quantities,
                                             self.elements))

    def resolved_kind(self, default='mirror') -> str:
        return default if self.kind == 'auto' else self.kind

    def get_refractive_index(self, E):
        """n(E) = 1 - r0 lambda^2 N_A rho / (2 pi M) sum_i x_i f_i(0)."""
        cdt = config.cdtype(E.dtype)
        if self.refractiveIndex is not None:
            return torch.full(E.shape, self.refractiveIndex, dtype=cdt,
                              device=E.device)
        xf = torch.zeros(E.shape, dtype=cdt, device=E.device)
        for elem, xi in zip(self.elements, self.quantities):
            xf = xf + (elem.Z + elem.get_f1f2(E)) * xi
        return 1 - 1e-24 * AVOGADRO * R0 / PI2 * (CH / E) ** 2 * \
            self.rho * xf / self.mass  # 1e-24 = A^3/cm^3

    def get_absorption_coefficient(self, E):
        """Linear absorption coefficient mu = 2 Im(n) k, 1/cm."""
        return torch.abs(self.get_refractive_index(E).imag) * E / CHBAR * 2e8

    def get_amplitude(self, E, beamInDotNormal, fromVacuum=True):
        """Fresnel amplitude reflectivity for s and p: (rs, rp,
        mu [1/cm], refraction phase [1/cm])."""
        kind = self.resolved_kind()
        if kind not in _MIRROR_KINDS:
            raise NotImplementedError(
                f'material kind {kind!r} of {self.name} is not ported yet '
                '(ROADMAP A8)')
        n = self.get_refractive_index(E)
        one_c = torch.ones_like(n)
        n1, n2 = (one_c, n) if fromVacuum else (n, one_c)
        cosAlpha = torch.abs(beamInDotNormal)
        sinAlpha2 = torch.clamp(1 - beamInDotNormal ** 2, min=0.0)
        n1cosAlpha = n1 * cosAlpha
        q = (n1 / n2) ** 2 * sinAlpha2
        cosBeta = torch.sqrt(torch.complex(1 - q.real, -q.imag))
        n2cosBeta = n2 * cosBeta
        rs = (n1cosAlpha - n2cosBeta) / (n1cosAlpha + n2cosBeta)
        rp = (n2 * cosAlpha - n1 * cosBeta) / (n2 * cosAlpha + n1 * cosBeta)
        if kind == 'thin mirror':
            arg = 2 * E / CHBAR * n2cosBeta * self.t * 1e7
            p2 = torch.exp(torch.complex(-arg.imag, arg.real))
            rs = rs * (1 - p2) / (1 - rs ** 2 * p2)
            rp = rp * (1 - p2) / (1 - rp ** 2 * p2)
        return (rs, rp, torch.abs(n.imag) * E / CHBAR * 2e8,
                n.real * E / CHBAR * 1e8)
