"""Amorphous materials: refractive index, absorption and Fresnel
amplitudes.

Port of ``Material`` and ``EmptyMaterial`` from the reference package's
``materials/material.py``: the Fresnel reflectivity of the mirror kinds
('mirror', 'thin mirror', 'grating'), the transmittivity of the
transmitting kinds ('plate', 'lens'; a zone plate's 'FZP' has unit
amplitudes), tabulated grating efficiencies by order (constant or from an
energy table), and the base of the crystals (``materials/crystal.py``:
kind 'crystal', which needs the refractive index and the absorption
coefficient), and the refractive index from a constant or from a
table (``read_ri_file``).

The transmitting kinds square by products and divide tensors by tensors:
PyTorch takes a complex ``z ** 2`` through exp and log and a Python number
over a tensor as a reciprocal times the number (ROADMAP C12).  The mirror
kinds keep the formulas their tests hold.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..ops.interp import fast_interp
from ..physconsts import AVOGADRO, CH, CHBAR, PI2, R0
from .element import Element

_MIRROR_KINDS = ('mirror', 'thin mirror', 'grating')
_TRANSMIT_KINDS = ('plate', 'lens', 'FZP')


class Material:
    """A material given by chemical formula and density.

    *kind*: 'mirror', 'thin mirror', 'grating', 'plate', 'lens' or 'FZP'
    ('auto' resolves to the hosting element's preference).  *rho* in
    g/cm^3, *t* thickness in mm (for 'thin mirror').  A grating's
    tabulated efficiency: *efficiency_orders*, a tuple of orders, and
    *efficiency_I*, a tensor of their efficiencies, (n_orders,) or, over
    the energies *efficiency_E*, (n_orders, nE)."""

    def __init__(self, elements, quantities, rho, t=None, kind='auto',
                 name='', table='Chantler total', refractiveIndex=None,
                 efficiency_orders=(), efficiency_I=None,
                 efficiency_E=None, riE=None, riN=None):
        self.elements = elements
        self.quantities = quantities
        self.rho = rho
        self.t = t
        self.kind = kind
        self.name = name
        self.table = table
        self.refractiveIndex = refractiveIndex
        self.riE, self.riN = riE, riN
        self.efficiency_orders = efficiency_orders
        self.efficiency_I = efficiency_I
        self.efficiency_E = efficiency_E

    @classmethod
    def create(cls, elements, quantities=None, kind='auto', rho=0.0, t=None,
               table='Chantler total', name='', refractiveIndex=None,
               refractiveIndexFile=None, efficiency=None,
               efficiencyFile=None, dtype=None, device=None):
        """The reference's constructor arguments.  *refractiveIndex*, a
        complex number, replaces the tabulated scattering factors;
        *refractiveIndexFile*, a table read by ``read_ri_file``, gives n(E)
        by interpolation.  *efficiency*: a list of (order, efficiency)
        pairs or, with *efficiencyFile* (a text table whose column 0 is
        the energy), (order, 1-based column)."""
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
        riE = riN = None
        if refractiveIndexFile is not None:
            E_tab, n_tab = cls.read_ri_file(refractiveIndexFile)
            riE = torch.as_tensor(E_tab, dtype=dt, device=dev)
            riN = torch.complex(
                torch.as_tensor(n_tab.real, dtype=dt, device=dev),
                torch.as_tensor(n_tab.imag, dtype=dt, device=dev))
        eff_orders = ()
        eff_I = eff_E = None
        if efficiency is not None:
            eff_orders = tuple(int(o) for o, _ in efficiency)
            if efficiencyFile is None:
                eff_I = torch.tensor([float(v) for _, v in efficiency],
                                     dtype=dt, device=dev)
            else:
                data = np.loadtxt(efficiencyFile)
                eff_E = torch.as_tensor(np.ascontiguousarray(data[:, 0]),
                                        dtype=dt, device=dev)
                eff_I = torch.as_tensor(
                    np.stack([data[:, int(v)] for _, v in efficiency]),
                    dtype=dt, device=dev)
        return cls(els, tuple(float(q) for q in quantities), float(rho),
                   t=None if t is None else float(t), kind=kind, name=name,
                   table=table,
                   refractiveIndex=None if refractiveIndex is None
                   else complex(refractiveIndex),
                   efficiency_orders=eff_orders, efficiency_I=eff_I,
                   efficiency_E=eff_E, riE=riE, riN=riN)

    @staticmethod
    def read_ri_file(fname):
        """A refractive-index table (comma-separated, as
        refractiveindex.info writes it: rows of (E, n) and rows of
        (E, n, k) or (E, , k), header lines skipped).  Returns (E [eV],
        complex n) as numpy arrays, k interpolated onto the energies of
        n."""
        En, Ek, n, k = [], [], [], []
        with open(fname) as f:
            for li in f:
                fields = li.split(',')
                try:
                    float(fields[0])
                except ValueError:
                    continue
                if len(fields) < 3:
                    En.append(float(fields[0]))
                    n.append(float(fields[-1]))
                else:
                    Ek.append(float(fields[0]))
                    k.append(float(fields[-1]))
                    if len(fields[1].strip()) > 0:
                        En.append(float(fields[0]))
                        n.append(float(fields[1]))
        En = np.asarray(En)
        kk = np.interp(En, np.asarray(Ek), np.asarray(k)) if Ek else \
            np.zeros_like(En)
        return En, np.asarray(n) + 1j * kk

    @property
    def mass(self):
        """Molar mass of the formula unit, g/mol."""
        return sum(q * e.mass for q, e in zip(self.quantities,
                                             self.elements))

    def resolved_kind(self, default='mirror') -> str:
        return default if self.kind == 'auto' else self.kind

    def get_grating_efficiency(self, E, order):
        """(ampS, ampP) of each ray from the tabulated efficiency of its
        diffraction *order* (interpolated in energy for a table); 0 for an
        order that is not tabulated."""
        resI = torch.zeros_like(E)
        for i, o in enumerate(self.efficiency_orders):
            if self.efficiency_E is None:
                val = self.efficiency_I[i]
            else:
                val = fast_interp(E, self.efficiency_E, self.efficiency_I[i])
            resI = torch.where(order == o, val, resI)
        amp = sqrt_rn(torch.clamp(resI, min=0.0))
        return amp, amp

    def _mass(self, dtype, device):
        """The molar mass as the reference sums it in *dtype*: the products
        q_i m_i added in order, as a 0-dim tensor."""
        m = None
        for q, e in zip(self.quantities, self.elements):
            t = config.scalar(q, dtype, device) * \
                config.scalar(e.mass, dtype, device)
            m = t if m is None else m + t
        return m

    def get_refractive_index(self, E):
        """n(E) = 1 - r0 lambda^2 N_A rho / (2 pi M) sum_i x_i f_i(0), the
        constant *refractiveIndex*, or the tabulated one interpolated in
        energy.  The reference's operations in its order: lambda by a true
        division, its square by a product, and the complex sum scaled and
        divided part by part (a complex division by a real number would
        take a reciprocal).  A Python-number *E* is evaluated in the
        material's dtype, its f1 and f2 in the tables' float32, as the
        reference takes a weakly typed scalar."""
        f1f2E = E
        if not isinstance(E, torch.Tensor):
            el = self.elements[0].Etable if self.elements else self.riE
            E = config.scalar(E, el.dtype, el.device)
        cdt = config.cdtype(E.dtype)
        if self.refractiveIndex is not None:
            return torch.full(E.shape, self.refractiveIndex, dtype=cdt,
                              device=E.device)
        if self.riE is not None:
            return torch.complex(fast_interp(E, self.riE, self.riN.real),
                                 fast_interp(E, self.riE, self.riN.imag))
        xf = torch.zeros(E.shape, dtype=cdt, device=E.device)
        for elem, xi in zip(self.elements, self.quantities):
            xf = xf + (elem.Z + elem.get_f1f2(f1f2E)).to(cdt) * xi
        lam = config.scalar(CH, E.dtype, E.device) / E
        # 1e-24 = A^3/cm^3
        scale = config.scalar(1e-24 * AVOGADRO * R0 / PI2, E.dtype,
                              E.device) * (lam * lam) * \
            config.scalar(self.rho, E.dtype, E.device)
        mass = self._mass(E.dtype, E.device)
        return torch.complex(1 - scale * xf.real / mass,
                             -(scale * xf.imag / mass))

    def get_absorption_coefficient(self, E):
        """Linear absorption coefficient mu = 2 Im(n) k, 1/cm."""
        return torch.abs(self.get_refractive_index(E).imag) * E / CHBAR * 2e8

    def get_amplitude(self, E, beamInDotNormal, fromVacuum=True):
        """Fresnel amplitude reflectivity (the mirror kinds) or
        transmittivity (the transmitting kinds) for s and p: (rs, rp,
        mu [1/cm], refraction phase [1/cm])."""
        kind = self.resolved_kind()
        if kind == 'FZP':
            one = torch.ones_like(E)
            return one, one, torch.zeros_like(one), torch.zeros_like(one)
        if kind not in _MIRROR_KINDS + _TRANSMIT_KINDS:
            raise ValueError(f'unknown material kind {kind!r} of '
                             f'{self.name}')
        n = self.get_refractive_index(E)
        one_c = torch.ones_like(n)
        n1, n2 = (one_c, n) if fromVacuum else (n, one_c)
        cosAlpha = torch.abs(beamInDotNormal)
        sinAlpha2 = torch.clamp(1 - beamInDotNormal ** 2, min=0.0)
        n1cosAlpha = n1 * cosAlpha
        if kind in _MIRROR_KINDS:
            q = (n1 / n2) ** 2 * sinAlpha2
        else:
            r12 = n1 / n2
            q = r12 * r12 * sinAlpha2
        cosBeta = torch.sqrt(torch.complex(1 - q.real, -q.imag))
        n2cosBeta = n2 * cosBeta
        if kind in _MIRROR_KINDS:
            rs = (n1cosAlpha - n2cosBeta) / (n1cosAlpha + n2cosBeta)
            rp = (n2 * cosAlpha - n1 * cosBeta) / \
                (n2 * cosAlpha + n1 * cosBeta)
            if kind == 'thin mirror':
                arg = 2 * E / CHBAR * n2cosBeta * self.t * 1e7
                p2 = torch.exp(torch.complex(-arg.imag, arg.real))
                rs = rs * (1 - p2) / (1 - rs ** 2 * p2)
                rp = rp * (1 - p2) / (1 - rp ** 2 * p2)
        else:
            tf = sqrt_rn((n2cosBeta * n1.conj()).real /
                         torch.clamp(cosAlpha, min=1e-300)) / torch.abs(n1)
            two = 2 * n1cosAlpha
            rs = two / (n1cosAlpha + n2cosBeta) * tf
            rp = two / (n2 * cosAlpha + n1 * cosBeta) * tf
        return (rs, rp, torch.abs(n.imag) * E / CHBAR * 2e8,
                n.real * E / CHBAR * 1e8)


class EmptyMaterial:
    """A geometry-only material (a grating whose efficiency is given
    elsewhere): unit amplitudes, refractive index 1, no absorption."""

    def __init__(self, kind='mirror', name='None'):
        self.kind = kind
        self.name = name

    def resolved_kind(self, default='mirror') -> str:
        return default if self.kind == 'auto' else self.kind

    def get_refractive_index(self, E):
        return torch.complex(torch.ones_like(E), torch.zeros_like(E))

    def get_absorption_coefficient(self, E):
        return torch.zeros_like(E)

    def get_amplitude(self, E, beamInDotNormal, fromVacuum=True):
        one = torch.ones_like(E)
        zero = torch.zeros_like(one)
        return one, one, zero, zero
