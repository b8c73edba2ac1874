"""Gratings for wave propagation: the blazed (sawtooth) grating.

Port of ``BlazedGrating`` of the reference package's ``oes/gratings.py``:
the sawtooth surface, its facet normals, the analytic first-facet
intersection and the illuminated fraction of a period.  The diffraction
itself comes from the Kirchhoff integral over the real surface, so the
grating takes a 'mirror'-kind material.  The ruled gratings (``Grating``
with VLS), the zone plates and the laminar gratings come with ROADMAP A8.

The facet index is floor(y / (1/rho)): the division is by a 0-dim tensor,
a true division on every device (PyTorch's CUDA division by a Python number
multiplies by the reciprocal, and a sample at a facet edge could then land
on the other facet).
"""
from __future__ import annotations

import math

import torch

from .. import config
from .base import OE


class BlazedGrating(OE):
    """Sawtooth-profile grating of *rho* lines/mm with facet angles *blaze*
    and *antiblaze* (rad)."""

    def __init__(self, blaze=None, antiblaze=math.pi * 0.4999, rho=300.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.blaze = config.number(blaze)
        self.antiblaze = config.number(antiblaze)
        self.rho = config.number(rho)

    @classmethod
    def create(cls, blaze=None, antiblaze=math.pi * 0.4999, rho=300.0,
               **kwargs):
        return super(BlazedGrating, cls).create(blaze=blaze,
                                                antiblaze=antiblaze,
                                                rho=rho, **kwargs)

    @property
    def rho_1(self):
        """The groove period, mm."""
        return 1.0 / self.rho

    def _consts(self, like):
        """(period, tan blaze, tan antiblaze) as 0-dim tensors of *like*'s
        dtype and device."""
        def T(v):
            return torch.as_tensor(v, dtype=like.dtype, device=like.device)
        return (T(1.0) / T(self.rho), torch.tan(T(self.blaze)),
                torch.tan(T(self.antiblaze)))

    def _local_pre(self, y):
        rho_1, tanB, tanA = self._consts(y)
        y0 = torch.floor(y / rho_1) * rho_1
        y1 = y0 + rho_1
        yL = y - y0
        yC = (y1 - y0) / (1 + tanA / tanB)
        return y0, y1, yC, yL, tanB, tanA

    def local_z(self, x, y):
        y0, y1, yC, yL, tanB, tanA = self._local_pre(y)
        return torch.where(yL > yC, -(y1 - y) * tanB, -yL * tanA)

    def local_n(self, x, y):
        y0, y1, yC, yL, tanB, tanA = self._local_pre(y)

        def T(v):
            return torch.as_tensor(v, dtype=y.dtype, device=y.device)
        blaze, anti = T(self.blaze), T(self.antiblaze)
        on_blaze = yL > yC
        return [torch.zeros_like(x),
                torch.where(on_blaze, -torch.sin(blaze), torch.sin(anti)),
                torch.where(on_blaze, torch.cos(blaze), torch.cos(anti))]

    def analytic_intersect(self, tMin, tMax, x, y, z, a, b, c):
        """The hit on the blaze facet of the period that holds the ray's
        z = 0 crossing (the first, illuminated facet crossing)."""
        rho_1, tanB, _ = self._consts(y)
        b_c = b / torch.where(c == 0, torch.full_like(c, -1e-12), c)
        yz = y - b_c * z
        y1 = rho_1 * torch.floor(yz / rho_1) + rho_1
        z2 = tanB * (yz - y1) / (1 - tanB * b_c)
        y2 = b_c * (z2 - z) + y
        t2 = (y2 - y) / torch.where(b == 0, torch.full_like(b, 1e-12), b)
        x2 = x + t2 * a
        return t2, x2, y2, z2, torch.zeros_like(t2, dtype=torch.bool)

    def get_grating_area_fraction(self):
        """Illuminated fraction of the period at the grating's pitch (host
        float64)."""
        rho = config.host_float(self.rho)
        rho_1 = 1.0 / rho
        tanPitch = math.tan(abs(config.host_float(self.pitch)))
        tanB = math.tan(config.host_float(self.blaze))
        y1 = rho_1 * tanB / (tanB + tanPitch)
        z1 = -y1 * tanPitch
        return math.sqrt((rho_1 - y1) ** 2 + z1 ** 2) * rho
