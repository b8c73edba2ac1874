"""The toroidal mirror of the wave chain, with the Coddington helpers.
Port of ``ToroidMirror`` from the reference package's
``oes/mirrors.py``."""
from __future__ import annotations

import math

import torch

from .base import OE


def rmer_from_coddington(p, q, pitch):
    """Meridional radius 2pq/(p+q)/sin(pitch)."""
    return 2 * p * q / (p + q) / math.sin(abs(pitch))


def rsag_from_coddington(p, q, pitch):
    """Sagittal radius 2pq/(p+q)*sin(pitch)."""
    return 2 * p * q / (p + q) * math.sin(abs(pitch))


def _resolve_R(R, pitch):
    if isinstance(R, (tuple, list)):
        if len(R) == 3:
            return rmer_from_coddington(R[0], R[1], R[2])
        return rmer_from_coddington(R[0], R[1], pitch)
    if R in (0, None):
        return 1e100
    return float(R)


def _resolve_r(r, pitch):
    if isinstance(r, (tuple, list)):
        if len(r) == 3:
            return rsag_from_coddington(r[0], r[1], r[2])
        return rsag_from_coddington(r[0], r[1], pitch)
    if r in (0, None):
        return 1e100
    return float(r)


class ToroidMirror(OE):
    """Toroidal mirror with meridional radius R and sagittal radius r."""

    def __init__(self, R=5.0e6, r=50.0, **kwargs):
        super().__init__(**kwargs)
        self.R = R
        self.r = r

    @classmethod
    def create(cls, R=5.0e6, r=50.0, pitch=0.0, **kwargs):
        return super(ToroidMirror, cls).create(
            pitch=pitch, R=_resolve_R(R, pitch), r=_resolve_r(r, pitch),
            **kwargs)

    def local_z(self, x, y):
        rx = torch.clamp(1 - (x / self.r) ** 2, min=0.0)
        return y ** 2 / 2.0 / self.R + self.r * (1 - torch.sqrt(rx))

    def local_n(self, x, y):
        rx = 1 - (x / self.r) ** 2
        ax = torch.where(rx <= 0, torch.zeros_like(rx),
                         1.0 / torch.sqrt(torch.clamp(rx, min=1e-30)))
        a = -x / self.r * ax
        b = -y / self.R
        norm = torch.sqrt(a ** 2 + b ** 2 + 1)
        return [a / norm, b / norm, 1.0 / norm]

