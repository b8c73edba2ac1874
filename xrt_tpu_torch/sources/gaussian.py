"""Analytic coherent beams: Gaussian, with Laguerre-Gaussian (``vortex=``)
and Hermite-Gaussian (``TEM=``) modes.

Port of the reference package's ``sources/gaussian.py`` (``GaussianBeam``
and its ``shine``): the complex field is evaluated on the wave samples of
a downstream element prepared by ``prepare_wave_on_*``.
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..physconsts import CHBAR
from ..transforms import rotate_xyz, virgin_local_to_global
from .geometric import make_energy, polarization_matrix


def hermite_poly(n, x):
    """Physicists' Hermite H_n(x) by recurrence."""
    if n == 0:
        return torch.ones_like(x)
    h0 = torch.ones_like(x)
    h1 = 2 * x
    for k in range(1, n):
        h0, h1 = h1, 2 * x * h1 - 2 * k * h0
    return h1


def genlaguerre_poly(p, alpha, x):
    """Generalized Laguerre L_p^alpha(x) by recurrence."""
    if p == 0:
        return torch.ones_like(x)
    l0 = torch.ones_like(x)
    l1 = 1 + alpha - x
    for k in range(1, p):
        l0, l1 = l1, ((2 * k + 1 + alpha - x) * l1 - (k + alpha) * l0) / \
            (k + 1)
    return l1


class GaussianBeam:
    """Analytic Gaussian beam evaluated at wave sample points; *w0* is the
    waist (scalar, or (wx, wz) for an astigmatic beam)."""

    def __init__(self, name='', center=(0, 0, 0), w0=0.1, distE='lines',
                 energies=(config.DEFAULT_ENERGY,), energyWeights=None,
                 polarization='horizontal', pitch=0.0, roll=0.0, yaw=0.0,
                 vortex=None, tem=None):
        self.name = name
        self.center = tuple(float(c) for c in center)
        self.w0 = tuple(float(v) for v in w0) \
            if isinstance(w0, (tuple, list)) else float(w0)
        self.distE = distE
        self.energies = tuple(float(e) for e in energies)
        self.energyWeights = energyWeights
        self.polarization = polarization
        self.pitch, self.roll, self.yaw = float(pitch), float(roll), \
            float(yaw)
        self.vortex = None if vortex is None else tuple(vortex)
        self.tem = None if tem is None else tuple(tem)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), w0=0.1, distE='lines',
               energies=(config.DEFAULT_ENERGY,), energyWeights=None,
               polarization='horizontal', pitch=0.0, roll=0.0, yaw=0.0,
               vortex=None, TEM=None):
        if distE == 'lines' and isinstance(energies, (int, float)):
            energies = (energies,)
        return cls(name=name, center=center, w0=w0, distE=distE,
                   energies=energies, energyWeights=energyWeights,
                   polarization=polarization, pitch=pitch, roll=roll,
                   yaw=yaw, vortex=vortex, tem=TEM)

    @property
    def _w0_scalar(self):
        return self.w0[0] if isinstance(self.w0, tuple) else self.w0

    def rayleigh_range(self, E, w0=None):
        w0 = self._w0_scalar if w0 is None else w0
        return E / CHBAR * 1e7 / 2 * w0 ** 2

    def w(self, y, E=None, yR=None, w0=None):
        w0 = self._w0_scalar if w0 is None else w0
        if yR is None:
            yR = self.rayleigh_range(E, w0)
        return w0 * torch.sqrt(1 + (y / yR) ** 2)

    def shine(self, generator, wave, toGlobal=True):
        """Fill *wave* (from a ``prepare_wave_on_*``) with the analytic
        field; returns the beam at the receiving points."""
        dt = wave.xDiffr.dtype
        dev = wave.xDiffr.device
        cdt = config.cdtype(dt)
        n = wave.xDiffr.shape[0]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        E = make_energy(generator, self.distE, self.energies, n,
                        self.energyWeights, dt, dev) if self.distE \
            else wave.E
        Jss0, Jpp0, Jsp0, Es0, Ep0 = polarization_matrix(self.polarization)
        Es = torch.full((n,), 0.0 if Es0 is None else Es0, dtype=cdt,
                        device=dev)
        if Ep0 is None and Es0 is not None:
            Ep = (torch.rand(n, generator=generator, dtype=torch.float64) *
                  2 ** -0.5).to(device=dev, dtype=cdt)
        else:
            Ep = torch.full((n,), 0.0 if Ep0 is None else Ep0, dtype=cdt,
                            device=dev)
        Jss = torch.full((n,), Jss0, dtype=dt, device=dev)
        Jpp = torch.full((n,), Jpp0, dtype=dt, device=dev)
        Jsp = torch.full((n,), Jsp0, dtype=cdt, device=dev)

        if self.vortex is not None:
            l, p = self.vortex
            gouy = abs(l) + 2 * p
        elif self.tem is not None:
            m, nn = self.tem
            gouy = m + nn
        else:
            gouy = 0
        k = E / CHBAR * 1e7
        xD, yD, zD = wave.xDiffr, wave.yDiffr, wave.zDiffr
        if isinstance(self.w0, tuple):   # astigmatic Gaussian
            amp = math.sqrt(2 / math.pi) * torch.exp(
                torch.complex(torch.zeros_like(yD), k * yD))
            ws = []
            for iw in range(2):
                w0 = self.w0[iw]
                yR = k / 2 * w0 ** 2
                invR = yD / (yD ** 2 + yR ** 2)
                psi = (gouy + 1) * torch.atan2(yD, yR) * 0.5
                wloc = self.w(yD, yR=yR, w0=w0)
                rSquare = xD ** 2 if iw == 0 else zD ** 2
                ws.append(wloc)
                amp = amp * wloc ** (-0.5) * torch.exp(torch.complex(
                    -rSquare / wloc ** 2, 0.5 * k * rSquare * invR - psi))
            wx, wz = ws
            w_ = wx
            rSquare = zD ** 2
        else:
            yR = k / 2 * self.w0 ** 2
            invR = yD / (yD ** 2 + yR ** 2)
            psi = (gouy + 1) * torch.atan2(yD, yR)
            w_ = self.w(yD, yR=yR)
            wx = wz = w_
            rSquare = xD ** 2 + zD ** 2
            amp = math.sqrt(2 / math.pi) / w_ * torch.exp(torch.complex(
                -rSquare / w_ ** 2, k * (yD + 0.5 * rSquare * invR) - psi))

        if self.vortex is not None:
            phi = torch.atan2(zD, xD)
            clp = math.sqrt(math.factorial(p) / math.factorial(abs(l) + p))
            amp = amp * clp * (torch.sqrt(rSquare * 2) / w_) ** abs(l) * \
                torch.exp(torch.complex(torch.zeros_like(phi), l * phi))
            if p > 0:
                amp = amp * genlaguerre_poly(p, abs(l),
                                             2 * rSquare / w_ ** 2)
        elif self.tem is not None:
            clp = (2 ** (m + nn) * math.factorial(m) *
                   math.factorial(nn)) ** (-0.5)
            amp = amp * clp
            if m > 0:
                amp = amp * hermite_poly(m, math.sqrt(2) * xD / wx)
            if nn > 0:
                amp = amp * hermite_poly(nn, math.sqrt(2) * zD / wz)

        amp = amp * torch.sqrt(wave.dS)
        Es = Es * amp
        Ep = Ep * amp
        amp2 = torch.abs(amp) ** 2
        # ray directions from the wavefront curvature, written with invR
        # directly (1/invR overflows at the waist, where invR == 0)
        a = xD * invR
        c = zD * invR
        b = torch.sqrt(torch.clamp(1.0 - a ** 2 - c ** 2, min=1e-30))
        norm = torch.sqrt(a ** 2 + b ** 2 + c ** 2)
        out = wave.replace(
            E=E, Es=Es, Ep=Ep, Jss=Jss * amp2, Jpp=Jpp * amp2,
            Jsp=Jsp * amp2, a=a / norm, b=b / norm, c=c / norm,
            x=xD, y=yD, z=zD, path=torch.sqrt(xD ** 2 + yD ** 2 + zD ** 2))
        if toGlobal:
            x2, y2, z2 = rotate_xyz(out.x, out.y, out.z, pitch=self.pitch,
                                    roll=self.roll, yaw=self.yaw)
            a2, b2, c2 = rotate_xyz(out.a, out.b, out.c, pitch=self.pitch,
                                    roll=self.roll, yaw=self.yaw)
            out = out.replace(x=x2, y=y2, z=z2, a=a2, b=b2, c=c2)
            out = virgin_local_to_global(out, self.center)
        return out
