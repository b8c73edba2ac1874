"""Analytic coherent beams: Gaussian, with Laguerre-Gaussian (``vortex=``)
and Hermite-Gaussian (``TEM=``) modes; mesh sources.

Port of the reference package's ``sources/gaussian.py``: ``GaussianBeam``
and its ``shine`` (the complex field on the wave samples of a downstream
element prepared by ``prepare_wave_on_*``), ``LaguerreGaussianBeam``,
``HermiteGaussianBeam``, the deterministic ray meshes ``MeshSource``,
``NESWSource`` and ``CollimatedMeshSource``, and ``shrink_source``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..beam import Beam
from ..ops.dd import sqrt_rn
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


class GaussianBeam(config.Replaceable):
    """Analytic Gaussian beam evaluated at wave sample points; *w0* is the
    waist (scalar, or (wx, wz) for an astigmatic beam).  The waist, the
    centre and the angles are Python floats, or the tensors that were
    passed in: ``shine`` is then differentiable with respect to them."""

    def __init__(self, name='', center=(0, 0, 0), w0=0.1, distE='lines',
                 energies=(config.DEFAULT_ENERGY,), energyWeights=None,
                 polarization='horizontal', pitch=0.0, roll=0.0, yaw=0.0,
                 vortex=None, tem=None):
        self.name = name
        self.center = tuple(config.number(c) for c in center)
        self.w0 = tuple(config.number(v) for v in w0) \
            if isinstance(w0, (tuple, list)) else config.number(w0)
        self.distE = distE
        self.energies = tuple(float(e) for e in energies)
        self.energyWeights = energyWeights
        self.polarization = polarization
        self.pitch, self.roll, self.yaw = (config.number(pitch),
                                           config.number(roll),
                                           config.number(yaw))
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


def LaguerreGaussianBeam(vortex=(1, 0), **kwargs):
    """A Laguerre-Gaussian beam: vortex=(l, p)."""
    return GaussianBeam.create(vortex=vortex, **kwargs)


def HermiteGaussianBeam(TEM=(0, 0), **kwargs):
    """A Hermite-Gaussian beam of order TEM=(m, n)."""
    return GaussianBeam.create(TEM=TEM, **kwargs)


def _flat_beam(x, z, a, c, E, polarization, flux, dtype, device):
    """A Beam from its (n,) positions x, z (y = 0) and directions a, c."""
    n = a.shape[0]
    cdt = config.cdtype(dtype)
    Jss0, Jpp0, Jsp0, _, _ = polarization_matrix(polarization)
    return Beam(x=x, y=torch.zeros(n, dtype=dtype, device=device), z=z,
                a=a, b=sqrt_rn(torch.clamp(1 - a ** 2 - c ** 2, min=0.0)),
                c=c, E=E,
                state=torch.ones(n, dtype=torch.int32, device=device),
                path=torch.zeros(n, dtype=dtype, device=device),
                Jss=flux * Jss0, Jpp=flux * Jpp0, Jsp=(flux * Jsp0).to(cdt))


class MeshSource(config.Replaceable):
    """A point source of a rectangular angular mesh of rays (*nx* x *nz*
    directions from (minxprime, minzprime) to (maxxprime, maxzprime));
    *withCentralRay* puts an axial ray first; *compass* gives the four
    rays N, E, S, W instead (``NESWSource``); *fluxes* a flux a node."""

    def __init__(self, name='', center=(0, 0, 0), minxprime=-1e-4,
                 maxxprime=1e-4, minzprime=-1e-4, maxzprime=1e-4, nx=11,
                 nz=11, distE='lines', energies=(config.DEFAULT_ENERGY,),
                 energyWeights=None, polarization='horizontal',
                 withCentralRay=True, fluxes=None, compass=False,
                 dtype=None, device=None):
        self.name = name
        self.center = tuple(float(c) for c in center)
        self.minxprime, self.maxxprime = float(minxprime), float(maxxprime)
        self.minzprime, self.maxzprime = float(minzprime), float(maxzprime)
        self.nx, self.nz = int(nx), int(nz)
        self.distE = distE
        self.energies = tuple(float(e) for e in energies)
        self.energyWeights = energyWeights
        self.polarization = polarization
        self.withCentralRay, self.compass = withCentralRay, compass
        self.fluxes = fluxes
        self.dtype = config.resolve_dtype(dtype)
        self.device = config.resolve_device(device)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), minxprime=-1e-4,
               maxxprime=1e-4, minzprime=-1e-4, maxzprime=1e-4, nx=11,
               nz=11, distE='lines', energies=(config.DEFAULT_ENERGY,),
               energyWeights=None, polarization='horizontal',
               withCentralRay=True, fluxes=None, compass=False, dtype=None,
               device=None):
        if distE == 'lines' and isinstance(energies, (int, float)):
            energies = (energies,)
        return cls(name, center, minxprime, maxxprime, minzprime, maxzprime,
                   nx, nz, distE, energies, energyWeights, polarization,
                   withCentralRay, fluxes, compass, dtype, device)

    @property
    def nrays(self):
        if self.compass:
            return 4 + int(self.withCentralRay)
        return self.nx * self.nz + int(self.withCentralRay)

    def shine(self, generator=None, toGlobal=True) -> Beam:
        dt, dev = self.dtype, self.device
        if self.compass:
            a = [0.0, self.maxxprime, 0.0, self.minxprime]
            c = [self.maxzprime, 0.0, self.minzprime, 0.0]
        else:
            XP, ZP = np.meshgrid(
                np.linspace(self.minxprime, self.maxxprime, self.nx),
                np.linspace(self.minzprime, self.maxzprime, self.nz))
            a, c = list(XP.ravel()), list(ZP.ravel())
        if self.withCentralRay:
            a, c = [0.0] + a, [0.0] + c
        a = torch.tensor(a, dtype=dt, device=dev)
        c = torch.tensor(c, dtype=dt, device=dev)
        n = a.shape[0]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        E = make_energy(generator, self.distE, self.energies, n,
                        self.energyWeights, dt, dev) if self.distE else \
            torch.full((n,), config.DEFAULT_ENERGY, dtype=dt, device=dev)
        flux = torch.ones(n, dtype=dt, device=dev) if self.fluxes is None \
            else torch.as_tensor(self.fluxes, dtype=dt, device=dev)
        zero = torch.zeros(n, dtype=dt, device=dev)
        beam = _flat_beam(zero, zero, a, c, E, self.polarization, flux, dt,
                          dev)
        return virgin_local_to_global(beam, self.center) if toGlobal \
            else beam


def NESWSource(name='', center=(0, 0, 0), dxprime=1e-4, dzprime=1e-4,
               **kwargs):
    """Four rays: north (up), east (right), south (down), west (left)."""
    return MeshSource.create(
        name=name, center=center, minxprime=-dxprime, maxxprime=dxprime,
        minzprime=-dzprime, maxzprime=dzprime, nx=2, nz=2,
        withCentralRay=False, compass=True, **kwargs)


class CollimatedMeshSource(config.Replaceable):
    """A collimated source: a rectangular positional mesh (*nx* x *nz*
    over *dx* x *dz* mm) of parallel rays."""

    def __init__(self, name='', center=(0, 0, 0), dx=1.0, dz=1.0, nx=11,
                 nz=11, distE='lines', energies=(config.DEFAULT_ENERGY,),
                 polarization='horizontal', dtype=None, device=None):
        self.name = name
        self.center = tuple(float(c) for c in center)
        self.dx, self.dz = float(dx), float(dz)
        self.nx, self.nz = int(nx), int(nz)
        self.distE = distE
        self.energies = tuple(float(e) for e in energies)
        self.polarization = polarization
        self.dtype = config.resolve_dtype(dtype)
        self.device = config.resolve_device(device)

    @classmethod
    def create(cls, name='', center=(0, 0, 0), dx=1.0, dz=1.0, nx=11,
               nz=11, distE='lines', energies=(config.DEFAULT_ENERGY,),
               polarization='horizontal', dtype=None, device=None):
        if distE == 'lines' and isinstance(energies, (int, float)):
            energies = (energies,)
        return cls(name, center, dx, dz, nx, nz, distE, energies,
                   polarization, dtype, device)

    def shine(self, generator=None, toGlobal=True) -> Beam:
        dt, dev = self.dtype, self.device
        X, Z = np.meshgrid(np.linspace(-self.dx / 2, self.dx / 2, self.nx),
                           np.linspace(-self.dz / 2, self.dz / 2, self.nz))
        x = torch.tensor(X.ravel(), dtype=dt, device=dev)
        z = torch.tensor(Z.ravel(), dtype=dt, device=dev)
        n = x.shape[0]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        E = make_energy(generator, self.distE, self.energies, n, None, dt,
                        dev)
        zero = torch.zeros(n, dtype=dt, device=dev)
        beam = _flat_beam(x, z, zero, zero, E, self.polarization,
                          torch.ones(n, dtype=dt, device=dev), dt, dev)
        return virgin_local_to_global(beam, self.center) if toGlobal \
            else beam


def shrink_source(trace_fn, beams, minxprime, maxxprime, minzprime,
                  maxzprime, nx, nz, center=(0, 0, 0), dtype=None,
                  device=None):
    """The :class:`MeshSource` whose divergence window, shrunk from the
    one given, puts every ray of the footprint(s) *beams* on the optical
    surfaces.  *trace_fn(source) -> {name: Beam}* traces the beamline with
    the probe source.  The four compass rays must land first; then the
    mesh's edge rows and columns with the largest share of lost rays are
    peeled until none is lost, with one more step of margin."""
    if not isinstance(beams, (tuple, list)):
        beams = (beams,)
    kw = dict(dtype=dtype, device=device)
    mesh = None
    for ibeam in beams:
        nesw = NESWSource(center=center, dxprime=maxxprime * 0.1,
                          dzprime=maxzprime * 0.1, **kw)
        if (trace_fn(nesw)[ibeam].state != 1).any():
            raise ValueError('cannot shrink the source: the NESW probe '
                             'rays miss the surface')
        mesh = MeshSource.create(
            center=center, minxprime=minxprime, maxxprime=maxxprime,
            minzprime=minzprime, maxzprime=maxzprime, nx=nx, nz=nz, **kw)
        state = trace_fn(mesh)[ibeam].state.cpu().numpy()
        view = (state[1:] if mesh.withCentralRay else state) \
            .reshape(nz, nx) != 1
        dxp = (maxxprime - minxprime) / (nx - 1)
        dzp = (maxzprime - minzprime) / (nz - 1)
        cut = dict(zlo=0, zhi=0, xlo=0, xhi=0)
        while view.size and view.sum() > 0:
            share = {'zlo': view[0].sum() / view.shape[1],
                     'zhi': view[-1].sum() / view.shape[1],
                     'xlo': view[:, 0].sum() / view.shape[0],
                     'xhi': view[:, -1].sum() / view.shape[0]}
            side = max(share, key=share.get)
            cut[side] += 1
            view = {'zlo': view[1:], 'zhi': view[:-1], 'xlo': view[:, 1:],
                    'xhi': view[:, :-1]}[side]
        cut = {k: v + 1 if v > 1 else v for k, v in cut.items()}
        minxprime += cut['xlo'] * dxp
        maxxprime -= cut['xhi'] * dxp
        minzprime += cut['zlo'] * dzp
        maxzprime -= cut['zhi'] * dzp
        mesh = MeshSource.create(
            center=center, minxprime=minxprime, maxxprime=maxxprime,
            minzprime=minzprime, maxzprime=maxzprime, nx=nx, nz=nz, **kw)
    return mesh
