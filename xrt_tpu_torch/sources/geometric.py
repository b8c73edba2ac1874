"""Geometric (sampled-distribution) sources.

Port of the reference package's ``sources/geometric.py``: ``make_energy``,
``polarization_matrix`` and ``GeometricSource`` with its ``shine``: ray
origins, divergences and energies sampled from normal / flat / annulus /
lines laws, polarization encoded in the coherency matrix.

Random draws take an explicit ``torch.Generator`` and are made on the
device the generator lives on.  A CUDA generator draws in the beam's
dtype on the card (the ray-trace path: nothing crosses from the host).  A
CPU generator draws in float64 on the host and copies to the beam's
device and dtype, so one seed gives the same samples on any device and in
either dtype (the wave chain and the cross-checks).  The two give
different numbers from one seed.
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..beam import Beam
from ..ops.dd import sqrt_rn
from ..physconsts import PI2
from ..transforms import rotate_xyz, virgin_local_to_global


def _draw(fn, generator, nrays, dtype, device):
    """*nrays* samples of ``torch.rand`` / ``torch.randn`` (*fn*) on the
    generator's device, as a tensor of *dtype* on *device*."""
    if generator.device.type == 'cpu':
        return fn(nrays, generator=generator,
                  dtype=torch.float64).to(device=device, dtype=dtype)
    return fn(nrays, generator=generator, dtype=dtype,
              device=generator.device).to(device)


def _uniform(generator, nrays, lo, hi, dtype, device):
    return lo + (hi - lo) * _draw(torch.rand, generator, nrays, dtype,
                                  device)


def make_energy(generator, distE, energies, nrays, energyWeights=None,
                dtype=torch.float32, device='cpu'):
    """Sample the energy distribution: *distE* is 'normal'
    ((center, sigma)), 'flat' ((min, max)) or 'lines' (a sequence of E with
    optional weights)."""
    energies = [float(e) for e in energies]
    if distE == 'normal':
        return energies[0] + energies[1] * _draw(torch.randn, generator,
                                                 nrays, dtype, device)
    if distE == 'flat':
        return _uniform(generator, nrays, energies[0], energies[1], dtype,
                        device)
    if distE == 'lines':
        lines = torch.tensor(energies, dtype=dtype, device=device)
        if len(energies) == 1:
            return lines.expand(nrays).clone()
        w = torch.ones(len(energies), dtype=torch.float64) \
            if energyWeights is None else \
            torch.as_tensor(energyWeights, dtype=torch.float64)
        idx = torch.multinomial((w / torch.sum(w)).to(generator.device),
                                nrays, replacement=True,
                                generator=generator)
        return lines[idx.to(device)]
    raise ValueError(f'unknown distE {distE!r}')


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


def _size(v):
    return tuple(config.number(c) for c in v) \
        if isinstance(v, (tuple, list)) else config.number(v)


class GeometricSource(config.Replaceable):
    """A source with sampled origin, divergence and energy distributions.

    *distx/disty/distz* in {'normal', 'flat', 'annulus', None};
    *distxprime/distzprime* likewise; *distE* in {'normal', 'flat', 'lines',
    None}.  Sizes: for 'normal' sigma (or (sigma, cut) with
    uniformRayDensity), for 'flat' full width or (min, max), for 'annulus'
    (rMin, rMax) on the radial member and optionally (phiMin, phiMax) on the
    other.  Sizes and placement are Python floats, or the tensors that
    were passed in (the samples are reparameterized draws, so ``shine`` is
    differentiable with respect to them); the beam is made in *dtype* on
    *device*."""

    def __init__(self, name='', center=(0, 0, 0), nrays=None, distx='normal',
                 dx=0.32, disty=None, dy=0.0, distz='normal', dz=0.018,
                 distxprime='normal', dxprime=1e-3, distzprime='normal',
                 dzprime=1e-4, distE='lines',
                 energies=(config.DEFAULT_ENERGY,), energyWeights=None,
                 polarization='horizontal', filamentBeam=False,
                 uniformRayDensity=False, pitch=0.0, roll=0.0, yaw=0.0,
                 dtype=None, device=None):
        self.name = name
        self.center = tuple(config.number(c) for c in center)
        self.nrays = int(config.NRAYS if nrays is None else nrays)
        self.distx, self.disty, self.distz = distx, disty, distz
        self.distxprime, self.distzprime = distxprime, distzprime
        self.dx, self.dy, self.dz = _size(dx), _size(dy), _size(dz)
        self.dxprime, self.dzprime = _size(dxprime), _size(dzprime)
        self.distE = distE
        if distE == 'lines' and isinstance(energies, (int, float)):
            energies = (energies,)
        self.energies = tuple(float(e) for e in energies)
        self.energyWeights = energyWeights
        self.polarization = polarization
        self.filamentBeam = filamentBeam
        self.uniformRayDensity = uniformRayDensity
        self.pitch, self.roll, self.yaw = (config.number(pitch),
                                           config.number(roll),
                                           config.number(yaw))
        self.dtype = config.resolve_dtype(dtype)
        self.device = config.resolve_device(device)

    @classmethod
    def create(cls, **kwargs):
        return cls(**kwargs)

    # ------------------------------------------------------------------
    def _sample_axis(self, generator, dist, d):
        """Returns (samples, amplitude factor or None)."""
        n, dt, dev = self.nrays, self.dtype, self.device
        if dist == 'normal':
            if self.uniformRayDensity:
                sigma, cut = d
                x = _uniform(generator, n, -cut, cut, dt, dev)
                amp = torch.exp(-x ** 2 / sigma ** 2 / 2) / \
                    PI2 ** 0.5 / sigma * 2 * cut
                return x, amp
            sigma = d[0] if isinstance(d, tuple) else d
            return sigma * _draw(torch.randn, generator, n, dt, dev), None
        if dist == 'flat':
            aMin, aMax = d if isinstance(d, tuple) else (-d * 0.5, d * 0.5)
            return _uniform(generator, n, aMin, aMax, dt, dev), None
        return torch.zeros(n, dtype=dt, device=dev), None

    def _sample_annulus(self, generator, dr, dphi):
        """Uniform-in-area annulus."""
        n, dt, dev = self.nrays, self.dtype, self.device
        rMin, rMax = dr
        u = _draw(torch.rand, generator, n, dt, dev)
        r = sqrt_rn(u * (rMax ** 2 - rMin ** 2) + rMin ** 2)
        phiMin, phiMax = dphi if isinstance(dphi, tuple) else (0.0, PI2)
        phi = _uniform(generator, n, phiMin, phiMax, dt, dev)
        return r * torch.cos(phi), r * torch.sin(phi)

    def shine(self, generator, toGlobal=True, withAmplitudes=False) -> Beam:
        """Generate the source beam.  *generator* is a ``torch.Generator``
        (or an int seed, which makes one on the source's device): a CUDA
        generator draws on the card in the beam's dtype, a CPU generator
        draws float64 on the host and copies (see the module docstring)."""
        dt, dev, n = self.dtype, self.device, self.nrays
        cdt = config.cdtype(dt)
        if isinstance(generator, int):
            generator = torch.Generator(dev).manual_seed(generator)
        if self.uniformRayDensity:
            withAmplitudes = True

        def full(v, dtype=dt):
            return torch.full((n,), v, dtype=dtype, device=dev)

        Jss0, Jpp0, Jsp0, Es0, Ep0 = polarization_matrix(self.polarization)
        Jss, Jpp, Jsp = full(Jss0), full(Jpp0), full(Jsp0, cdt)

        y, _ = self._sample_axis(generator, self.disty, self.dy)
        amps = []
        if 'annulus' in (self.distx, self.distz):
            x, z = self._sample_annulus(generator, self.dx, self.dz)
        else:
            x, ax = self._sample_axis(generator, self.distx, self.dx)
            z, az = self._sample_axis(generator, self.distz, self.dz)
            amps += [ax, az]
        if 'annulus' in (self.distxprime, self.distzprime):
            a, c = self._sample_annulus(generator, self.dxprime,
                                        self.dzprime)
        else:
            a, aa = self._sample_axis(generator, self.distxprime,
                                      self.dxprime)
            c, ac = self._sample_axis(generator, self.distzprime,
                                      self.dzprime)
            amps += [aa, ac]
        if self.distE is not None:
            E = make_energy(generator, self.distE, self.energies, n,
                            self.energyWeights, dt, dev)
        else:
            E = full(config.DEFAULT_ENERGY)
        Es = Ep = None
        if withAmplitudes:
            Es = full(0.0 if Es0 is None else Es0, cdt)
            if Ep0 is None and Es0 is not None:  # unpolarized: random Ep
                Ep = (_draw(torch.rand, generator, n, dt, dev) *
                      2 ** -0.5).to(cdt)
            else:
                Ep = full(0.0 if Ep0 is None else Ep0, cdt)

        ampTot = None
        for amp in amps:
            if amp is not None:
                ampTot = amp if ampTot is None else ampTot * amp
        if ampTot is not None:
            Jss, Jpp, Jsp = Jss * ampTot, Jpp * ampTot, Jsp * ampTot
            if withAmplitudes:
                sqrtAmp = sqrt_rn(ampTot)
                Es, Ep = Es * sqrtAmp, Ep * sqrtAmp

        # normalize the direction
        ac2 = a ** 2 + c ** 2
        big = ac2 > 1
        bnorm = torch.where(big, sqrt_rn(ac2 + 1), torch.ones_like(ac2))
        b = torch.where(big, 1.0 / bnorm,
                        sqrt_rn(torch.clamp(1 - ac2, min=0.0)))
        a = torch.where(big, a / bnorm, a)
        c = torch.where(big, c / bnorm, c)

        x, y, z = rotate_xyz(x, y, z, pitch=self.pitch, roll=self.roll,
                             yaw=self.yaw)
        a, b, c = rotate_xyz(a, b, c, pitch=self.pitch, roll=self.roll,
                             yaw=self.yaw)
        beam = Beam(x=x, y=y, z=z, a=a, b=b, c=c, E=E,
                    state=torch.full((n,), config.STATE_GOOD,
                                     dtype=torch.int32, device=dev),
                    path=torch.zeros(n, dtype=dt, device=dev),
                    Jss=Jss, Jpp=Jpp, Jsp=Jsp, Es=Es, Ep=Ep)
        if toGlobal:
            beam = virgin_local_to_global(beam, self.center)
        return beam
