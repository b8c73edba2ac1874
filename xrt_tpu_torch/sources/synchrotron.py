"""Synchrotron sources: the electron-beam and acceptance-window base.

Port of ``_SynchrotronBase`` of the reference package's
``sources/synchrotron.py``: the e-beam parameters, the acceptance window
(``Theta_min/max``, ``Psi_min/max``, ``xzE``), the energy-spread draw and
the ray-mode ``shine`` shared by the undulator.

``shine`` samples by importance resampling, as the reference does: a fixed
batch of ``nrays * oversample`` candidates (E, theta, psi) drawn uniformly
in the acceptance window is evaluated once by ``build_I_map``, then exactly
``nrays`` rays are drawn with probability proportional to the intensity.
The draw is an inverse CDF, as the reference's ``choice`` with ``p`` is: a
cumulative sum of the intensities in the beam's dtype, uniforms scaled by
its last value, and a sorted search.  Each draw can be injected
(``draws=``), so the port can be held to the reference on the same numbers.

The bending magnet, the wiggler and the field maps on angular meshes
(``multi_electron_stack``, ``intensities_on_mesh``) come with later slices
(ROADMAP A8, A9) and raise ``NotImplementedError`` naming the item.
"""
from __future__ import annotations

import torch

from .. import config
from ..beam import Beam
from ..ops.dd import sqrt_rn
from ..physconsts import C, EV2ERG, M0, SIE0
from ..transforms import rotate_xyz, virgin_local_to_global
from .geometric import _draw

_MESH_TODO = ('synchrotron field maps on angular meshes '
              '(multi_electron_stack, intensities_on_mesh) are not ported '
              'yet: ROADMAP A9')
#: the draws of a ray-mode shine, in the reference's order; each is a
#: tensor of uniforms in [0, 1) or of standard normals
DRAWS = ('E', 'theta', 'psi', 'gamma', 'choice', 'dtheta', 'dpsi', 'x',
         'z')


def _nonzero(v):
    """Whether a term scaled by *v* must be kept: *v* > 0, or *v* is a
    tensor that records a gradient (adding a zero-scaled term is exact)."""
    if isinstance(v, torch.Tensor) and v.requires_grad:
        return True
    return config.host_float(v) > 0


def _scalar(v):
    """A parameter as a Python float, or the tensor itself where a gradient
    is recorded through it."""
    if isinstance(v, torch.Tensor) and v.requires_grad:
        return v
    return config.host_float(v)


class _SynchrotronBase(config.Replaceable):
    """Shared e-beam / acceptance-window parameters.  Energies in eV, sizes
    in mm, angles in rad; the e-beam sizes and divergences are Python floats
    or the tensors that were passed in."""

    def __init__(self, name='', center=(0, 0, 0), eE=6.0, eI=0.1,
                 eEspread=0.0, dx=0.0, dz=0.0, dxprime=0.0, dzprime=0.0,
                 eMin=5000.0, eMax=15000.0, xPrimeMax=0.5e-3,
                 zPrimeMax=0.5e-3, xPrimeMin=None, zPrimeMin=None,
                 distE='eV', nrays=None, oversample=2, pitch=0.0, yaw=0.0,
                 dtype=None, device=None):
        self.name = name
        self.center = tuple(config.number(c) for c in center)
        self.eE = float(eE)
        self.eI = config.number(eI)
        self.eEspread = float(eEspread)
        self.dx, self.dz = config.number(dx), config.number(dz)
        self.dxprime = config.number(dxprime)
        self.dzprime = config.number(dzprime)
        self.eMin, self.eMax = float(eMin), float(eMax)
        self.xPrimeMax, self.zPrimeMax = float(xPrimeMax), float(zPrimeMax)
        self.xPrimeMin, self.zPrimeMin = xPrimeMin, zPrimeMin
        self.distE = distE
        self.nrays = nrays
        self.oversample = oversample
        self.pitch, self.yaw = float(pitch), float(yaw)
        self.dtype, self.device = dtype, device

    @property
    def gamma(self):
        return self.eE * 1e9 * EV2ERG / (M0 * C ** 2)

    @property
    def gamma2(self):
        return self.gamma ** 2

    @property
    def Theta_min(self):
        return (self.xPrimeMin if self.xPrimeMin is not None
                else -self.xPrimeMax) - _scalar(self.dxprime)

    @property
    def Theta_max(self):
        return self.xPrimeMax + _scalar(self.dxprime)

    @property
    def Psi_min(self):
        return (self.zPrimeMin if self.zPrimeMin is not None
                else -self.zPrimeMax) - _scalar(self.dzprime)

    @property
    def Psi_max(self):
        return self.zPrimeMax + _scalar(self.dzprime)

    @property
    def xzE(self):
        """Acceptance-volume factor."""
        return (self.eMax - self.eMin) * (self.Theta_max - self.Theta_min) \
            * (self.Psi_max - self.Psi_min)

    def _sample_gamma(self, generator, gamma, shape, dtype, device):
        """Lorentz factors: *gamma* spread by ``eEspread`` (normal draws
        from *generator*, made on the CPU in float64 so that one seed gives
        the same values on any device), or *gamma* itself."""
        if self.eEspread > 0:
            g = torch.randn(shape, generator=generator, dtype=torch.float64)
            return gamma * (1 + self.eEspread * g.to(device=device,
                                                     dtype=dtype))
        return torch.full(shape, gamma, dtype=dtype, device=device)

    def multi_electron_stack(self, *args, **kwargs):
        raise NotImplementedError(_MESH_TODO)

    def intensities_on_mesh(self, *args, **kwargs):
        raise NotImplementedError(_MESH_TODO)

    def _draws(self, generator, draws, dt, dev, M, nrays):
        """The draws of a shine, in the beam's dtype on its device: those
        in *draws* as given, the others from *generator* (a CUDA generator
        draws on the card in the beam's dtype, a CPU one in float64 on the
        host)."""
        draws = dict(draws or {})
        sizes = dict(E=M, theta=M, psi=M, gamma=M, choice=nrays,
                     dtheta=nrays, dpsi=nrays, x=nrays, z=nrays)
        out = {}
        for name in DRAWS:
            if name in draws:
                out[name] = torch.as_tensor(draws[name], dtype=dt,
                                            device=dev)
            elif name == 'gamma' and not self.eEspread > 0:
                continue
            else:
                fn = torch.randn if name in ('gamma', 'dtheta', 'dpsi', 'x',
                                             'z') else torch.rand
                out[name] = _draw(fn, generator, sizes[name], dt, dev)
        return out

    def shine(self, generator=None, toGlobal=True, withAmplitudes=True,
              fixedEnergy=False, draws=None):
        """A Monte-Carlo source beam of ``nrays`` rays by importance
        resampling of ``nrays * oversample`` candidates.  *generator* is a
        ``torch.Generator`` (seed 0 on the beam's device if None); *draws*
        maps names of :data:`DRAWS` to injected draws.  The beam is made in
        the source's dtype on its device."""
        dt = config.resolve_dtype(self.dtype)
        dev = config.resolve_device(self.device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        nrays = self.nrays or config.NRAYS
        M = nrays * self.oversample
        r = self._draws(generator, draws, dt, dev, M, nrays)

        def uniform(u, lo, hi):
            return torch.clamp(u * (hi - lo) + lo, min=lo)
        rE = uniform(r['E'], self.eMin, self.eMax)
        if fixedEnergy:
            rE = torch.full((M,), float(fixedEnergy), dtype=dt, device=dev)
        rTheta = uniform(r['theta'], self.Theta_min, self.Theta_max)
        rPsi = uniform(r['psi'], self.Psi_min, self.Psi_max)
        gamma = self.gamma * (1 + self.eEspread * r['gamma']) \
            if 'gamma' in r else None
        Intensity, mJss, mJpp = self._I_map_blocks(
            generator, rE, rTheta, rPsi, gamma=gamma)

        # resample ~ Intensity: the inverse CDF of the reference's choice
        sumI = torch.sum(Intensity)
        p = Intensity / torch.clamp(sumI, min=1e-300)
        p_cuml = torch.cumsum(p, dim=0)
        idx = torch.searchsorted(p_cuml, p_cuml[-1] * (1 - r['choice']))
        idx = torch.clamp(idx, max=M - 1)
        rE = rE[idx]
        Theta0 = rTheta[idx]
        Psi0 = rPsi[idx]
        mJss = mJss[idx]
        mJpp = mJpp[idx]

        dtheta = torch.zeros((nrays,), dtype=dt, device=dev)
        dpsi = torch.zeros((nrays,), dtype=dt, device=dev)
        if _nonzero(self.dxprime):
            dtheta = dtheta + self.dxprime * r['dtheta']
        if _nonzero(self.dzprime):
            dpsi = dpsi + self.dzprime * r['dpsi']
        a = torch.tan(Theta0 + dtheta)
        c = torch.tan(Psi0 + dpsi)

        intensS = (mJss * torch.conj(mJss)).real
        intensP = (mJpp * torch.conj(mJpp)).real
        sSP = intensS + intensP
        safe = torch.clamp(sSP, min=1e-300)
        x, y, z = self._sample_positions(rE, Theta0, r['x'], r['z'])
        zero = torch.zeros_like(sSP)
        Jss = torch.where(sSP > 0, intensS / safe, zero)
        Jpp = torch.where(sSP > 0, intensP / safe, zero)
        Jsp = torch.where(sSP > 0, mJss * torch.conj(mJpp) / safe,
                          torch.zeros_like(mJss))
        norm = sqrt_rn(a ** 2 + 1.0 + c ** 2)
        scale = sumI / M * self.xzE
        beam = Beam(
            x=x, y=y, z=z, a=a / norm, b=1.0 / norm, c=c / norm, E=rE,
            state=torch.ones((nrays,), dtype=torch.int32, device=dev),
            path=torch.zeros((nrays,), dtype=dt, device=dev),
            Jss=Jss, Jpp=Jpp, Jsp=Jsp,
            Es=mJss if withAmplitudes else None,
            Ep=mJpp if withAmplitudes else None,
            accepted=scale * nrays, acceptedE=torch.sum(rE) * scale * SIE0,
            seeded=torch.tensor(float(nrays), dtype=dt, device=dev),
            seededI=scale * nrays)
        if self.pitch != 0:     # as the reference: a yaw alone is not
            #                     applied
            x2, y2, z2 = rotate_xyz(beam.x, beam.y, beam.z,
                                    pitch=self.pitch, yaw=self.yaw)
            a2, b2, c2 = rotate_xyz(beam.a, beam.b, beam.c,
                                    pitch=self.pitch, yaw=self.yaw)
            beam = beam.replace(x=x2, y=y2, z=z2, a=a2, b=b2, c=c2)
        if toGlobal:
            beam = virgin_local_to_global(beam, self.center)
        return beam
