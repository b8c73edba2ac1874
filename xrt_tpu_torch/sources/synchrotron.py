"""Synchrotron sources: the electron-beam and acceptance-window base.

Port of ``_SynchrotronBase`` of the reference package's
``sources/synchrotron.py``: the e-beam parameters, the acceptance window
(``Theta_min/max``, ``Psi_min/max``, ``xzE``) and the energy-spread draw
shared by the undulator.  The bending magnet, the wiggler, the field maps on
angular meshes (``multi_electron_stack``, ``intensities_on_mesh``) and the
ray-mode ``shine`` come with later slices (ROADMAP A8, A9) and raise
``NotImplementedError`` naming the item.
"""
from __future__ import annotations

import torch

from .. import config
from ..physconsts import C, EV2ERG, M0

_MESH_TODO = ('synchrotron field maps on angular meshes '
              '(multi_electron_stack, intensities_on_mesh) are not ported '
              'yet: ROADMAP A9')
_RAYS_TODO = ('the ray-mode shine of synchrotron sources (and the bending '
              'magnet and wiggler) is not ported yet: ROADMAP A8')


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
                 distE='eV', nrays=None, oversample=2, pitch=0.0, yaw=0.0):
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

    def shine(self, *args, **kwargs):
        raise NotImplementedError(_RAYS_TODO)
