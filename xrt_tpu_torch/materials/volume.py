"""Indexed-volume (voxel) transmission sample material for TXM.

Port of the reference package's ``materials/volume.py``: a 3D integer
voxel grid maps each cell to one of a few materials; rays refract at the
entrance and exit surfaces with the index of the voxel they cross there,
and on exit take the attenuation and phase accumulated along their chord
through the volume.  The per-material optical constants are one (M, N)
table a call; the chord integral is a Python loop over the z slabs, each
a gather of the voxels at the segments' midpoints (about twenty launches
a slab).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..physconsts import CHBAR
from .material import Material


class TXMMaterial(Material):
    """A voxel-indexed volume.  *indexGrid* (nz, ny, nx) integers on the
    device; *xLimits*, *yLimits*, *zLimits* the volume's extent in mm;
    *materials* the constituent materials the grid's values address;
    *backgroundIndex* the material outside."""

    needsSpatialAmplitude = True

    def __init__(self, indexGrid, xLimits, yLimits, zLimits, materials,
                 backgroundIndex=0, name=''):
        super().__init__(elements=(), quantities=(), rho=0.0, t=None,
                         kind='plate', name=name)
        self.indexGrid = indexGrid
        self.xLimits, self.yLimits, self.zLimits = xLimits, yLimits, zLimits
        self.materials = materials
        self.backgroundIndex = backgroundIndex

    @classmethod
    def create(cls, fileName=None, indexGrid=None, limits=None,
               materialsIndex=None, backgroundIndex=0, name='',
               device=None):
        """From an HDF5 file (/indexGrid with the attributes
        axisOrder='zyx' and backgroundIndex, /limits/{x,y,z}; needs
        ``h5py``) or from arrays: *indexGrid* (nz, ny, nx) and *limits*
        {'x': (min, max), ...} mm.  *materialsIndex*: a dict {int:
        Material} with keys 0..M-1, or a sequence."""
        dev = config.resolve_device(device)
        if fileName is not None:
            import h5py
            with h5py.File(fileName, 'r') as h5:
                indexGrid = np.asarray(h5['indexGrid'][:])
                axisOrder = h5['indexGrid'].attrs.get('axisOrder', 'zyx')
                if isinstance(axisOrder, bytes):
                    axisOrder = axisOrder.decode()
                if axisOrder.lower() != 'zyx':
                    raise ValueError(
                        'TXMMaterial expects /indexGrid axisOrder="zyx"')
                backgroundIndex = int(
                    h5['indexGrid'].attrs.get('backgroundIndex',
                                              backgroundIndex))
                limits = {ax: np.asarray(h5['limits'][ax][:], float)
                          for ax in 'xyz'}
        if indexGrid is None:
            raise ValueError('need fileName or indexGrid')
        indexGrid = np.asarray(indexGrid)
        if indexGrid.ndim != 3 or not np.issubdtype(indexGrid.dtype,
                                                    np.integer):
            raise ValueError('/indexGrid must be a 3D integer dataset')
        if isinstance(materialsIndex, dict):
            keys = sorted(materialsIndex)
            if keys != list(range(len(keys))):
                raise ValueError('materialsIndex keys must be 0..M-1')
            mats = tuple(materialsIndex[k] for k in keys)
        else:
            mats = tuple(materialsIndex or ())
        required = set(int(v) for v in np.unique(indexGrid))
        required.add(int(backgroundIndex))
        if max(required) >= len(mats):
            raise ValueError(
                'materialsIndex has no entries for indices '
                f'{sorted(v for v in required if v >= len(mats))}')
        lim = {ax: tuple(float(v) for v in limits[ax]) for ax in 'xyz'}
        for ax in 'xyz':
            if len(lim[ax]) != 2 or lim[ax][0] >= lim[ax][1]:
                raise ValueError(
                    f'/limits/{ax} must contain [min, max] in mm')
        return cls(indexGrid=torch.as_tensor(indexGrid.astype(np.int64),
                                             device=dev),
                   xLimits=lim['x'], yLimits=lim['y'], zLimits=lim['z'],
                   materials=mats, backgroundIndex=int(backgroundIndex),
                   name=name)

    @property
    def grid_shape(self):
        return tuple(self.indexGrid.shape)  # (nz, ny, nx)

    def _steps(self):
        nz, ny, nx = self.grid_shape
        return ((self.xLimits[1] - self.xLimits[0]) / nx,
                (self.yLimits[1] - self.yLimits[0]) / ny,
                (self.zLimits[1] - self.zLimits[0]) / nz)

    def get_material_indices(self, x, y, z):
        """The voxel's material index at (x, y, z), clamped to the
        grid."""
        nz, ny, nx = self.grid_shape
        dx, dy, dz = self._steps()

        def cell(v, lo, step, n):
            return torch.clamp(torch.floor((v - lo) / step), 0,
                               n - 1).long()
        return self.indexGrid[cell(z, self.zLimits[0], dz, nz),
                              cell(y, self.yLimits[0], dy, ny),
                              cell(x, self.xLimits[0], dx, nx)]

    def _n_table(self, E):
        """(M, N) complex refractive indices of the materials at the
        rays' energies."""
        return torch.stack([m.get_refractive_index(E)
                            for m in self.materials])

    def get_refractive_index(self, E, x=None, y=None, z=None):
        """n of the background material, or of the voxel at (x, y, z)."""
        if x is None or y is None or z is None:
            return self.materials[self.backgroundIndex].\
                get_refractive_index(E)
        idx = self.get_material_indices(x, y, z)
        return torch.gather(self._n_table(E), 0, idx[None, :])[0]

    def get_absorption_coefficient(self, E, x=None, y=None, z=None):
        n = self.get_refractive_index(E, x, y, z)
        return torch.abs(n.imag) * E / CHBAR * 2e8  # 1/cm

    def _plate_amplitude_from_n(self, E, beamInDotNormal, fromVacuum, n):
        """Fresnel transmission amplitudes into or out of the medium *n*:
        (rs, rp, mu [1/cm], n k [1/cm])."""
        one = torch.ones_like(n)
        n1, n2 = (one, n) if fromVacuum else (n, one)
        cosAlpha = torch.abs(beamInDotNormal)
        sinAlpha2 = torch.clamp(1 - beamInDotNormal ** 2, min=0.0)
        n1cosAlpha = n1 * cosAlpha
        cosBeta = torch.sqrt(1 - (n1 / n2) ** 2 * sinAlpha2)
        n2cosBeta = n2 * cosBeta
        tf = sqrt_rn(torch.clamp((n2cosBeta * torch.conj(n1)).real,
                                 min=0.0) /
                     torch.clamp(cosAlpha, min=1e-30)) / torch.abs(n1)
        rs = 2 * n1cosAlpha / (n1cosAlpha + n2cosBeta) * tf
        rp = 2 * n1cosAlpha / (n2 * cosAlpha + n1 * cosBeta) * tf
        return (rs, rp, torch.abs(n.imag) * E / CHBAR * 2e8,
                n.real * E / CHBAR * 1e8)

    def volume_integrals(self, E, x, y, z, a, b, c, tMax):
        """Path-averaged mu [1/cm] and n_real k [1/cm] along each ray's
        chord from (x, y, z) over the length tMax: a loop over the z
        slabs, each adding its overlap with the chord times the constants
        of the voxel at the overlap's midpoint."""
        nz = self.grid_shape[0]
        dz = self._steps()[2]
        tMax = torch.clamp(tMax, min=0.0)
        validC = torch.abs(c) > 1e-15
        cSafe = torch.where(validC, c, torch.ones_like(c))
        nTab = self._n_table(E)                                # (M, N)
        muTab = torch.abs(nTab.imag) * E[None, :] / CHBAR * 2e8
        nkTab = nTab.real * E[None, :] / CHBAR * 1e8
        tau = torch.zeros_like(x)
        phase = torch.zeros_like(x)
        zero = torch.zeros_like(x)
        for iz in range(nz):
            s0 = (self.zLimits[0] + dz * iz - z) / cSafe
            s1 = (self.zLimits[0] + dz * (iz + 1) - z) / cSafe
            seg0 = torch.clamp(torch.minimum(s0, s1), min=0.0)
            seg1 = torch.minimum(torch.maximum(s0, s1), tMax)
            segCm = torch.where(validC & (seg1 > seg0),
                                (seg1 - seg0) * 0.1, zero)
            mid = 0.5 * (seg0 + seg1)
            idx = self.get_material_indices(x + a * mid, y + b * mid,
                                            z + c * mid)[None, :]
            tau = tau + torch.gather(muTab, 0, idx)[0] * segCm
            phase = phase + torch.gather(nkTab, 0, idx)[0] * segCm
        inside = tMax > 0
        pathCm = torch.where(inside, tMax * 0.1, torch.ones_like(tMax))
        return (torch.where(inside, tau / pathCm, zero),
                torch.where(inside, phase / pathCm, zero))

    def get_amplitude(self, E, beamInDotNormal, fromVacuum=True, x=None,
                      y=None, z=None, a=None, b=None, c=None, tMax=None):
        """(rs, rp, mu, n k); on exit (not *fromVacuum*, with directions
        and *tMax*) mu and n k are the chord's averages through the
        volume."""
        if x is None or y is None or z is None:
            return self._plate_amplitude_from_n(
                E, beamInDotNormal, fromVacuum, self.get_refractive_index(E))
        if not fromVacuum and tMax is not None and \
                all(v is not None for v in (a, b, c)):
            nSurface = self.get_refractive_index(
                E, x + a * tMax, y + b * tMax, z + c * tMax)
            rs, rp, _, _ = self._plate_amplitude_from_n(
                E, beamInDotNormal, fromVacuum, nSurface)
            mu, nk = self.volume_integrals(E, x, y, z, a, b, c, tMax)
            return rs, rp, mu, nk
        return self._plate_amplitude_from_n(
            E, beamInDotNormal, fromVacuum,
            self.get_refractive_index(E, x, y, z))
