"""Figure errors (surface distortions) of optical elements.

Port of the reference package's ``figure_error.py``: a height map z(x, y)
in nm on a regular grid with its slope maps, made on the host in float64
numpy exactly as the reference makes it (``imported_figure_error``,
``random_roughness`` with ``np.random.default_rng(seed)``,
``gaussian_bump``, ``waviness``, ``planar_ridge``, composable through
*baseFE*), and evaluated on the device by bilinear interpolation
(``ops.interp.map_coordinates``): heights in mm, normal rotations from the
slopes.  ``fe.replace(zmap=amp * fe.zmap)`` with a tensor *amp* keeps the
amplitude on the tape: the heights, and so the surface a wave reflects
at, are differentiable in it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import config
from .ops.interp import map_coordinates

MAX_FE_HALF_SIZE = 500.0


class FigureError(config.Replaceable):
    """A sampled height-error map with its slope maps.  *zmap*, *dzdx*,
    *dzdy* (ny, nx) in nm and nm/mm; *x0*, *y0* the grid's origin and
    *dx*, *dy* its steps (mm), *xShift*, *yShift* shifts of the map, all
    tensors of one dtype and device.  Made by :meth:`from_map` or the
    factory functions below."""

    def __init__(self, zmap, dzdx, dzdy, x0, y0, dx, dy, xShift, yShift,
                 name=''):
        self.zmap, self.dzdx, self.dzdy = zmap, dzdx, dzdy
        self.x0, self.y0, self.dx, self.dy = x0, y0, dx, dy
        self.xShift, self.yShift = xShift, yShift
        self.name = name

    @classmethod
    def from_map(cls, z_nm, x1d, y1d, name='', xShift=0.0, yShift=0.0,
                 dtype=None, device=None):
        """From a host height map *z_nm* (ny, nx) on the regular grids
        *x1d*, *y1d* (mm); the slopes by ``np.gradient`` in float64."""
        dt = config.resolve_dtype(dtype)
        dev = config.resolve_device(device)
        z_nm = np.asarray(z_nm, float)
        x1d = np.asarray(x1d, float)
        y1d = np.asarray(y1d, float)
        dzdy, dzdx = np.gradient(z_nm, y1d, x1d)

        def T(v):
            return torch.as_tensor(np.asarray(v, float), dtype=dt,
                                   device=dev)
        return cls(zmap=T(z_nm), dzdx=T(dzdx), dzdy=T(dzdy), x0=T(x1d[0]),
                   y0=T(y1d[0]), dx=T(x1d[1] - x1d[0]),
                   dy=T(y1d[1] - y1d[0]), xShift=T(xShift), yShift=T(yShift),
                   name=name)

    def _coords(self, x, y):
        cx = (x + self.xShift - self.x0) / self.dx
        cy = (y + self.yShift - self.y0) / self.dy
        return cy, cx

    def local_z_distorted(self, x, y):
        """The height error at (x, y), mm (the map is in nm)."""
        return map_coordinates(self.zmap, self._coords(x, y)) * 1e-6

    def local_n_distorted(self, x, y):
        """(d_pitch, d_roll): the normal's rotations from the slopes."""
        c = self._coords(x, y)
        a = map_coordinates(self.dzdx, c) * 1e-6
        b = map_coordinates(self.dzdy, c) * 1e-6
        return [torch.arctan(b), -torch.arctan(a)]

    def local_r_distorted(self, s, phi):
        """A parametric OE takes the distortion in (s, phi)."""
        return self.local_z_distorted(s, phi)

    def get_rms(self):
        """RMS height, nm."""
        return torch.sqrt(torch.mean(self.zmap ** 2))

    def get_rms_slope(self):
        """(pitch, roll) RMS slopes, urad."""
        return (torch.sqrt(torch.mean(self.dzdy ** 2)) * 1e-3,
                torch.sqrt(torch.mean(self.dzdx ** 2)) * 1e-3)


def _grids(limPhysX, limPhysY, gridStep):
    def axis(lim):
        n = 1 << int(math.ceil(math.log2(
            max((lim[1] - lim[0]) / gridStep, 2))))
        return np.linspace(lim[0], lim[1], n)
    return axis(limPhysX), axis(limPhysY)


def _add_base(z, x1d, y1d, baseFE):
    """*z* plus the heights of *baseFE* on the grid, nm (evaluated on the
    base's own device and dtype)."""
    if baseFE is None:
        return z
    X, Y = np.meshgrid(x1d, y1d)
    like = baseFE.zmap

    def T(v):
        return torch.as_tensor(v.ravel(), dtype=like.dtype,
                               device=like.device)
    with torch.no_grad():
        zb = baseFE.local_z_distorted(T(X), T(Y))
    return z + zb.cpu().double().numpy().reshape(z.shape) * 1e6


def imported_figure_error(fileName=None, array=None, x1d=None, y1d=None,
                          columnFactors=(1.0, 1.0, 1e6), recenter=False,
                          baseFE=None, name='imported', dtype=None,
                          device=None):
    """A height map from a 3-column text file (x, y, z) or from arrays;
    *columnFactors* convert the file's units to (mm, mm, nm)."""
    if fileName is not None:
        data = np.loadtxt(fileName)
        xs = np.unique(data[:, 0]) * columnFactors[0]
        ys = np.unique(data[:, 1]) * columnFactors[1]
        z = data[:, 2].reshape(len(ys), len(xs)) * columnFactors[2]
    else:
        xs, ys, z = np.asarray(x1d), np.asarray(y1d), np.asarray(array)
    if recenter:
        z = z - z.mean()
        xs = xs - 0.5 * (xs[0] + xs[-1])
        ys = ys - 0.5 * (ys[0] + ys[-1])
    z = _add_base(z, xs, ys, baseFE)
    return FigureError.from_map(z, xs, ys, name=name, dtype=dtype,
                                device=device)


def random_roughness(rms=1.0, rmsKind='height', corrLength=5.0, seed=0,
                     limPhysX=(-10, 10), limPhysY=(-50, 50), gridStep=0.5,
                     baseFE=None, name='random roughness', dtype=None,
                     device=None):
    """PSD-shaped random roughness: white noise filtered by a Gaussian in
    k-space of the correlation length(s), scaled to the RMS height [nm] or
    slope [urad] asked for."""
    x1d, y1d = _grids(limPhysX, limPhysY, gridStep)
    nx, ny = len(x1d), len(y1d)
    dx = x1d[1] - x1d[0]
    dy = y1d[1] - y1d[0]
    rng = np.random.default_rng(seed)
    z = rng.normal(0.0, 1.0, (ny, nx))
    if corrLength is not None:
        Z = np.fft.rfft2(z)
        kx = 2 * np.pi * np.fft.rfftfreq(nx, d=dx)
        ky = 2 * np.pi * np.fft.fftfreq(ny, d=dy)
        KX, KY = np.meshgrid(kx, ky)
        if isinstance(rms, (tuple, list)):
            corrY = corrLength
            corrX = corrLength * rms[0] / rms[1]
        else:
            corrX = corrY = corrLength
        filt = np.exp(-0.5 * (KX ** 2 * corrX ** 2 + KY ** 2 * corrY ** 2))
        z = np.fft.irfft2(Z * filt, s=(ny, nx))
    z -= z.mean()
    if rmsKind == 'height':
        z *= rms / max(np.sqrt((z ** 2).mean()), 1e-300)
    else:  # slope, urad
        gy, gx = np.gradient(z, y1d, x1d)
        rms0 = np.sqrt((gy ** 2).mean()) * 1e-3  # urad for z in nm
        target = rms[0] if isinstance(rms, (tuple, list)) else rms
        z *= target / max(rms0, 1e-300)
    z = _add_base(z, x1d, y1d, baseFE)
    return FigureError.from_map(z, x1d, y1d, name=name, dtype=dtype,
                                device=device)


def gaussian_bump(height=1.0, sigmaX=1.0, sigmaY=5.0, centerX=0.0,
                  centerY=0.0, limPhysX=(-10, 10), limPhysY=(-50, 50),
                  gridStep=0.5, baseFE=None, name='gaussian bump',
                  dtype=None, device=None):
    """A Gaussian bump of *height* nm."""
    x1d, y1d = _grids(limPhysX, limPhysY, gridStep)
    X, Y = np.meshgrid(x1d, y1d)
    z = height * np.exp(-0.5 * (((X - centerX) / sigmaX) ** 2 +
                                ((Y - centerY) / sigmaY) ** 2))
    z = _add_base(z, x1d, y1d, baseFE)
    return FigureError.from_map(z, x1d, y1d, name=name, dtype=dtype,
                                device=device)


def waviness(amplitude=1.0, period=10.0, phase=0.0, direction='y',
             limPhysX=(-10, 10), limPhysY=(-50, 50), gridStep=0.5,
             baseFE=None, name='waviness', dtype=None, device=None):
    """A sinusoidal waviness of *amplitude* nm and *period* mm."""
    x1d, y1d = _grids(limPhysX, limPhysY, gridStep)
    X, Y = np.meshgrid(x1d, y1d)
    C = Y if direction == 'y' else X
    z = amplitude * np.sin(2 * np.pi * C / period + phase)
    z = _add_base(z, x1d, y1d, baseFE)
    return FigureError.from_map(z, x1d, y1d, name=name, dtype=dtype,
                                device=device)


def planar_ridge(height=1.0, width=5.0, centerY=0.0, direction='y',
                 limPhysX=(-10, 10), limPhysY=(-50, 50), gridStep=0.5,
                 baseFE=None, name='ridge', dtype=None, device=None):
    """A planar ridge of *height* nm and *width* mm."""
    x1d, y1d = _grids(limPhysX, limPhysY, gridStep)
    X, Y = np.meshgrid(x1d, y1d)
    C = Y if direction == 'y' else X
    z = np.where(np.abs(C - centerY) < width / 2, height, 0.0)
    z = _add_base(z, x1d, y1d, baseFE)
    return FigureError.from_map(z, x1d, y1d, name=name, dtype=dtype,
                                device=device)
