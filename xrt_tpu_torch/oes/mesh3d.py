"""Optical elements defined by triangulated (STL) meshes.

Port of the reference package's ``oes/mesh3d.py``: an STL reader for
binary and ASCII files (``read_stl``), the top surface of the solid found
by a flood fill over shared vertices from the highest upward-looking
triangle (``_top_surface_vertices``), and ``MeshOE``, whose surface is that
top reconstructed on the host at create time, in float64 numpy, as a plane
('flat'), a biquadratic least-squares fit ('quad') or a regular-grid height
map with its slope maps ('spline', scipy's cubic ``griddata``).  A trace
evaluates the polynomial, or the maps by bilinear interpolation
(``ops.interp.map_coordinates``).
"""
from __future__ import annotations

import struct as _struct
from collections import defaultdict, deque

import numpy as np
import torch

from .. import config
from ..ops.dd import sqrt_rn
from ..ops.interp import map_coordinates
from .base import OE


def read_stl(fileName):
    """(vectors (n, 3, 3), normals (n, 3)) of a binary or ASCII STL
    file."""
    with open(fileName, 'rb') as f:
        raw = f.read()
    if raw[:5].lower() == b'solid' and b'facet' in raw[:500]:
        text = raw.decode('ascii', errors='replace').split()
        normals, verts = [], []
        i = 0
        while i < len(text):
            tok = text[i]
            if tok in ('normal', 'vertex'):
                (normals if tok == 'normal' else verts).append(
                    [float(text[i + 1]), float(text[i + 2]),
                     float(text[i + 3])])
                i += 4
            else:
                i += 1
        vectors = np.asarray(verts, float).reshape(-1, 3, 3)
        return vectors, np.asarray(normals, float)
    # binary: an 80-byte header, a uint32 count, 50 bytes a triangle
    n = _struct.unpack('<I', raw[80:84])[0]
    tri = np.frombuffer(raw[84:84 + 50 * n], dtype=np.uint8).reshape(n, 50)
    floats = tri[:, :48].copy().view('<f4').reshape(n, 12).astype(float)
    return floats[:, 3:12].reshape(n, 3, 3), floats[:, 0:3]


def _top_surface_vertices(vectors, normals, orientation='XYZ'):
    """The vertices (x, y, z) of the connected top surface: triangles
    whose normal's z exceeds 0.1, flood-filled over shared vertices from
    the highest one."""
    ax = {'X': 0, 'Y': 1, 'Z': 2}
    ix = ax[orientation[0].upper()]
    iy = ax[orientation[1].upper()]
    iz = ax[orientation[2].upper()]
    top = np.where(normals[:, iz] > 0.1)[0]
    if len(top) == 0:
        raise ValueError('no upward-looking triangles in the mesh')
    izmax = top[np.argmax(vectors[top, 2, iz])]

    def pkey(p):
        return tuple(np.round(p, 8))

    tri_keys = [[pkey(p) for p in v] for v in vectors]
    point_to_tri = defaultdict(set)
    for ti, pts in enumerate(tri_keys):
        for pt in pts:
            point_to_tri[pt].add(ti)
    allowed = set(top.tolist()) - {izmax}
    surf = [izmax]
    queue = deque([izmax])
    while queue:
        tsi = queue.popleft()
        for pt in tri_keys[tsi]:
            for nei in point_to_tri[pt]:
                if nei in allowed:
                    allowed.remove(nei)
                    surf.append(nei)
                    queue.append(nei)
    v = vectors[surf]
    return v[:, :, ix].ravel(), v[:, :, iy].ravel(), v[:, :, iz].ravel()


class MeshOE(OE):
    """An OE whose surface is the top of an STL solid.  *surfaceHint*:
    'flat', 'quad' (the biquadratic coefficients *cpoly*, a tensor of 6)
    or 'spline' (the height map *zmap* and slope maps *dzdx*, *dzdy*
    (nx, ny), mm, on the grid of origin (gx0, gy0) and steps (gdx, gdy)).
    Its physical limits default to the top surface's extent."""

    def __init__(self, surfaceHint='quad', cpoly=None, zmap=None, dzdx=None,
                 dzdy=None, gx0=None, gy0=None, gdx=None, gdy=None,
                 **kwargs):
        super().__init__(**kwargs)
        self.surfaceHint = surfaceHint
        self.cpoly = cpoly
        self.zmap, self.dzdx, self.dzdy = zmap, dzdx, dzdy
        self.gx0, self.gy0, self.gdx, self.gdy = gx0, gy0, gdx, gdy

    @classmethod
    def create(cls, fileName=None, orientation='XYZ', recenter=True,
               surfaceHint='quad', gridPointsPerMM=10.0, dtype=None,
               device=None, **kwargs):
        """The reference's arguments; the maps and coefficients are made
        in float64 numpy and stored in *dtype* on *device*."""
        dt = config.resolve_dtype(dtype)
        dev = config.resolve_device(device)

        def T(v):
            return torch.as_tensor(np.asarray(v, float), dtype=dt,
                                   device=dev)
        vectors, normals = read_stl(fileName)
        xs, ys, zs = _top_surface_vertices(vectors, normals, orientation)
        limX = np.array([xs.min(), xs.max()])
        limY = np.array([ys.min(), ys.max()])
        if recenter:
            dcx = 0.5 * (limX[0] + limX[1])
            dcy = 0.5 * (limY[0] + limY[1])
            xs = xs - dcx
            ys = ys - dcy
            zs = zs - zs.min()
            limX = limX - dcx
            limY = limY - dcy
        uxy, ui = np.unique(np.vstack((xs, ys)).T, axis=0,
                            return_index=True)
        ux, uy, uz = uxy[:, 0], uxy[:, 1], zs[ui]
        fields = {}
        if surfaceHint == 'quad':
            A = np.c_[ux**2, uy**2, ux*uy, ux, uy, np.ones_like(ux)]
            cpoly, *_ = np.linalg.lstsq(A, uz, rcond=None)
            if recenter:
                cpoly[5] = 0.0
            fields['cpoly'] = T(cpoly)
        elif surfaceHint == 'spline':
            from scipy.interpolate import griddata
            nxg = max(int(gridPointsPerMM * (limX[1] - limX[0])), 4)
            nyg = max(int(gridPointsPerMM * (limY[1] - limY[0])), 4)
            xg = np.linspace(limX[0], limX[1], nxg)
            yg = np.linspace(limY[0], limY[1], nyg)
            xm, ym = np.meshgrid(xg, yg, indexing='ij')
            zm = griddata((ux, uy), uz, (xm, ym), method='cubic')
            bad = np.isnan(zm)
            if bad.any():
                zm[bad] = np.nanmean(zm)
            if recenter:
                zm = zm - zm.min()
            dzdxm, dzdym = np.gradient(zm, xg, yg)
            fields.update(zmap=T(zm), dzdx=T(dzdxm), dzdy=T(dzdym),
                          gx0=T(xg[0]), gy0=T(yg[0]), gdx=T(xg[1] - xg[0]),
                          gdy=T(yg[1] - yg[0]))
        elif surfaceHint != 'flat':
            raise ValueError("surfaceHint must be 'flat', 'quad' or "
                             "'spline'")
        kwargs.setdefault('limPhysX', tuple(limX))
        kwargs.setdefault('limPhysY', tuple(limY))
        return super(MeshOE, cls).create(surfaceHint=surfaceHint, **fields,
                                         **kwargs)

    def _grid_eval(self, arr, x, y):
        return map_coordinates(arr, ((x - self.gx0) / self.gdx,
                                     (y - self.gy0) / self.gdy))

    def local_z(self, x, y):
        if self.surfaceHint == 'quad':
            c = self.cpoly
            return (c[0]*x**2 + c[1]*y**2 + c[2]*x*y + c[3]*x + c[4]*y +
                    c[5])
        if self.surfaceHint == 'spline':
            return self._grid_eval(self.zmap, x, y)
        return torch.zeros_like(x)

    def local_n(self, x, y):
        if self.surfaceHint == 'quad':
            c = self.cpoly
            a = 2*c[0]*x + c[2]*y + c[3]
            b = 2*c[1]*y + c[2]*x + c[4]
        elif self.surfaceHint == 'spline':
            a = self._grid_eval(self.dzdx, x, y)
            b = self._grid_eval(self.dzdy, x, y)
        else:
            a = b = torch.zeros_like(x)
        norm = sqrt_rn(a**2 + b**2 + 1.0)
        return [-a/norm, -b/norm, 1.0/norm]

    def fitted_radii(self):
        """(Rmer, Rsag) of the 'quad' fit, or (None, None)."""
        if self.cpoly is None:
            return None, None
        return 0.5 / self.cpoly[1], 0.5 / self.cpoly[0]
