"""Linear interpolation with ``jnp.interp`` semantics.

The reference package evaluates every table segment under a mask
(``xrt_tpu/ops/interp.py``) to avoid dynamic gathers on the TPU.  On the
GPU a gather is cheap, so this is plain interpolation by a sorted search.
"""
from __future__ import annotations

import torch


def fast_interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: *xp* 1-D ascending, ends clamped, *x*
    any shape."""
    if xp.shape[0] == 1:
        return torch.broadcast_to(fp[0], x.shape)
    xf = torch.clamp(x.reshape(-1), xp[0], xp[-1])
    i = torch.clamp(torch.searchsorted(xp, xf, right=True) - 1, 0,
                    xp.shape[0] - 2)
    x0, x1 = xp[i], xp[i + 1]
    y0, y1 = fp[i], fp[i + 1]
    w = (xf - x0) / (x1 - x0)
    out = y0 + w * (y1 - y0)
    out = torch.where(xf >= xp[-1], fp[-1], out)
    return out.reshape(x.shape)


def map_coordinates(arr, coords):
    """Bilinear interpolation of the 2D map *arr* (ny, nx) at the
    fractional indices *coords* = (rows, columns), edges clamped: the
    reference's ``map_coordinates(arr, coords, order=1, mode='nearest')``
    in its arithmetic (lower index floor(c), weight c - floor(c), indices
    clamped, the four corners summed in (lo, lo), (lo, hi), (hi, lo),
    (hi, hi) order with the weights' product first).  Differentiable in
    the map values and in the coordinates."""
    nodes = []
    for c, size in zip(coords, arr.shape):
        lo = torch.floor(c)
        w_hi = c - lo
        i = lo.long()
        nodes.append(((torch.clamp(i, 0, size - 1), 1 - w_hi),
                      (torch.clamp(i + 1, 0, size - 1), w_hi)))
    out = None
    for iy, wy in nodes[0]:
        for ix, wx in nodes[1]:
            term = (wy * wx) * arr[iy, ix]
            out = term if out is None else out + term
    return out
