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
