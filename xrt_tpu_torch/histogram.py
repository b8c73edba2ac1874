"""Weighted histograms with hue + brightness colorization.

Port of the reference package's ``histogram.py``: ``hist1d``,
``hist1d_rgb``, ``hist2d``, ``hist2d_rgb``, ``hsv_to_rgb`` and
``colorize``.  Histograms are linear, so repeats accumulate by addition.

All four histogram functions are one function, the weighted histogram of
N rays into (ybins, xbins, k) bins with k weight columns (a 1D histogram
is its ``ybins = 1`` case):

* on CUDA tensors :func:`hist2d_kernel` launches the hand-written
  scatter-add kernel ``csrc/hist2d.cu`` (which replaces the TPU kernel
  ``xrt_tpu/histogram.py:89 hist2d_mxu``) and counts the launch in
  :data:`LAUNCHES`; there is no size gate and no fallback;
* on CPU tensors :func:`hist2d_plain` does the same index arithmetic in
  torch and ``index_add_`` on the flat index.

Histograms are differentiable with respect to the weights (the
coordinates and the limits get no gradient: ``floor``).  The adjoint is a
gather, ``Wbar[i, :] = g[iy(i), ix(i), :]`` for a ray inside the limits
and 0 otherwise: on CUDA tensors the hand-written kernel
:func:`hist2d_bwd_kernel` (the forward's bin formula operation for
operation; at k = 1 four rays a thread with 16-byte loads and stores), on
CPU tensors :func:`hist2d_bwd_plain` (advanced indexing).  Both
directions go through one ``torch.autograd.Function``.

Bin index, in both: ``floor((v - lo) / (hi - lo) * bins)`` as separate
subtract, divide and multiply in the tensors' dtype.  The reference
package has two formulas (its scatter path divides by the span, its MXU
kernel multiplies by ``bins / span``), which can put a ray that lies on a
bin edge into different bins; this is its scatter path's, the one that
runs on a CPU and that the parity tests hold against.  A ray is inside
when ``0 <= index < bins`` and its coordinate is finite; ``v == hi`` is
outside.
"""
from __future__ import annotations

import collections
import ctypes

import torch

#: the most dynamic shared memory a block may use on sm_90, bytes: a
#: histogram this small gets a private copy in every block
MAX_SHARED_BYTES = 232448

#: kernel launches by 'hist2d:k<k>:<shared|global>', counted where the
#: kernel launches (``LAUNCHES.clear()`` before a run, read after it)
LAUNCHES: collections.Counter = collections.Counter()

_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 +
             [ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
              ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
# the adjoint's entry: the same without the variant flag
_BWD_ARGTYPES = _ARGTYPES[:13] + [ctypes.c_void_p]


def _bin_index(v, limits, bins):
    """(bin index as a float tensor, inside mask) of coordinates *v*."""
    lo, hi = float(limits[0]), float(limits[1])
    # the span as a tensor on v's device: PyTorch's CUDA division by a
    # Python number multiplies by its reciprocal, which moves rays that
    # lie near a bin edge; by a tensor it divides, as the kernel does
    span = torch.full((), hi - lo, dtype=v.dtype, device=v.device)
    f = torch.floor((v - lo) / span * bins)
    return f, (f >= 0) & (f < bins) & torch.isfinite(v)


def _check(x, y, W, xbins, ybins):
    if W.ndim != 2 or W.shape[1] not in (1, 3) or x.ndim != 1 or \
            W.shape[0] != x.shape[0]:
        raise ValueError('histogram takes x (N,) and weights (N, 1) or '
                         f'(N, 3), not {tuple(x.shape)} and '
                         f'{tuple(W.shape)}')
    if x.dtype not in (torch.float32, torch.float64) or W.dtype != x.dtype:
        raise TypeError('histogram coordinates and weights must share one '
                        f'of float32 / float64, not {x.dtype} / {W.dtype}')
    if y is None:
        if ybins != 1:
            raise ValueError('a 1D histogram has ybins = 1')
    elif y.shape != x.shape or y.dtype != x.dtype or y.device != x.device:
        raise ValueError('histogram x and y differ in shape, dtype or '
                         'device')
    if W.device != x.device:
        raise ValueError('histogram coordinates and weights on two devices')
    if xbins < 1 or ybins < 1:
        raise ValueError('histogram needs at least one bin per axis')


def hist2d_plain(x, y, W, xbins, ybins, xlimits, ylimits=None,
                 sum_dtype=None):
    """The plain version: (ybins, xbins, k) histogram of the k weight
    columns *W* (N, k) by ``index_add_`` on the flat bin index; *y* None
    is the 1D case (``ybins`` must be 1).  *sum_dtype* takes the sums in
    another dtype than the weights' while the bin indices stay in the
    coordinates' own arithmetic (float64: the truth a float32 kernel run
    is held against)."""
    _check(x, y, W, xbins, ybins)
    fx, inside = _bin_index(x, xlimits, xbins)
    flat = fx
    if y is not None:
        fy, iny = _bin_index(y, ylimits, ybins)
        inside = inside & iny
        flat = fy * xbins + fx
    flat = torch.where(inside, flat, torch.zeros_like(flat)).long()
    w = torch.where(inside[:, None], W, torch.zeros_like(W)).to(
        sum_dtype or W.dtype)
    h = torch.zeros((ybins * xbins, W.shape[1]), dtype=w.dtype,
                    device=W.device)
    h.index_add_(0, flat, w)
    return h.reshape(ybins, xbins, W.shape[1])


def hist2d_kernel(x, y, W, xbins, ybins, xlimits, ylimits=None,
                  use_shared=None):
    """The CUDA kernel: the same function as :func:`hist2d_plain` on CUDA
    tensors.  Each block keeps a private copy of the histogram in shared
    memory when it fits (*use_shared* None picks that by size; True or
    False force a variant, for tests), else atomics go to global memory.
    Raises on anything the kernel does not take and on a failed launch."""
    from .ops import _cuda
    _check(x, y, W, xbins, ybins)
    if x.device.type != 'cuda':
        raise ValueError('hist2d_kernel takes CUDA tensors')
    k = W.shape[1]
    if ybins * xbins * k >= 2 ** 31:
        raise ValueError('histogram too large for the kernel')
    x, W = x.contiguous(), W.contiguous()
    y = None if y is None else y.contiguous()
    nbytes = ybins * xbins * k * W.element_size()
    if use_shared is None:
        use_shared = nbytes <= MAX_SHARED_BYTES
    xlo, xhi = float(xlimits[0]), float(xlimits[1])
    ylo, yhi = (0.0, 1.0) if y is None else \
        (float(ylimits[0]), float(ylimits[1]))
    out = torch.zeros((ybins, xbins, k), dtype=W.dtype, device=W.device)
    fn = _cuda.entry('hist2d', 'hist2d_launch', _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(int(x.dtype == torch.float64), k, x.data_ptr(),
                 None if y is None else y.data_ptr(), W.data_ptr(),
                 x.shape[0], xlo, xhi - xlo, xbins, ylo, yhi - ylo, ybins,
                 out.data_ptr(), int(bool(use_shared)),
                 _cuda.stream_ptr(x.device))
    _cuda.check(err, 'hist2d')
    LAUNCHES[f'hist2d:k{k}:{"shared" if use_shared else "global"}'] += 1
    return out


def hist2d_bwd_plain(x, y, g, xbins, ybins, xlimits, ylimits=None):
    """The plain version of the adjoint with respect to the weights: the
    histogram cotangent *g* (ybins, xbins, k) gathered at every ray's bin by
    advanced indexing, zero for rays outside the limits; returns (N, k)."""
    fx, inside = _bin_index(x, xlimits, xbins)
    flat = fx
    if y is not None:
        fy, iny = _bin_index(y, ylimits, ybins)
        inside = inside & iny
        flat = fy * xbins + fx
    flat = torch.where(inside, flat, torch.zeros_like(flat)).long()
    k = g.shape[-1]
    return torch.where(inside[:, None], g.reshape(-1, k)[flat],
                       g.new_zeros(()))


def hist2d_bwd_kernel(x, y, g, xbins, ybins, xlimits, ylimits=None):
    """The CUDA adjoint kernel: the same function as
    :func:`hist2d_bwd_plain` on CUDA tensors: at k = 1 four consecutive
    rays a thread with 16-byte loads and stores (where x, y and the result
    are 16-byte aligned), else one ray a thread.  Raises on anything the
    kernel does not take and on a failed launch."""
    from .ops import _cuda
    k = g.shape[-1]
    if x.device.type != 'cuda' or g.device != x.device:
        raise ValueError('hist2d_bwd_kernel takes CUDA tensors on one '
                         'device')
    if g.dtype != x.dtype or tuple(g.shape) != (ybins, xbins, k) or \
            k not in (1, 3):
        raise ValueError('histogram cotangent must be (ybins, xbins, 1 or '
                         f'3) of {x.dtype}, not {tuple(g.shape)} of '
                         f'{g.dtype}')
    x, g = x.contiguous(), g.contiguous()
    if g.data_ptr() % 16:       # the kernel reads a colour bin as a pair
        g = g.clone()
    y = None if y is None else y.contiguous()
    xlo, xhi = float(xlimits[0]), float(xlimits[1])
    ylo, yhi = (0.0, 1.0) if y is None else \
        (float(ylimits[0]), float(ylimits[1]))
    out = torch.empty((x.shape[0], k), dtype=x.dtype, device=x.device)
    fn = _cuda.entry('hist2d', 'hist2d_bwd_launch', _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(int(x.dtype == torch.float64), k, x.data_ptr(),
                 None if y is None else y.data_ptr(), g.data_ptr(),
                 x.shape[0], xlo, xhi - xlo, xbins, ylo, yhi - ylo, ybins,
                 out.data_ptr(), _cuda.stream_ptr(x.device))
    _cuda.check(err, 'hist2d_bwd')
    LAUNCHES[f'hist2d_bwd:k{k}'] += 1
    return out


class _Hist2d(torch.autograd.Function):
    """The weighted histogram with its adjoint in the weights: kernels on
    CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, W, x, y, xbins, ybins, xlimits, ylimits):
        ctx.save_for_backward(x, y)
        ctx.spec = (xbins, ybins, xlimits, ylimits)
        if x.device.type == 'cpu':
            return hist2d_plain(x, y, W, xbins, ybins, xlimits, ylimits)
        return hist2d_kernel(x, y, W, xbins, ybins, xlimits, ylimits)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        fn = hist2d_bwd_plain if x.device.type == 'cpu' else \
            hist2d_bwd_kernel
        return (fn(x, y, g, *ctx.spec),) + (None,) * 6


def _hist(x, y, W, xbins, ybins, xlimits, ylimits=None):
    return _Hist2d.apply(W, x.detach(), None if y is None else y.detach(),
                         xbins, ybins, xlimits, ylimits)


def hist1d(x, weights, bins: int, limits):
    """Weighted 1D histogram on fixed limits; returns (bins,)."""
    return _hist(x, None, weights[:, None], bins, 1, limits)[0, :, 0]


def hist1d_rgb(x, rgb, bins: int, limits):
    """RGB-weighted 1D histogram; rgb (N, 3) -> (bins, 3)."""
    return _hist(x, None, rgb, bins, 1, limits)[0]


def hist2d(x, y, weights, xbins, ybins, xlimits, ylimits):
    """Weighted 2D histogram of shape (ybins, xbins): y is the row
    index."""
    return _hist(x, y, weights[:, None], xbins, ybins, xlimits,
                 ylimits)[..., 0]


def hist2d_rgb(x, y, rgb, xbins, ybins, xlimits, ylimits):
    """RGB-weighted 2D histogram; rgb (N, 3) -> (ybins, xbins, 3)."""
    return _hist(x, y, rgb, xbins, ybins, xlimits, ylimits)


def hsv_to_rgb(h, s, v):
    """Vectorized HSV -> RGB (as ``matplotlib.colors.hsv_to_rgb``);
    returns (N, 3)."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.long() % 6)[None]
    r = torch.gather(torch.stack([v, q, p, p, t, v]), 0, i)[0]
    g = torch.gather(torch.stack([t, v, v, q, p, p]), 0, i)[0]
    b = torch.gather(torch.stack([p, p, t, v, v, q]), 0, i)[0]
    return torch.stack([r, g, b], dim=-1)


def colorize(cData, flux, climits, colorFactor=0.85, colorSaturation=1.0):
    """Hue from *cData* mapped over *climits*, brightness from *flux*;
    returns (N, 3) RGB weights."""
    lo, hi = float(climits[0]), float(climits[1])
    c01 = torch.clamp((cData - lo) * colorFactor / (hi - lo), 0.0, 1.0)
    return hsv_to_rgb(c01, torch.full_like(c01, colorSaturation), flux)
