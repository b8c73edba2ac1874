"""Weighted histograms with hue + brightness colorization.

Port of the reference package's ``histogram.py``: ``hist1d``,
``hist1d_rgb``, ``hist2d``, ``hist2d_rgb``, ``hsv_to_rgb`` and
``colorize``.  Histograms are linear, so repeats accumulate by addition.

All four histogram functions are one function, the weighted histogram of
N rays into (ybins, xbins, k) bins with k weight columns (a 1D histogram
is its ``ybins = 1`` case):

* on CUDA tensors :func:`hist2d_kernel` launches the hand-written
  kernel ``csrc/hist2d.cu`` (which replaces the TPU kernel
  ``xrt_tpu/histogram.py:89 hist2d_mxu``) and counts the launch in
  :data:`LAUNCHES`; there is no fallback;
* on CPU tensors :func:`hist2d_plain` does the same index arithmetic in
  torch and ``index_add_`` on the flat index.

A plot's eight histograms (``runner.histogram_plot``) are one function
too, :func:`hist_plot_plain` (``colorize`` and the eight histograms) on
CPU tensors and one kernel, :func:`hist_plot_kernel` (``csrc/hist_plot.cu``),
on CUDA tensors: one read of the rays for all eight.

The kernels add fixed-point integers (``csrc/hist_accum.cuh``): two
launches, and both routes of a table (:data:`ROUTES`), give the same bits.
Their only rounding is one a weight: for n float32 weights of magnitude at
most m, a coarse word of unit about m 2^-28 (2^-18 of a weight above
about m 2^-11) and, for a weight below that, a fine word for its residual
at its sum's own scale (a bin's column), of at most M 2^-29 for M the
largest such weight of that sum, so a bin that only faint rays fill keeps
their sum as a float sum does, however faint; 2^-63 n m for n float64
weights (one word).

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

#: the most dynamic shared memory a block may use on sm_90: a table that
#: fits gets a private copy of its sums' low 32-bit words in every CTA
MAX_SHARED_BYTES = 232448
#: where a kernel's table lives: a private copy in each CTA's shared
#: memory, or device memory
ROUTES = ('shared', 'global')

#: kernel launches by 'hist2d:k<k>:<route>', 'hist2d_bwd:k<k>' and
#: 'hist_plot:<route>', counted where the kernel launches
#: (``LAUNCHES.clear()`` before a run, read after it)
LAUNCHES: collections.Counter = collections.Counter()

_ARGTYPES = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 +
             [ctypes.c_longlong, ctypes.c_double, ctypes.c_double,
              ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p])
# the adjoint's entry: no route and no work buffer
_BWD_ARGTYPES = _ARGTYPES[:13] + [ctypes.c_void_p]
_PLOT_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 +
                  [ctypes.c_longlong] +
                  [ctypes.c_double, ctypes.c_double, ctypes.c_int] * 3 +
                  [ctypes.c_double, ctypes.c_double, ctypes.c_int] +
                  [ctypes.c_void_p] * 3)


def _route(sums, fixed=0):
    """The route of a table of *sums* sums beside *fixed* that every CTA
    keeps in shared memory anyway (4 bytes each): shared when the CTA holds
    both."""
    return 'shared' if 4 * (fixed + sums) <= MAX_SHARED_BYTES else 'global'


def hist_route(xbins, ybins, k):
    """Where :func:`hist2d_kernel` keeps a (ybins, xbins, k) table by
    default."""
    return _route(xbins * ybins * k)


def plot_route(bins):
    """Where :func:`hist_plot_kernel` keeps the 2D colour columns of a plot
    of *bins* (x, y, c) by default, beside the 1D tables' coarse and fine
    low words."""
    xb, yb, cb = bins
    return _route(3 * xb * yb, 8 * (xb + yb + cb))


def _check_route(route):
    if route not in ROUTES:
        raise ValueError(f'route must be one of {ROUTES}, not {route!r}')
    return ROUTES.index(route)


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
                  route=None):
    """The CUDA kernel: the same function as :func:`hist2d_plain` on CUDA
    tensors, as fixed-point sums.  *route* None picks where the table lives
    by its size (a private copy in each CTA's shared memory when it fits,
    else device memory); a name of :data:`ROUTES` forces one (tests).
    Raises on anything the kernel does not take and on a refused or failed
    launch."""
    from .ops import _cuda
    _check(x, y, W, xbins, ybins)
    if x.device.type != 'cuda':
        raise ValueError('hist2d_kernel takes CUDA tensors')
    k = W.shape[1]
    if ybins * xbins * 4 >= 2 ** 31:
        raise ValueError('histogram too large for the kernel')
    route = route or hist_route(xbins, ybins, k)
    code = _check_route(route)
    x, W = x.detach().contiguous(), W.detach().contiguous()
    y = None if y is None else y.detach().contiguous()
    xlo, xhi = float(xlimits[0]), float(xlimits[1])
    ylo, yhi = (0.0, 1.0) if y is None else \
        (float(ylimits[0]), float(ylimits[1]))
    lib = _cuda.load('hist2d')
    lib.hist2d_work.argtypes = [ctypes.c_int] * 4
    lib.hist2d_work.restype = ctypes.c_longlong
    work = torch.zeros(lib.hist2d_work(int(x.dtype == torch.float64), k,
                                       xbins, ybins),
                       dtype=torch.int64, device=x.device)
    out = torch.empty((ybins, xbins, k), dtype=W.dtype, device=W.device)
    fn = _cuda.entry('hist2d', 'hist2d_launch', _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(int(x.dtype == torch.float64), k, x.data_ptr(),
                 None if y is None else y.data_ptr(), W.data_ptr(),
                 x.shape[0], xlo, xhi - xlo, xbins, ylo, yhi - ylo, ybins,
                 out.data_ptr(), code, work.data_ptr(),
                 _cuda.stream_ptr(x.device))
    _cuda.check(err, 'hist2d')
    LAUNCHES[f'hist2d:k{k}:{route}'] += 1
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
    # a true division on every device, as in _bin_index and the kernel
    span = torch.full((), hi - lo, dtype=cData.dtype, device=cData.device)
    c01 = torch.clamp((cData - lo) * colorFactor / span, 0.0, 1.0)
    return hsv_to_rgb(c01, torch.full_like(c01, colorSaturation), flux)


#: the histograms of a plot, in the order of the kernel's output
PLOT_HISTS = ('xh', 'xhRGB', 'yh', 'yhRGB', 'eh', 'ehRGB', 'xyh', 'xyhRGB')


def hist_plot_plain(x, y, cData, flux, w2d, mask, bins, limits,
                    colorFactor=0.85, colorSaturation=1.0, sum_dtype=None):
    """The plain version of one plot's histograms for one pass: the rays'
    x, y and cData, their flux (brightness and the 1D weights) and w2d (the
    2D intensity weight), the plot's ray mask; *bins* and *limits* of the
    x, y and c axes.  Returns {name: histogram} for :data:`PLOT_HISTS` and
    the total |flux| as 'intensity'.  *sum_dtype* takes the sums in another
    dtype (float64: the truth a float32 kernel run is held against)."""
    (xb, yb, cb), (xlim, ylim, clim) = bins, limits
    fmask = mask.to(x.dtype)
    aflux = torch.abs(flux * fmask)
    w2d = w2d * fmask
    rgb = colorize(cData, aflux, clim, colorFactor, colorSaturation)

    def h(v, w, b, lim, vy=None, by=1, limy=None):
        out = hist2d_plain(v, vy, w[:, None] if w.ndim == 1 else w, b, by,
                           lim, limy, sum_dtype=sum_dtype)
        out = out[0] if vy is None else out
        return out[..., 0] if w.ndim == 1 else out
    return dict(
        xh=h(x, aflux, xb, xlim), xhRGB=h(x, rgb, xb, xlim),
        yh=h(y, aflux, yb, ylim), yhRGB=h(y, rgb, yb, ylim),
        eh=h(cData, aflux, cb, clim), ehRGB=h(cData, rgb, cb, clim),
        xyh=h(x, w2d, xb, xlim, y, yb, ylim),
        xyhRGB=h(x, rgb, xb, xlim, y, yb, ylim),
        intensity=torch.sum(aflux.to(sum_dtype or aflux.dtype)))


def hist_plot_kernel(x, y, cData, flux, w2d, mask, bins, limits,
                     colorFactor=0.85, colorSaturation=1.0, route=None):
    """The CUDA kernel of :func:`hist_plot_plain`: one launch for the eight
    histograms, colorize and the total, with fixed-point sums.  The 1D
    tables live in every CTA's shared memory; *route* places the 2D
    table's colour columns (None: by their size; a name of :data:`ROUTES`
    forces one).  Forward
    only.  Raises on anything the kernel does not take and on a refused or
    failed launch."""
    from .ops import _cuda
    (xb, yb, cb), (xlim, ylim, clim) = bins, limits
    n = x.shape[0]
    rays = (x, y, cData, flux, w2d)
    if any(v.device.type != 'cuda' or v.device != x.device
           for v in rays + (mask,)):
        raise ValueError('hist_plot_kernel takes CUDA tensors on one device')
    if x.dtype not in (torch.float32, torch.float64) or \
            any(v.dtype != x.dtype for v in rays) or mask.dtype != torch.bool:
        raise TypeError('hist_plot_kernel takes float32 or float64 rays of '
                        'one dtype and a bool mask')
    if any(v.shape != (n,) for v in rays + (mask,)):
        raise ValueError('hist_plot_kernel takes (N,) rays and mask')
    if min(xb, yb, cb) < 1 or xb * yb * 4 >= 2 ** 31 or \
            32 * (xb + yb + cb) > MAX_SHARED_BYTES:
        raise ValueError('plot bins out of the kernel\'s range: '
                         f'{(xb, yb, cb)}')
    route = route or plot_route(bins)
    code = _check_route(route)
    rays = [v.detach().contiguous() for v in rays]
    mask = mask.contiguous()
    lib = _cuda.load('hist_plot')
    lib.hist_plot_work.argtypes = [ctypes.c_int] * 4
    lib.hist_plot_work.restype = ctypes.c_longlong
    work = torch.zeros(lib.hist_plot_work(int(x.dtype == torch.float64), xb,
                                          yb, cb),
                       dtype=torch.int64, device=x.device)
    nb = xb + yb + cb + xb * yb
    out = torch.empty(4 * nb + 1, dtype=x.dtype, device=x.device)
    axes = []
    for (lo, hi), b in zip((xlim, ylim, clim), (xb, yb, cb)):
        axes += [float(lo), float(hi) - float(lo), b]
    fn = _cuda.entry('hist_plot', 'hist_plot_launch', _PLOT_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(int(x.dtype == torch.float64),
                 *[v.data_ptr() for v in rays], mask.data_ptr(), n, *axes,
                 float(colorFactor), float(colorSaturation), code,
                 work.data_ptr(), out.data_ptr(), _cuda.stream_ptr(x.device))
    _cuda.check(err, 'hist_plot')
    LAUNCHES[f'hist_plot:{route}'] += 1
    res, pos = {}, 0
    for (name, b) in zip(PLOT_HISTS[0::2], (xb, yb, cb)):
        res[name] = out[pos:pos + b]
        res[name + 'RGB'] = out[pos + b:pos + 4 * b].view(b, 3)
        pos += 4 * b
    res['xyh'] = out[pos:pos + xb * yb].view(yb, xb)
    res['xyhRGB'] = out[pos + xb * yb:pos + 4 * xb * yb].view(yb, xb, 3)
    res['intensity'] = out[-1]
    return res
