"""The port's histograms and colorization against the JAX package's.

On the CPU the JAX functions take their scatter path, whose bin-index
formula ``floor((v - lo) / (hi - lo) * bins)`` the port uses in its plain
version and in its kernel.  The same numpy inputs go through both:

* float64: every bin to 1e-12 relative to the largest bin (the sums run in
  another order);
* float32: the set of non-empty bins identical (the index arithmetic is
  the same float32 operations) and every bin to 1e-6 relative to the
  largest bin (sums of a few thousand float32 terms in another order);
* rays that are NaN, +-inf, on ``lo``, on ``hi``, on inner bin edges or
  outside the limits land in the same bins in both, or in none;
* ``hsv_to_rgb`` and ``colorize`` to 1e-12 / 1e-6.
"""
import torch_harness  # noqa: F401

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xrt_tpu import histogram as jh
from xrt_tpu_torch import histogram as th

DTYPES = [(torch.float64, np.float64, 1e-12), (torch.float32, np.float32,
                                               1e-6)]
XLIM, YLIM = (-1.0, 1.5), (-0.3, 0.7)


def T(v):
    return torch.from_numpy(np.ascontiguousarray(v))


def rays(npdt, n=5000, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0.2, 0.6, n).astype(npdt)
    y = rng.uniform(-0.5, 0.9, n).astype(npdt)
    w = rng.uniform(0, 2, n).astype(npdt)
    rgb = rng.uniform(0, 1, (n, 3)).astype(npdt)
    return x, y, w, rgb


def special(npdt, bins=16):
    """Values exactly on lo, on hi, on every inner edge, just outside,
    NaN and +-inf, for both axes."""
    ex = np.linspace(XLIM[0], XLIM[1], bins + 1)
    ey = np.linspace(YLIM[0], YLIM[1], bins + 1)
    extra = np.array([np.nan, np.inf, -np.inf, -7.0, 9.0])
    x = np.concatenate([ex, extra, ex, np.nextafter(ex, 9)]).astype(npdt)
    y = np.concatenate([ey, ey[:5], extra, ey[::-1],
                        np.zeros(bins + 1)]).astype(npdt)
    y = y[:x.size]
    rng = np.random.RandomState(1)
    w = rng.uniform(0.5, 1, x.size).astype(npdt)
    rgb = rng.uniform(0.5, 1, (x.size, 3)).astype(npdt)
    return x, y, w, rgb


def agree(got, ref, tol, same_bins):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if same_bins:
        np.testing.assert_array_equal(got != 0, ref != 0)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def both(name, data, bins):
    x, y, w, rgb = data
    jx, jy, jw, jrgb = (jnp.asarray(v) for v in data)
    if name == 'hist1d':
        return (th.hist1d(T(x), T(w), bins, XLIM),
                jh.hist1d(jx, jw, bins, XLIM))
    if name == 'hist1d_rgb':
        return (th.hist1d_rgb(T(x), T(rgb), bins, XLIM),
                jh.hist1d_rgb(jx, jrgb, bins, XLIM))
    if name == 'hist2d':
        return (th.hist2d(T(x), T(y), T(w), bins, bins + 3, XLIM, YLIM),
                jh.hist2d(jx, jy, jw, bins, bins + 3, XLIM, YLIM))
    return (th.hist2d_rgb(T(x), T(y), T(rgb), bins, bins + 3, XLIM, YLIM),
            jh.hist2d_rgb(jx, jy, jrgb, bins, bins + 3, XLIM, YLIM))


NAMES = ['hist1d', 'hist1d_rgb', 'hist2d', 'hist2d_rgb']


@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('tdt,npdt,tol', DTYPES)
def test_histogram_matches_jax(name, tdt, npdt, tol):
    got, ref = both(name, rays(npdt), 32)
    assert got.dtype == tdt
    assert float(got.sum()) > 0
    agree(got, ref, tol, same_bins=True)


@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('tdt,npdt,tol', DTYPES)
def test_edges_nonfinite_and_outside_rays(name, tdt, npdt, tol):
    data = special(npdt)
    got, ref = both(name, data, 16)
    agree(got, ref, tol, same_bins=True)
    # x == hi is outside, x == lo is in the first bin
    one = np.array([XLIM[0], XLIM[1]], npdt)
    h = th.hist1d(T(one), torch.ones(2, dtype=tdt), 16, XLIM)
    assert h[0] == 1 and h.sum() == 1


@pytest.mark.parametrize('tdt,npdt,tol', DTYPES)
def test_one_row_2d_is_the_1d_histogram(tdt, npdt, tol):
    x, y, w, rgb = rays(npdt)
    h1 = th.hist1d_rgb(T(x), T(rgb), 24, XLIM)
    h2 = th.hist2d_rgb(T(x), torch.zeros_like(T(x)), T(rgb), 24, 1, XLIM,
                       (-1.0, 1.0))
    assert h2.shape == (1, 24, 3)
    assert torch.equal(h1, h2[0])
    agree(h1, jh.hist1d_rgb(jnp.asarray(x), jnp.asarray(rgb), 24, XLIM),
          tol, same_bins=True)


@pytest.mark.parametrize('tdt,npdt,tol', DTYPES)
def test_hsv_and_colorize_match_jax(tdt, npdt, tol):
    rng = np.random.RandomState(2)
    h = np.concatenate([rng.uniform(0, 1, 500),
                        np.arange(7) / 6.0]).astype(npdt)
    s = rng.uniform(0, 1, h.size).astype(npdt)
    v = rng.uniform(0, 3, h.size).astype(npdt)
    agree(th.hsv_to_rgb(T(h), T(s), T(v)),
          jh.hsv_to_rgb(jnp.asarray(h), jnp.asarray(s), jnp.asarray(v)),
          tol, same_bins=False)
    c = rng.uniform(8800, 9200, h.size).astype(npdt)
    got = th.colorize(T(c), T(v), (8900.0, 9100.0), 0.85, 0.9)
    ref = jh.colorize(jnp.asarray(c), jnp.asarray(v), (8900.0, 9100.0),
                      0.85, 0.9)
    assert got.shape == (h.size, 3)
    agree(got, ref, tol, same_bins=False)


def test_plain_version_is_the_cpu_route_and_counts_no_launch():
    x, y, w, rgb = rays(np.float32, 100)
    th.LAUNCHES.clear()
    h = th.hist2d(T(x), T(y), T(w), 8, 8, XLIM, YLIM)
    assert torch.equal(h, th.hist2d_plain(T(x), T(y), T(w)[:, None], 8, 8,
                                          XLIM, YLIM)[..., 0])
    assert not th.LAUNCHES
    with pytest.raises(ValueError):      # the kernel takes CUDA tensors
        th.hist2d_kernel(T(x), T(y), T(w)[:, None], 8, 8, XLIM, YLIM)


@pytest.mark.parametrize('case', ['k', 'dtype', 'length', 'ybins', 'bins'])
def test_histogram_refuses_bad_input(case):
    x, y, w, rgb = rays(np.float32, 50)
    args = dict(x=T(x), y=T(y), W=T(rgb), xbins=8, ybins=8, xlimits=XLIM,
                ylimits=YLIM)
    err = ValueError
    if case == 'k':
        args['W'] = T(rgb[:, :2])
    elif case == 'dtype':
        args['W'], err = T(rgb).double(), TypeError
    elif case == 'length':
        args['y'] = T(y[:-1])
    elif case == 'ybins':
        args['y'] = None
    else:
        args['xbins'] = 0
    with pytest.raises(err):
        th.hist2d_plain(**args)


@pytest.mark.parametrize('k', [1, 3])
def test_backward_is_the_gather_and_matches_jax_grad(k):
    """The adjoint with respect to the weights (plain version: advanced
    indexing) against ``jax.grad`` of the JAX package's scatter path, with
    rays on edges, outside, NaN and inf; coordinates get no gradient."""
    import jax
    rng = np.random.RandomState(5)
    n = 3000
    x = rng.uniform(-1.2, 1.5, n)
    y = rng.uniform(-0.7, 1.9, n)
    x[:4] = [np.nan, np.inf, -1.0, 1.3]
    y[4:8] = [np.nan, -np.inf, -0.5, 1.7]
    W = rng.uniform(0.5, 1.5, (n, k))
    c = rng.normal(size=(24, 32, k))
    xl, yl = (-1.0, 1.3), (-0.5, 1.7)

    def jloss(w):
        if k == 1:
            h = jh.hist2d(jnp.asarray(x), jnp.asarray(y), w[:, 0], 32, 24,
                          xl, yl)[..., None]
        else:
            h = jh.hist2d_rgb(jnp.asarray(x), jnp.asarray(y), w, 32, 24, xl,
                              yl)
        return jnp.sum(h * jnp.asarray(c))
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(W)))

    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y)
    tW = torch.from_numpy(W).requires_grad_(True)
    if k == 1:
        h = th.hist2d(tx, ty, tW[:, 0], 32, 24, xl, yl)[..., None]
    else:
        h = th.hist2d_rgb(tx, ty, tW, 32, 24, xl, yl)
    assert h.grad_fn is not None
    gW, gx = torch.autograd.grad((h * torch.from_numpy(c)).sum(), [tW, tx],
                                 allow_unused=True)
    assert gx is None
    assert np.array_equal(gW.numpy(), ref)
    # NaN, inf and v == hi are outside; v == lo (rows 2 and 6) is inside
    assert float(gW[[0, 1, 3, 4, 5, 7]].abs().max()) == 0.0
    direct = th.hist2d_bwd_plain(tx.detach(), ty, torch.from_numpy(c), 32,
                                 24, xl, yl)
    assert torch.equal(direct, gW)


def test_backward_1d_and_no_launch_on_the_cpu():
    x = torch.linspace(-1.5, 1.5, 1001, dtype=torch.float64)
    w = torch.ones(1001, dtype=torch.float64, requires_grad=True)
    before = dict(th.LAUNCHES)
    h = th.hist1d(x, w, 16, (-1.0, 1.3))
    g, = torch.autograd.grad((h * torch.arange(16.0, dtype=torch.float64))
                             .sum(), [w])
    inside = (x >= -1.0) & (x < 1.3)
    assert torch.equal(g != 0, inside & (g != 0)) and float(g.max()) == 15.0
    assert float(g[~inside].abs().max()) == 0.0
    assert dict(th.LAUNCHES) == before
