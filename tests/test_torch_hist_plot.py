"""A plot's histograms (``histogram.hist_plot_plain`` and the kernel's
per-ray arithmetic) on the CPU.

* The per-ray arithmetic of ``csrc/hist_ray.cuh`` (the mask, |flux|, the
  hue and RGB of ``colorize``, the three bin indices, the fixed-point
  weights) is compiled for the host with ``g++ -ffp-contract=off`` against a
  stub of the CUDA runtime and held against the plain PyTorch versions on
  1e5 numpy-seeded rays: every bin index and every float bit for bit, in
  float32 and float64, with hues on sextant edges and clamped, rays on bin
  edges and on ``hi``, NaN and +-inf in every input.  The kernel around it
  (warp sums, routes, merges) runs only on the card
  (``tests/test_torch_cuda.py``).
* The fixed point: the scale exponent at its edges (no weight, n m near
  2^62, the clamp), the bound on colour weights for any saturation, and a
  model of the kernels' sums (the header's ``to_fixed``, ``add_low``,
  ``from_fixed``): the same bits under a permutation of the rays, within
  1e-7 of float64 sums; non-finite weights as a float sum gives them.
* ``hist_plot_plain`` against the JAX package's ``runner.histogram_plot``
  on the same numpy rays: float64 to 1e-12 of each histogram's largest
  bin, float32 to 1e-6 (sums of a few thousand float32 terms in another
  order) with the same non-empty bins; ``runner.histogram_plot`` on CPU
  tensors is ``hist_plot_plain`` and launches nothing.
"""
import torch_harness

import ctypes

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xrt_tpu import plotspec as jps, runner as jrunner
from xrt_tpu.beam import Beam as JBeam
from xrt_tpu_torch import histogram as th, interop, plotspec as tps, \
    runner as trunner

XLIM, YLIM, CLIM = (-1.0, 1.3), (-0.5, 1.7), (8890.0, 9110.0)
BINS = (32, 24, 16)
CF = 0.85

HARNESS = r"""
#include "hist_ray.cuh"
using namespace xhist;
template <typename T>
void rays(long long n, const T* x, const T* y, const T* c, const T* f,
          const T* w, const unsigned char* m, const double* ax, int* bins,
          T* out) {
  const PlotAxes<T> a{T(ax[0]), T(ax[1]), T(ax[2]), T(ax[3]), T(ax[4]),
                      T(ax[5]), T(ax[6]), T(ax[7]), T(ax[8]), T(ax[9]),
                      T(ax[10])};
  for (long long i = 0; i < n; ++i) {
    const PlotRay<T> r = plot_ray(x[i], y[i], c[i], f[i], w[i], m[i] != 0, a);
    bins[3 * i] = r.ix; bins[3 * i + 1] = r.iy; bins[3 * i + 2] = r.ic;
    T* o = out + 5 * i;
    o[0] = r.af; o[1] = r.w2; o[2] = r.rgb[0]; o[3] = r.rgb[1];
    o[4] = r.rgb[2];
  }
}
extern "C" void rays_f(long long n, const float* x, const float* y,
                       const float* c, const float* f, const float* w,
                       const unsigned char* m, const double* ax, int* bins,
                       float* out) { rays(n, x, y, c, f, w, m, ax, bins, out); }
extern "C" void rays_d(long long n, const double* x, const double* y,
                       const double* c, const double* f, const double* w,
                       const unsigned char* m, const double* ax, int* bins,
                       double* out) { rays(n, x, y, c, f, w, m, ax, bins, out); }
extern "C" int exp_of(double m, long long n) { return fixed_exp(m, n); }
extern "C" long long count_f(long long n) { return scale_count<float>(n); }
extern "C" long long count_d(long long n) { return scale_count<double>(n); }
extern "C" float bound_f(float m, float s) { return rgb_bound(m, s); }
extern "C" float finite_abs_f(float w) { return finite_abs(w); }
// the fixed-point sums of w (n) into bins (-1: none) in the given order,
// as the kernels' shared-memory tables add them: the low words by add_low,
// the high parts into 64-bit sums, the low words added at the end; the
// int64 sums and the sums converted to float
extern "C" void fixed_sums(long long n, const float* w, const int* bins,
                           const long long* order, int nbins, int e,
                           long long* sums, float* out) {
  unsigned* lo = new unsigned[nbins]();
  unsigned long long* hi = new unsigned long long[nbins]();
  unsigned* flags = new unsigned[nbins]();
  const double scale = ldexp(1.0, e);
  for (long long j = 0; j < n; ++j) {
    const long long i = order[j];
    if (bins[i] < 0) continue;
    const unsigned f = nonfinite(w[i]);
    if (f) flags[bins[i]] |= f;
    else hi[bins[i]] += static_cast<unsigned long long>(
        add_low(lo + bins[i], to_fixed(w[i], scale))) << 32;
  }
  for (int b = 0; b < nbins; ++b) {
    sums[b] = static_cast<long long>(hi[b] + lo[b]);
    out[b] = with_flags(from_fixed(sums[b], e, 0.0f), flags[b]);
  }
  delete[] lo;
  delete[] hi;
  delete[] flags;
}
// the float32 kernels' two words: the coarse sums as fixed_sums adds them,
// each sum's largest faint |w| (a weight with a rounding residual) as the
// faint pass finds it, the fine words at that sum's fine exponent
// (fine_fixed) as int64 sums, combined by from_fixed2
extern "C" void fixed_sums2(long long n, const float* w, const int* bins,
                            const long long* order, int nbins, int e,
                            long long* sums, long long* fines, float* out) {
  unsigned* lo = new unsigned[nbins]();
  unsigned long long* hi = new unsigned long long[nbins]();
  unsigned long long* fi = new unsigned long long[nbins]();
  float* fm = new float[nbins]();
  const double scale = ldexp(1.0, e);
  for (long long i = 0; i < n; ++i)
    if (bins[i] >= 0 && !nonfinite(w[i]) &&
        residual(w[i], to_fixed(w[i], scale), scale) != 0.0)
      fm[bins[i]] = fmaxf(fm[bins[i]], fabsf(w[i]));
  for (long long j = 0; j < n; ++j) {
    const long long i = order[j];
    if (bins[i] < 0 || nonfinite(w[i])) continue;
    const long long q = to_fixed(w[i], scale);
    hi[bins[i]] += static_cast<unsigned long long>(
        add_low(lo + bins[i], q)) << 32;
    const double r = residual(w[i], q, scale);
    if (r != 0.0)
      fi[bins[i]] += static_cast<unsigned long long>(
          fine_fixed(r, fixed_exp(fm[bins[i]], scale_count<float>(n)), e));
  }
  for (int b = 0; b < nbins; ++b) {
    sums[b] = static_cast<long long>(hi[b] + lo[b]);
    fines[b] = static_cast<long long>(fi[b]);
    out[b] = from_fixed2(sums[b], fines[b], e,
                         fixed_exp(fm[b], scale_count<float>(n)));
  }
  delete[] lo;
  delete[] hi;
  delete[] fi;
  delete[] fm;
}
"""


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    lib = torch_harness.host_build(tmp_path_factory, 'hist_ray',
                                   {'harness.cpp': HARNESS},
                                   headers=('hist_ray.cuh',))
    lib.exp_of.argtypes = [ctypes.c_double, ctypes.c_longlong]
    for f in (lib.count_f, lib.count_d):
        f.argtypes, f.restype = [ctypes.c_longlong], ctypes.c_longlong
    lib.bound_f.argtypes = [ctypes.c_float, ctypes.c_float]
    lib.bound_f.restype = ctypes.c_float
    lib.finite_abs_f.argtypes = [ctypes.c_float]
    lib.finite_abs_f.restype = ctypes.c_float
    return lib


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def edge_rays(npdt, n=100_000, seed=0):
    """(x, y, c, flux, w2d, mask) numpy rays: uniform ones, then rays on
    every bin edge and on hi, hues on and next to every sextant edge and
    past both ends of the hue range, and NaN / +-inf in every input."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.1, 1.4, n)
    y = rng.uniform(-0.6, 1.8, n)
    c = rng.uniform(8800, 9200, n)
    f = rng.uniform(-2, 3, n)
    w = rng.uniform(-1, 2, n)
    m = rng.uniform(size=n) < 0.8
    k = 0

    def put(arr, vals):
        nonlocal k
        arr[k:k + len(vals)] = vals
        k += len(vals)
    put(x, np.linspace(*XLIM, BINS[0] + 1))
    put(y, np.linspace(*YLIM, BINS[1] + 1))
    put(c, np.linspace(*CLIM, BINS[2] + 1))
    # h = (c - lo) cf / span on j / 6 and its float neighbours, and beyond
    span = CLIM[1] - CLIM[0]
    hue = CLIM[0] + np.arange(7) / 6.0 * span / CF
    hue = hue.astype(npdt)
    put(c, np.concatenate([hue, np.nextafter(hue, np.inf, dtype=npdt),
                           np.nextafter(hue, -np.inf, dtype=npdt),
                           [CLIM[0] - 50, CLIM[1] + 50, CLIM[0] + span / CF]]))
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0])
    for arr in (x, y, c, f, w):
        put(arr, special)
    cast = [a.astype(npdt) for a in (x, y, c, f, w)]
    return cast + [m]


@pytest.mark.parametrize('tdt,npdt,fn', [(torch.float32, np.float32, 'f'),
                                         (torch.float64, np.float64, 'd')])
@pytest.mark.parametrize('sat', [1.0, 0.6, 1.7])
def test_plot_ray_is_the_plain_version_bit_for_bit(lib, tdt, npdt, fn, sat):
    x, y, c, f, w, m = edge_rays(npdt)
    n = x.size
    ax = np.array([XLIM[0], XLIM[1] - XLIM[0], BINS[0], YLIM[0],
                   YLIM[1] - YLIM[0], BINS[1], CLIM[0], CLIM[1] - CLIM[0],
                   BINS[2], CF, sat])
    bins = np.zeros((n, 3), np.int32)
    out = np.zeros((n, 5), npdt)
    mm = np.ascontiguousarray(m, np.uint8)
    getattr(lib, f'rays_{fn}')(ctypes.c_longlong(n), _p(x), _p(y), _p(c),
                               _p(f), _p(w), _p(mm), _p(ax), _p(bins),
                               _p(out))
    T = torch.from_numpy
    fm = T(m).to(tdt)
    af = torch.abs(T(f) * fm)
    rgb = th.colorize(T(c), af, CLIM, CF, sat)
    for col, ref in ((0, af), (1, T(w) * fm)):
        assert np.array_equal(np.ascontiguousarray(out[:, col]).view(np.uint8),
                              ref.numpy().view(np.uint8))
    assert np.array_equal(np.ascontiguousarray(out[:, 2:]).view(np.uint8),
                          rgb.numpy().view(np.uint8))
    for j, (v, lim, b) in enumerate(((x, XLIM, BINS[0]), (y, YLIM, BINS[1]),
                                     (c, CLIM, BINS[2]))):
        fidx, inside = th._bin_index(T(v), lim, b)
        ref = torch.where(inside, fidx, torch.full_like(fidx, -1)).long()
        assert np.array_equal(bins[:, j], ref.numpy())
    # the edges were hit: every bin of x, rays outside, sextant wraps
    assert set(bins[:, 0]) == set(range(-1, BINS[0]))


def test_fixed_exp_edges(lib):
    assert lib.exp_of(0.0, 10) == 0 and lib.exp_of(1.0, 0) == 0
    for m, n in ((1.0, 1), (1.5, 10_000_000), (3e-30, 7), (2.0 ** 20, 2 ** 20),
                 (np.nextafter(2.0, 3.0), 2 ** 30), (1e200, 1 << 62)):
        e = lib.exp_of(m, n)
        # no sum of n weights |w| <= m leaves 2^62, and one bit less would
        assert n * m * 2.0 ** e <= 2.0 ** 62 < 2 * n * m * 2.0 ** e
    # n m exactly a power of two, and the clamp of 2^e to finite doubles
    assert lib.exp_of(0.5, 8) == 60
    assert lib.exp_of(1e308, 10 ** 6) == -982      # n m past the doubles
    assert lib.exp_of(5e-324, 1) == 1000 and \
        lib.exp_of(1e308, 1 << 62) == -1000
    # float32 weights get 28 bits (a carry in 16 adds at most), float64
    # ones 62 - log2 n
    assert lib.count_f(10 ** 7) == 2 ** 34 == lib.count_f(1)
    assert lib.count_f(2 ** 40) == 2 ** 40 and lib.count_d(10 ** 7) == 10 ** 7
    assert lib.finite_abs_f(float('nan')) == 0.0 and \
        lib.finite_abs_f(float('-inf')) == 0.0 and lib.finite_abs_f(-2.5) == 2.5


@pytest.mark.parametrize('sat', [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, -0.7])
def test_rgb_bound_holds_for_any_saturation(lib, sat):
    rng = np.random.RandomState(3)
    v = rng.uniform(0, 3, 20_000).astype(np.float32)
    c = rng.uniform(8800, 9200, v.size).astype(np.float32)
    rgb = th.colorize(torch.from_numpy(c), torch.from_numpy(v), CLIM, CF,
                      sat).numpy()
    bound = lib.bound_f(float(v.max()), sat)
    assert np.abs(rgb).max() <= bound
    assert bound <= float(v.max()) * max(1.0, abs(1.0 - sat)) * (1 + 1e-6)


def _fixed_sums(lib, w, bins, order, nbins, e):
    sums = np.zeros(nbins, np.int64)
    out = np.zeros(nbins, np.float32)
    lib.fixed_sums(ctypes.c_longlong(w.size), _p(w), _p(bins), _p(order),
                   ctypes.c_int(nbins), ctypes.c_int(e), _p(sums), _p(out))
    return sums, out


@pytest.mark.parametrize('count', ['f', 'd'])
def test_fixed_point_sums_are_order_free(lib, count):
    """The float32 scale (28-bit weights: the high part takes carries and
    signs) and the float64 one (44-bit weights here: every add has one)."""
    rng = np.random.RandomState(4)
    n, nbins = 200_000, 64
    w = rng.uniform(-1.0, 3.0, n).astype(np.float32)
    # a focused part: a third of the rays in one bin
    bins = np.where(rng.uniform(size=n) < 0.33, 5,
                    rng.randint(-1, nbins, n)).astype(np.int32)
    e = lib.exp_of(float(np.abs(w).max()), getattr(lib, f'count_{count}')(n))
    a, ha = _fixed_sums(lib, w, bins, np.arange(n, dtype=np.int64), nbins, e)
    b, hb = _fixed_sums(lib, w, bins, rng.permutation(n).astype(np.int64),
                        nbins, e)
    assert np.array_equal(a, b) and np.array_equal(ha.view(np.int32),
                                                   hb.view(np.int32))
    # low words and high parts give the int64 sums of the rounded weights
    q = np.rint(w.astype(np.float64) * 2.0 ** e).astype(np.int64)
    ref = np.zeros(nbins, np.int64)
    np.add.at(ref, bins[bins >= 0], q[bins >= 0])
    assert np.array_equal(a, ref)
    h64 = np.zeros(nbins)
    np.add.at(h64, bins[bins >= 0], w[bins >= 0].astype(np.float64))
    assert np.abs(ha - h64).max() <= 1e-7 * np.abs(h64).max()


def test_fine_words_keep_the_faint_bins(lib):
    """Weights from 1e-30 to 1 of the largest, half the bins filled only
    by faint rays (a quarter of them by rays below 1e-20, beneath any
    fixed unit of the launch's largest weight): with the fine words at
    each sum's own scale every bin the float64 sum fills is filled, each
    within 1e-6 of its float64 value, and the bits do not depend on the
    order of the rays; no fine sum leaves 2^62 + n."""
    rng = np.random.RandomState(6)
    n, nbins = 1_000_000, 64
    bins = rng.randint(-1, nbins, n).astype(np.int32)
    # bins 0-31 hold rays of every decade, bins 32-47 only rays below the
    # coarse word's half unit (m 2^-29 = 1.9e-9), bins 48-63 only rays
    # below 1e-20
    w = 10.0 ** np.where(bins >= 48, rng.uniform(-30, -20, n),
                         np.where(bins >= 32, rng.uniform(-15, -9, n),
                                  rng.uniform(-30, 0, n)))
    w[rng.uniform(size=n) < 0.2] *= -1
    w[0], bins[0] = 1.0, 0
    w = w.astype(np.float32)
    e = lib.exp_of(float(np.abs(w).max()), lib.count_f(n))
    sums, fines = np.zeros(nbins, np.int64), np.zeros(nbins, np.int64)
    outs = []
    for order in (np.arange(n), rng.permutation(n)):
        out = np.zeros(nbins, np.float32)
        lib.fixed_sums2(ctypes.c_longlong(n), _p(w), _p(bins),
                        _p(order.astype(np.int64)), ctypes.c_int(nbins),
                        ctypes.c_int(e), _p(sums), _p(fines), _p(out))
        outs.append(out)
    assert np.array_equal(outs[0].view(np.int32), outs[1].view(np.int32))
    assert np.abs(fines).max() <= 2.0 ** 62 + n
    h64 = np.zeros(nbins)
    np.add.at(h64, bins[bins >= 0], w[bins >= 0].astype(np.float64))
    assert np.array_equal(outs[0] != 0, h64 != 0) and (h64[32:] != 0).all()
    assert np.abs(outs[0] / h64 - 1).max() < 1e-6
    # the coarse words alone empty the faint bins
    _, coarse = _fixed_sums(lib, w, bins, np.arange(n, dtype=np.int64),
                            nbins, e)
    assert (coarse[32:] == 0).all()


def test_nonfinite_weights_give_what_a_float_sum_gives(lib):
    cases = [[1.0, np.nan], [np.inf, 2.0], [-np.inf, 1.0], [np.inf, -np.inf],
             [np.inf, np.inf, np.nan], [-np.inf, -np.inf], [2.0, -2.0]]
    w = np.concatenate(cases).astype(np.float32)
    bins = np.concatenate([[i] * len(cc) for i, cc in enumerate(cases)]
                          ).astype(np.int32)
    _, out = _fixed_sums(lib, w, bins, np.arange(w.size, dtype=np.int64),
                         len(cases), 60)
    ref = torch.zeros(len(cases)).index_add_(0, torch.from_numpy(bins).long(),
                                             torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(out, ref)


def beam_arrays(npdt, n=6000, seed=5):
    """Screen-beam fields and a state with good, out, over and dead rays;
    rays on the plot's bin edges and outside its limits."""
    rng = np.random.RandomState(seed)
    d = dict(x=rng.uniform(-1.1, 1.4, n), y=np.zeros(n),
             z=rng.uniform(-0.6, 1.8, n), a=np.zeros(n), b=np.ones(n),
             c=np.zeros(n), E=rng.uniform(8880, 9120, n),
             path=np.zeros(n), Jss=rng.uniform(0, 2, n),
             Jpp=rng.uniform(0, 0.5, n), Jsp=np.zeros(n, complex),
             state=rng.choice([1, 1, 1, 2, 3, -1], n).astype(np.int32))
    d['x'][:BINS[0] + 1] = np.linspace(*XLIM, BINS[0] + 1)
    d['z'][:BINS[1] + 1] = np.linspace(*YLIM, BINS[1] + 1)
    for k in ('x', 'z', 'E', 'Jss', 'Jpp', 'path', 'y', 'a', 'b', 'c'):
        d[k] = d[k].astype(npdt)
    d['Jsp'] = d['Jsp'].astype(np.complex64 if npdt == np.float32
                               else np.complex128)
    return d


def make_plot(mod, sat):
    return mod.XYCPlot(
        beam='screen', colorSaturation=sat,
        xaxis=mod.XYCAxis('x', 'mm', bins=BINS[0], limits=list(XLIM)),
        yaxis=mod.XYCAxis('z', 'mm', bins=BINS[1], limits=list(YLIM)),
        caxis=mod.XYCAxis('energy', 'eV', bins=BINS[2], limits=list(CLIM)))


@pytest.mark.parametrize('tdt,npdt,tol', [(torch.float64, np.float64, 1e-12),
                                          (torch.float32, np.float32, 1e-6)])
@pytest.mark.parametrize('sat', [1.0, 0.8])
def test_hist_plot_plain_matches_jax(tdt, npdt, tol, sat):
    d = beam_arrays(npdt)
    jimg = JBeam(**{k: jnp.asarray(v) for k, v in d.items()})
    ref = jrunner.histogram_plot(make_plot(jps, sat), {'screen': jimg})
    timg = interop.beam_from_numpy(d, device='cpu', dtype=tdt)
    x, y, c, inten, flux, mask, _ = trunner._plot_arrays(
        make_plot(tps, sat), {'screen': timg})
    got = th.hist_plot_plain(x, y, c, flux, inten, mask, BINS,
                             (XLIM, YLIM, CLIM), CF, sat)
    th.LAUNCHES.clear()
    via_runner = trunner.histogram_plot(make_plot(tps, sat),
                                        {'screen': timg})
    assert not th.LAUNCHES
    for k in th.PLOT_HISTS:
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape and g.dtype == r.dtype, k
        assert r.max() > 0
        np.testing.assert_array_equal(g != 0, r != 0)
        assert np.abs(g - r).max() <= tol * np.abs(r).max(), k
        assert torch.equal(via_runner[k], got[k]), k
    assert abs(float(got['intensity']) / float(ref['intensity']) - 1) < tol
    # the float64 sums of hist_plot_plain hold the float32 ones
    if tdt == torch.float32:
        h64 = th.hist_plot_plain(x, y, c, flux, inten, mask, BINS,
                                 (XLIM, YLIM, CLIM), CF, sat,
                                 sum_dtype=torch.float64)
        for k in th.PLOT_HISTS:
            assert h64[k].dtype == torch.float64
            assert float((h64[k] - got[k].double()).abs().max()) <= \
                1e-6 * float(h64[k].abs().max()), k
