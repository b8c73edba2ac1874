"""Tests of the CUDA kernels, which run only on a machine with a card.

Marked ``cuda`` and skipped without a CUDA device (the kernels have no
CPU or interpret mode; their plain versions are what the CPU tests
check).  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

* each kernel (B1 mono/narrowband/poly, B2 fast/exact) against its plain
  PyTorch version on the same CUDA tensors, to max|d| / max|ref| < 2e-5
  (f32 sums of ~1e3 terms in another order);
* the double-float device helpers bit for bit against the torch dd;
* the wrappers count their launches, and a failing launch raises;
* the histogram kernel (B4) against its plain version with the sums taken
  in float64, for k = 1 and 3: both variants (block-private shared-memory
  copies, global atomics), the 1D case, a focused beam, rays on edges /
  NaN / +-inf / outside (identical sets of non-empty bins), and a ray count
  that is no multiple of the block.  Limit max|h - h64| / max|h64| < 1e-5
  (float32 partial sums merged by atomics in an order that changes from
  run to run); 1e-4 for the focused beam, where one bin takes a quarter
  of a block's rays in one running float32 sum.
"""
import numpy as np
import pytest
import torch

from xrt_tpu_torch import histogram as th
from xrt_tpu_torch.ops import dd, kirchhoff as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    return torch.device('cuda')


def _args(device, poly, Ns=3000, Nd=1000, seed=3):
    rng = np.random.RandomState(seed)
    xs = rng.uniform(-0.5, 0.5, Ns)
    ys = rng.uniform(-0.05, 0.05, Ns)
    zs = rng.uniform(-0.5, 0.5, Ns)
    xd = rng.uniform(-1, 1, Nd)
    yd = np.full(Nd, 10000.0)
    zd = rng.uniform(-1, 1, Nd)
    Es = np.exp(1j * rng.uniform(0, 2 * np.pi, Ns))
    k = np.full(Ns, 9000.0 / 1973.269788 * 1e7)
    if poly:
        k = k * (1 + rng.uniform(-1e-4, 1e-4, Ns))

    def D(v):
        return tuple(torch.from_numpy(a).to(device) for a in dd.from_f64(v))

    def F(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(device)
    return (D(xd), D(yd), D(zd), D(xs), D(ys), D(zs),
            torch.from_numpy(Es.astype(np.complex64)).to(device),
            torch.from_numpy((0.3 * Es).astype(np.complex64)).to(device),
            D(k), [F(np.full(Ns, v)) for v in (0.01, 0.99, 0.02)],
            F(np.full(Ns, 0.9)), F(np.ones(Ns)))


def _rel(got, ref):
    return max(float((g - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref))


@pytest.mark.parametrize('mode', ['mono', 'narrowband', 'poly'])
def test_recentred_kernel_matches_plain(cuda, mode):
    args = _args(cuda, poly=mode != 'mono')
    kw = dict(monochromatic=mode == 'mono', narrowband=mode == 'narrowband')
    before = tk.LAUNCHES[f'kirchhoff_recentred:{mode}']
    got = tk.kirchhoff_integral_kernel(*args, accumulate='vpu', **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[f'kirchhoff_recentred:{mode}'] == before + 1
    ref = tk.kirchhoff_integral_recentred(*args, **kw)
    assert _rel(got, ref) < 2e-5


@pytest.mark.parametrize('pm', ['fast', 'exact'])
def test_ddphase_kernel_matches_plain(cuda, pm):
    args = _args(cuda, poly=True)
    before = tk.LAUNCHES[f'kirchhoff_ddphase:{pm}']
    got = tk.kirchhoff_integral_kernel(*args, phase_mode=pm)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[f'kirchhoff_ddphase:{pm}'] == before + 1
    ref = tk.kirchhoff_integral_dd(*args, phase_mode=pm)
    assert _rel(got, ref) < 2e-5


def test_ragged_sizes(cuda):
    """Destinations not a multiple of the block, sources not a multiple
    of the shared-memory chunk."""
    args = _args(cuda, poly=False, Ns=257, Nd=129)
    got = tk.kirchhoff_integral_kernel(*args, monochromatic=True,
                                       accumulate='vpu')
    ref = tk.kirchhoff_integral_recentred(*args, monochromatic=True)
    assert _rel(got, ref) < 2e-5


def test_dd_helpers_bit_identical(cuda):
    g = torch.Generator().manual_seed(0)
    n = 200_000
    a = (torch.rand(n, generator=g, dtype=torch.float64) * 2e4 - 1e4)
    b = torch.rand(n, generator=g, dtype=torch.float64) * 2 - 1
    c = torch.rand(n, generator=g, dtype=torch.float64) - 0.5
    a, b, c = (v.float().to(cuda) for v in (a, b, c))
    got = dd.selftest(a, b, c)
    assert torch.equal(got, dd.selftest(a.cpu(), b.cpu(), c.cpu()).to(cuda))


def test_float64_is_refused_by_the_kernel(cuda):
    args = _args(cuda, poly=False, Ns=300, Nd=100)
    dst, src, params = tk.recentre_kirchhoff_inputs(*args,
                                                    monochromatic=True)
    dst = {k: v.double() for k, v in dst.items()}
    with pytest.raises(TypeError):
        tk._launch_recentred(dst, src, params, 0, 100, 300)


def test_refused_launch_raises(cuda):
    """A launch the C entry point refuses (sources not padded to its
    chunk) comes back as a nonzero cudaError_t, and the check raises."""
    from xrt_tpu_torch.ops import _cuda
    fn = _cuda.entry('kirchhoff_recentred', 'kirchhoff_recentred_launch',
                     tk._RECENTRED_ARGTYPES)
    D = torch.zeros((6, 4), device=cuda)
    S = torch.zeros((20, 100), device=cuda)
    out = torch.empty((10, 4), device=cuda)
    err = fn(0, D.data_ptr(), 4, S.data_ptr(), 100, tk._RecentredParams(),
             out.data_ptr(), _cuda.stream_ptr(cuda))
    with pytest.raises(RuntimeError):
        _cuda.check(err, 'kirchhoff_recentred')


# ---- B4: the histogram kernel -------------------------------------------

XLIM, YLIM = (-1.0, 1.3), (-0.5, 1.7)     # spans with inexact reciprocals


def _hist_rays(device, case, k, n=1_000_003, seed=0):
    """(x, y, W, xbins, ybins, use_shared) of one case, float32."""
    rng = np.random.RandomState(seed)
    xbins, ybins, shared = 128, 128, True
    if case == 'ragged':
        n = 12_345
    x = rng.uniform(-1.1, 1.4, n)
    y = rng.uniform(-0.6, 1.8, n)
    if case == 'global':
        xbins, ybins, shared = 1024, 1024, False
    elif case == '1d':
        ybins, y = 1, None
    elif case == 'focused':     # 95% of the rays in four bins
        sel = rng.uniform(size=n) < 0.95
        x = np.where(sel, rng.uniform(0.0, 2 * 2.3 / 128, n), x)
        y = np.where(sel, rng.uniform(0.5, 0.5 + 2 * 2.2 / 128, n), y)
    elif case == 'special':
        ex = np.linspace(*XLIM, xbins + 1)
        ey = np.linspace(*YLIM, ybins + 1)
        extra = np.array([np.nan, np.inf, -np.inf, -7.0, 9.0])
        x = np.concatenate([ex, extra, ex, np.nextafter(ex, 9), x[:1000]])
        y = np.concatenate([ey, ey[:5], extra, ey[::-1], ey * 0.999,
                            y[:1000]])[:x.size]
    W = rng.uniform(0.5, 1.5, (x.size, k))

    def F(v):
        return None if v is None else \
            torch.from_numpy(np.asarray(v, np.float32)).to(device)
    return F(x), F(y), F(W), xbins, ybins, shared


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('case', ['shared', 'global', '1d', 'focused',
                                  'special', 'ragged'])
def test_hist2d_kernel_matches_plain(cuda, case, k):
    x, y, W, xbins, ybins, shared = _hist_rays(cuda, case, k)
    ylim = None if y is None else YLIM
    th.LAUNCHES.clear()
    got = th.hist2d_kernel(x, y, W, xbins, ybins, XLIM, ylim)
    torch.cuda.synchronize()
    name = f'hist2d:k{k}:{"shared" if shared else "global"}'
    assert dict(th.LAUNCHES) == {name: 1}
    ref = th.hist2d_plain(x, y, W, xbins, ybins, XLIM, ylim,
                          sum_dtype=torch.float64)
    assert got.shape == (ybins, xbins, k) and got.dtype == torch.float32
    assert torch.equal(got != 0, ref != 0)
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert err < (1e-4 if case == 'focused' else 1e-5), err
    # the public functions take the same route on CUDA tensors
    if k == 1 and y is not None:
        h = th.hist2d(x, y, W[:, 0], xbins, ybins, XLIM, YLIM)
        assert h.shape == (ybins, xbins) and th.LAUNCHES[name] == 2


def test_hist2d_both_variants_agree_and_float64(cuda):
    x, y, W, xbins, ybins, _ = _hist_rays(cuda, 'shared', 3, n=200_001)
    a = th.hist2d_kernel(x, y, W, xbins, ybins, XLIM, YLIM, use_shared=True)
    b = th.hist2d_kernel(x, y, W, xbins, ybins, XLIM, YLIM,
                         use_shared=False)
    assert float((a - b).abs().max() / a.abs().max()) < 1e-5
    d = th.hist2d_kernel(x.double(), y.double(), W.double(), xbins, ybins,
                         XLIM, YLIM)
    ref = th.hist2d_plain(x.double(), y.double(), W.double(), xbins, ybins,
                          XLIM, YLIM)
    assert float((d - ref).abs().max() / ref.abs().max()) < 1e-12


def test_hist2d_refused_launch_raises(cuda):
    """A histogram too large for shared memory, forced onto the shared
    variant, is refused by the C entry point; nothing falls back."""
    x, y, W, _, _, _ = _hist_rays(cuda, 'shared', 3, n=1000)
    th.LAUNCHES.clear()
    with pytest.raises(RuntimeError):
        th.hist2d_kernel(x, y, W, 1024, 1024, XLIM, YLIM, use_shared=True)
    with pytest.raises(TypeError):
        th.hist2d_kernel(x, y, W.double(), 16, 16, XLIM, YLIM)
    assert not th.LAUNCHES
