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
  of a block's rays in one running float32 sum;
* the adjoint kernels (B3: recentred mono / narrowband / poly, per-pair
  double-float 'fast' / 'exact') against the plain blocked backward on the
  same CUDA tensors, row by row: every key row and every scalar to 1e-4
  of its largest magnitude, the limit ``chip_smoke.py`` holds them to
  (measured on an H100: 3.2e-5 at 129 x 257, 1.1e-5 at 8192 x 16384; the
  kernels differentiate the sincos polynomials as (2 pi cos, -2 pi sin),
  the plain version the polynomials themselves, 1.3e-5 per pair, which a
  short sum does not average down); ragged sizes and the edges of the
  one-pass kernel's tiling (1, 31 and 33 destinations, sources no multiple
  of the tile, a grid of one block); two launches give the same bits;
  ``backward()`` through the wrapper launches them, also from a side
  stream; the forward through the autograd function has the bits of a
  direct launch, and neither reads a scalar to the host;
* the histogram's adjoint (B4-bwd) against advanced indexing: exactly
  equal, also for 1 to 7 rays, views at a 4-byte (not 16-byte) offset and
  float64, and ``backward()`` through ``hist2d`` launches it.
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
    _, v, D, S, P = tk._kernel_inputs(*args, 'mono')
    with pytest.raises(TypeError):
        tk._launch_recentred(D.double(), tk._pad_sources(S), P, v)
    with pytest.raises(ValueError):
        tk._launch_recentred(D.cpu(), tk._pad_sources(S), P, v)


def test_refused_launch_raises(cuda):
    """A launch the C entry point refuses (sources not padded to its
    chunk) comes back as a nonzero cudaError_t, and the check raises."""
    from xrt_tpu_torch.ops import _cuda
    fn = _cuda.entry('kirchhoff_recentred', 'kirchhoff_recentred_launch',
                     tk._RECENTRED_ARGTYPES)
    D = torch.zeros((6, 4), device=cuda)
    S = torch.zeros((20, 100), device=cuda)
    out = torch.empty((10, 4), device=cuda)
    P = torch.zeros(10, device=cuda)
    err = fn(0, D.data_ptr(), 4, S.data_ptr(), 100, P.data_ptr(),
             out.data_ptr(), _cuda.stream_ptr(cuda))
    with pytest.raises(RuntimeError):
        _cuda.check(err, 'kirchhoff_recentred')


# ---- B3: the adjoint kernels ---------------------------------------------

def _row_errors(got, ref):
    return [float((got[i] - ref[i]).abs().max()) /
            max(float(ref[i].abs().max()), 1e-300)
            for i in range(ref.shape[0])]


@pytest.mark.parametrize('sizes', [(1000, 3000), (129, 257)])
@pytest.mark.parametrize('mode', ['mono', 'narrowband', 'poly', 'fast',
                                  'exact'])
def test_adjoint_kernels_match_plain_blocked_backward(cuda, mode, sizes):
    Nd, Ns = sizes
    args = _args(cuda, poly=mode != 'mono', Ns=Ns, Nd=Nd)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    G = torch.randn((10, Nd), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    name = f'kirchhoff_{scheme}_bwd:{mode}'
    before = tk.LAUNCHES[name]
    if scheme == 'recentred':
        bD, bS, bP = tk._launch_recentred_bwd(D, tk._pad_sources(S), P, G, v)
    else:
        bD, bS = tk._launch_ddphase_bwd(D, tk._pad_sources(S), G, v)
        bP = None
    torch.cuda.synchronize()
    assert tk.LAUNCHES[name] == before + 1
    rD, rS, rP = tk.kirchhoff_bwd_blocked(scheme, v, D, S, P, G,
                                          dst_block=512, src_chunk=512)
    assert torch.isfinite(bD).all() and torch.isfinite(bS).all()
    assert max(_row_errors(bD, rD)) < 1e-4
    assert max(_row_errors(bS[:, :Ns], rS)) < 1e-4
    if bP is not None:
        assert max(_row_errors(bP[:, None], rP[:, None])) < 1e-4
        assert float(bP[tk._PARAM_KEYS.index('invR0')]) == 0.0


def _adjoint(D, S, P, G, scheme, v):
    if scheme == 'recentred':
        return tk._launch_recentred_bwd(D, S, P, G, v)
    return tk._launch_ddphase_bwd(D, S, G, v) + (None,)


def _check_adjoint(scheme, v, D, S, P, G, Ns, got):
    rD, rS, rP = tk.kirchhoff_bwd_blocked(scheme, v, D, S[:, :Ns], P, G,
                                          dst_block=512, src_chunk=512)
    assert max(_row_errors(got[0], rD)) < 1e-4
    assert max(_row_errors(got[1][:, :Ns], rS)) < 1e-4
    if rP is not None:
        assert max(_row_errors(got[2][:, None], rP[:, None])) < 1e-4


@pytest.mark.parametrize('Nd', [1, 31, 33])
@pytest.mark.parametrize('mode', ['mono', 'narrowband', 'poly', 'fast',
                                  'exact'])
def test_adjoint_kernels_tiling_edges(cuda, mode, Nd):
    """The first 1, 31 or 33 of 1000 destinations (fewer than a stage, one
    more or one less than a warp) against 300 sources, no multiple of the
    128-source tile.  A destination row of so few destinations is one sum
    of f32 terms that cancel (measured: 1.1e-4 of itself for one 'fast'
    destination), so it is held, like the rows of the 1000 x 3000 case
    above, to 1e-4 of the row's largest magnitude over all 1000."""
    Ns = 300
    args = _args(cuda, poly=mode != 'mono', Ns=Ns, Nd=1000)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    G = torch.randn((10, 1000), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    scale = tk.kirchhoff_bwd_blocked(scheme, v, D, S, P, G, dst_block=512,
                                     src_chunk=512)[0].abs().amax(dim=1)
    D, G = D[:, :Nd].contiguous(), G[:, :Nd].contiguous()
    got = _adjoint(D, tk._pad_sources(S), P, G, scheme, v)
    assert all(torch.isfinite(t).all() for t in got if t is not None)
    rD, rS, rP = tk.kirchhoff_bwd_blocked(scheme, v, D, S, P, G,
                                          dst_block=512, src_chunk=512)
    assert float(((got[0] - rD).abs().amax(dim=1) / scale).max()) < 1e-4
    assert max(_row_errors(got[1][:, :Ns], rS)) < 1e-4
    if rP is not None:
        assert max(_row_errors(got[2][:, None], rP[:, None])) < 1e-4


@pytest.mark.parametrize('mode', ['mono', 'poly', 'fast'])
def test_adjoint_kernels_on_a_grid_of_one_block(cuda, mode):
    """33 destinations and 100 sources padded to one 128-source tile: one
    slab, one source group."""
    Nd, Ns = 33, 100
    args = _args(cuda, poly=mode != 'mono', Ns=Ns, Nd=Nd)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    S128 = torch.cat([S, S.new_zeros((S.shape[0], tk.ADJ_TILE - Ns))], 1)
    assert tk.adjoint_grid(Nd, tk.ADJ_TILE) == (1, tk.ADJ_CHUNK, 1)
    G = torch.randn((10, Nd), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(4))
    got = _adjoint(D, S128, P, G, scheme, v)
    _check_adjoint(scheme, v, D, S, P, G, Ns, got)


@pytest.mark.parametrize('mode', ['mono', 'narrowband', 'poly', 'fast',
                                  'exact'])
def test_adjoint_kernels_give_the_same_bits_twice(cuda, mode):
    args = _args(cuda, poly=mode != 'mono', Ns=16384, Nd=8192)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    S = tk._pad_sources(S)
    G = torch.randn((10, 8192), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(5))
    a = _adjoint(D, S, P, G, scheme, v)
    b = _adjoint(D, S, P, G, scheme, v)
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize('mode', ['mono', 'narrowband', 'poly', 'fast',
                                  'exact'])
def test_backward_through_the_wrapper_launches_the_adjoint(cuda, mode):
    """All twelve inputs get a finite gradient; the forward through the
    autograd function has the bits of the forward without one; nothing on
    the way synchronizes with the host."""
    args = list(_args(cuda, poly=mode != 'mono', Ns=700, Nd=300))
    kw = dict(phase_mode=mode) if mode in ('fast', 'exact') else dict(
        monochromatic=mode == 'mono', narrowband=mode == 'narrowband',
        accumulate='vpu')
    plain = tk.kirchhoff_integral_kernel(*args, **kw)
    flat = []

    def leaf(t):
        t = t.clone().requires_grad_(True)
        flat.append(t)
        return t
    targs = [type(a)(leaf(t) for t in a) if isinstance(a, (tuple, list))
             else leaf(a) for a in args]
    scheme = 'ddphase' if mode in ('fast', 'exact') else 'recentred'
    name = f'kirchhoff_{scheme}_bwd:{mode}'
    before = tk.LAUNCHES[name]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = tk.kirchhoff_integral_kernel(*targs, **kw)
        cts = [torch.randn_like(o) for o in out]
        loss = sum((o * c.conj()).real.sum() for o, c in zip(out, cts))
        grads = torch.autograd.grad(loss, flat)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert tk.LAUNCHES[name] == before + 1
    assert len(grads) == 21
    for g in grads:
        assert torch.isfinite(torch.view_as_real(g) if g.is_complex()
                              else g).all()
    for p, o in zip(plain, out):
        assert torch.equal(p, o.detach())


def test_backward_from_a_side_stream(cuda):
    args = list(_args(cuda, poly=False, Ns=700, Nd=300))

    def grad_Es():
        Es = args[6].clone().requires_grad_(True)
        a = list(args)
        a[6] = Es
        out = tk.kirchhoff_integral_kernel(*a, monochromatic=True)
        g, = torch.autograd.grad((out[0].abs() ** 2).sum(), [Es])
        return g
    ref = grad_Es()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = grad_Es()
    side.synchronize()
    assert torch.equal(ref, got)


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


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('case', ['shared', 'global', '1d', 'special',
                                  'ragged'])
def test_hist2d_adjoint_kernel_equals_indexing(cuda, case, k):
    x, y, W, xbins, ybins, _ = _hist_rays(cuda, case, k)
    ylim = None if y is None else YLIM
    g = torch.rand((ybins, xbins, k), device=cuda)
    th.LAUNCHES.clear()
    got = th.hist2d_bwd_kernel(x, y, g, xbins, ybins, XLIM, ylim)
    torch.cuda.synchronize()
    assert dict(th.LAUNCHES) == {f'hist2d_bwd:k{k}': 1}
    assert torch.equal(got, th.hist2d_bwd_plain(x, y, g, xbins, ybins, XLIM,
                                                ylim))


def test_backward_through_hist2d_launches_the_gather(cuda):
    x, y, W, xbins, ybins, _ = _hist_rays(cuda, 'shared', 3, n=100_003)
    W = W.requires_grad_(True)
    th.LAUNCHES.clear()
    h = th.hist2d_rgb(x, y, W, xbins, ybins, XLIM, YLIM)
    c = torch.rand_like(h)
    (h * c).sum().backward()
    torch.cuda.synchronize()
    assert dict(th.LAUNCHES) == {'hist2d:k3:shared': 1, 'hist2d_bwd:k3': 1}
    assert torch.equal(W.grad, th.hist2d_bwd_plain(x, y, c, xbins, ybins,
                                                   XLIM, YLIM))
    with pytest.raises(ValueError):
        th.hist2d_bwd_kernel(x, y, c.double(), xbins, ybins, XLIM, YLIM)


@pytest.mark.parametrize('k', [1, 3])
def test_hist2d_adjoint_kernel_edges(cuda, k):
    """1 to 7 rays (the scalar tail of the four-ray groups), views at a
    4-byte but not 16-byte offset (the scalar path), a cotangent table at
    such an offset, and float64."""
    x, y, _, xbins, ybins, _ = _hist_rays(cuda, 'special', k)
    g = torch.rand((ybins, xbins, k), device=cuda)
    cases = [(x[:m], y[:m], g) for m in range(1, 8)]
    cases += [(x[1:], y[1:], g), (x[1:-1], y[2:], g), (x[:-1], y[1:], g),
              (x.double(), y.double(), g.double()),
              (x.double()[1:], y.double()[1:], g.double())]
    for xx, yy, gg in cases:
        got = th.hist2d_bwd_kernel(xx, yy, gg, xbins, ybins, XLIM, YLIM)
        assert got.dtype == xx.dtype
        assert torch.equal(got, th.hist2d_bwd_plain(xx, yy, gg, xbins, ybins,
                                                    XLIM, YLIM))
    got = th.hist2d_bwd_kernel(x[3:], None, g[:1], xbins, 1, XLIM)
    assert torch.equal(got, th.hist2d_bwd_plain(x[3:], None, g[:1], xbins, 1,
                                                XLIM))
    # a cotangent table at a 4-byte offset
    g1 = torch.rand(g.numel() + 1, device=cuda)[1:].view(g.shape)
    assert torch.equal(th.hist2d_bwd_kernel(x, y, g1, xbins, ybins, XLIM,
                                            YLIM),
                       th.hist2d_bwd_plain(x, y, g1, xbins, ybins, XLIM,
                                           YLIM))
