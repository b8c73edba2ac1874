"""Tests of the CUDA kernels, which run only on a machine with a card.

Marked ``cuda`` and skipped without a CUDA device (the kernels have no
CPU or interpret mode; their plain versions are what the CPU tests
check).  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

* each kernel (B1 mono/narrowband/poly, B2 fast/exact) against its plain
  PyTorch version on the same CUDA tensors, to max|d| / max|ref| < 2e-5
  (f32 sums of ~1e3 terms in another order);
* the double-float device helpers bit for bit against the torch dd;
* the wrappers count their launches, and a failing launch raises.
"""
import numpy as np
import pytest
import torch

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
