"""Tests of the CUDA kernels, which run only on a machine with a card.

Marked ``cuda`` and skipped without a CUDA device (the kernels have no
CPU or interpret mode; their plain versions are what the CPU tests
check).  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

* each kernel (B1 mono/narrowband/poly, B2 fast/exact) against its plain
  PyTorch version on the same CUDA tensors, to max|d| / max|ref| < 2e-5
  (f32 sums of ~1e3 terms in another order), through the wrapper for every
  ``accumulate`` value with its launch counted; the edges of the forward
  skeleton's tiling (1, 2, 31, 33 and 257 destinations against 1, 255 and
  257 sources, a grid of one block), two launches with the same bits, and
  a launch from a side stream;
* the preparation kernel (``csrc/kirchhoff_prep.cu``, taken by the
  wrapper when nothing requires grad, one ``prep:<mode>`` launch a call):
  where the recentring means are exact in any order its keys are the
  plain version's bits and a call gives the plain preparation's sums;
  only gradients make a call take the plain preparation, a conjugate or
  complex128 field and a 0-dim argument launch it, what it cannot read
  raises, two calls
  and one from a side stream give the same bits, and its tickets are left
  at zero;
* the double-float device helpers bit for bit against the torch dd, and
  sincosf against sinf / cosf;
* the wrappers count their launches, and a failing launch raises;
* the histogram kernel (B4, ``hist2d_kernel``) against its plain version
  with the sums taken in float64, for k = 1 and 3: 128 x 128 (the table in
  every CTA's shared memory) and 1024 x 1024 (device memory), the 1D case,
  a focused beam, rays on edges / NaN / +-inf / outside (identical sets of
  non-empty bins), and a ray count that is no multiple of the block.  Limit
  max|h - h64| / max|h64| < 1e-5; 1e-4 for the focused beam.  Its sums are
  fixed-point integers: two launches, and both routes on one input, give
  the same bits; NaN and +-inf weights give what ``index_add_`` gives;
* a plot's eight histograms in one launch (``hist_plot_kernel``) at 128
  and 1024 bins, uniform, focused and special rays: each histogram and the
  total against ``hist_plot_plain`` with float64 sums to the same limits,
  two launches and both routes bit-identical, float64 to 1e-12;
  ``runner.histogram_plot`` on CUDA beams is one such launch;
* float32 weights over thirty decades (1e-30 to 1 of the largest), in
  bins that only faint rays fill (some only rays below 1e-20, beneath any
  fixed unit of the largest weight), for ``hist2d_kernel`` (k = 1, 3) and
  ``hist_plot`` on both routes: the non-empty bins of float64 sums, each
  bin within 1e-5 of its float64 value (the fine words at each sum's own
  scale, ``csrc/hist_ray.cuh``), and the same bits over two launches and
  a permutation of the rays;
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
  float64, and ``backward()`` through ``hist2d`` launches it;
* the SoftiMAX slice: B2 on a contact tile pair of M2 -> PG against its
  plain version (2e-5), two launches bit-identical; the undulator field in
  float32 against float64 on the same samples (amplitude 1e-3, overlap
  0.999);
* the coherence slice: the one-call hops of configuration 5 (source ->
  slit, slit -> zone plate, zone plate -> screen) keep their waves on the
  card and launch B1 once a Kirchhoff hop; ``solve_modes`` and the
  coherence functions on CUDA tensors against their float64 CPU results;
  the bending magnet's and the wiggler's shine with a CUDA generator
  (beams on the card, one ``hist_plot`` through ``histogram_plot``) and
  their float32 maps against float64 on the CPU (1e-5); the field maps of
  a source on the card against the CPU (1e-5); the zone mask in float32
  on the card against float64 away from zone edges;
* the synchrotron sources' resampling scan on the card gives the same bits
  on every run, and a seed the same rays.
"""
import torch_harness  # noqa: F401

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


FORWARD = ['mono', 'narrowband', 'poly', 'fast', 'exact']


def _launched(before):
    """The launches counted since *before* (a copy of ``tk.LAUNCHES``)."""
    return {k: v - before.get(k, 0) for k, v in tk.LAUNCHES.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize('mode', ['mono', 'narrowband', 'poly'])
def test_recentred_kernel_matches_plain(cuda, mode):
    args = _args(cuda, poly=mode != 'mono')
    kw = dict(monochromatic=mode == 'mono', narrowband=mode == 'narrowband')
    before = dict(tk.LAUNCHES)
    got = tk.kirchhoff_integral_kernel(*args, accumulate='vpu', **kw)
    torch.cuda.synchronize()
    assert _launched(before) == {f'kirchhoff_recentred:{mode}': 1,
                                 f'prep:{mode}': 1}
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


def test_sincosf_gives_the_bits_of_sinf_and_cosf(cuda):
    """B2 'exact' takes sin and cos from one sincosf: the bits of sinf and
    cosf, which its adjoint recomputes."""
    import ctypes
    from xrt_tpu_torch.ops import _cuda
    g = torch.Generator().manual_seed(1)
    x = ((4 * torch.rand(200_000, generator=g, dtype=torch.float64) - 2) *
         np.pi).float().to(cuda)
    out = torch.empty((4, x.numel()), device=cuda)
    _cuda.launch('dd_selftest', 'sincosf_selftest_launch',
                 [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p], cuda,
                 x.data_ptr(), x.numel(), out.data_ptr())
    assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[3])


def test_float64_is_refused_by_the_kernel(cuda):
    args = _args(cuda, poly=False, Ns=300, Nd=100)
    _, v, D, S, P = tk._kernel_inputs(*args, 'mono')
    with pytest.raises(TypeError):
        _forward(D.double(), S, P, 'recentred', v)
    with pytest.raises(ValueError):
        _forward(D.cpu(), S, P, 'recentred', v)


def test_refused_launch_raises(cuda):
    """A launch the C entry point refuses (source rows not padded to its
    chunk) comes back as a nonzero cudaError_t, and the launch raises."""
    from xrt_tpu_torch.ops import _cuda
    D = torch.zeros((6, 4), device=cuda)
    rows = torch.zeros((100, 20), device=cuda)
    part = torch.empty((1, 10, 4), device=cuda)
    P = torch.zeros(10, device=cuda)
    with pytest.raises(RuntimeError, match='CUDA error'):
        _cuda.launch('kirchhoff_recentred', 'kirchhoff_recentred_launch',
                     tk._FWD_ARGTYPES, cuda, 0, D.data_ptr(), 4,
                     rows.data_ptr(), 100, P.data_ptr(), 1, part.data_ptr())


# ---- the preparation kernel (csrc/kirchhoff_prep.cu) -----------------------

def _integer_args(device, mode, Nd=1187, Ns=2313, seed=11):
    """Arguments whose hi positions are integers (mm) with every partial
    sum below 2^24: the six recentring means are then exact in any order,
    the kernel's and the plain version's alike.  Lo parts (within half an
    ulp of their hi part), fields, k and the rest as random as ever;
    slices 4 bytes past a 16-byte boundary."""
    rng = np.random.RandomState(seed)

    def off(a, dt=torch.float32):
        buf = torch.zeros(1 + a.size, dtype=dt)
        buf[1:] = torch.from_numpy(a)
        return buf.to(device)[1:]

    def D(ints):
        hi = ints.astype(np.float32)
        lo = 0.5 * np.spacing(hi) * rng.uniform(-1, 1, hi.size)
        return off(hi), off(np.where(hi == 0, 0, lo).astype(np.float32))
    k = np.full(Ns, 280.0 / 1973.269788 * 1e7)
    if mode != 'mono':
        k = k * (1 + rng.uniform(-1e-4, 1e-4, Ns))
    kh, kl = (off(a) for a in dd.from_f64(k))
    Es = (rng.normal(size=Ns) + 1j * rng.normal(size=Ns)).astype(np.complex64)
    return (D(rng.randint(-3, 4, Nd)), D(10000 + rng.randint(-100, 101, Nd)),
            D(5 + rng.randint(-1, 2, Nd)), D(rng.randint(-5, 6, Ns)),
            D(rng.randint(-200, 201, Ns)), D(rng.randint(-1, 2, Ns)),
            off(Es, torch.complex64), off(0.1 * Es, torch.complex64),
            (kh, kl), [off(rng.uniform(-0.05, 0.05, Ns).astype(np.float32)),
                       off(rng.uniform(0.99, 1, Ns).astype(np.float32)),
                       torch.tensor(0.02, device=device)],
            off(rng.uniform(0.01, 0.05, Ns).astype(np.float32)),
            off((rng.uniform(size=Ns) > 0.1).astype(np.float32)))


PHASE = {'mono': ('recentred', dict(monochromatic=True)),
         'narrowband': ('recentred', dict(narrowband=True)),
         'poly': ('recentred', dict(narrowband=False)),
         'fast': ('fast', {}), 'exact': ('exact', {})}


@pytest.mark.parametrize('mode', FORWARD)
def test_prep_kernel_gives_the_plain_keys_where_the_means_are_exact(cuda,
                                                                    mode):
    """With the same six means (here exact in any order) the kernel's D,
    source rows and P are the plain version's bits on the card, and a call
    through it gives the sums of a call through the plain preparation
    (weights requiring grad), bit for bit."""
    args = _integer_args(cuda, mode)
    ns = args[3][0].shape[0]
    args_n = (*args[:9], tk._broadcast_n(args[9], ns, args[3][0]),
              *args[10:])
    assert tk._takes_prep_kernel(args_n)
    got = tk._prep_kernel(mode, tk._flat_args(*args_n))
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    rows = tk.forward_sources(tk._pad_sources(S))
    assert got[:2] == (scheme, v)
    assert torch.equal(got[2], D) and torch.equal(got[3], rows)
    assert (got[4] is None and P is None) or torch.equal(got[4], P)
    pm, kw = PHASE[mode]
    out = tk.kirchhoff_integral_kernel(*args, phase_mode=pm,
                                       accumulate='vpu', **kw)
    grad_args = (*args[:-1], args[-1].clone().requires_grad_(True))
    before = dict(tk.LAUNCHES)
    ref = tk.kirchhoff_integral_kernel(*grad_args, phase_mode=pm,
                                       accumulate='vpu', **kw)
    assert not any(k.startswith('prep:') for k in _launched(before))
    assert all(torch.equal(a, b.detach()) for a, b in zip(out, ref))


def test_prep_kernel_is_taken_only_without_gradients(cuda):
    """On the card only an argument that requires grad makes a call take
    the plain preparation.  A conjugate field, a complex128 field and a
    0-dim n . direction launch the kernel and give the bits of their
    resolved, rounded, full-length copies; what the kernel cannot read
    raises.  Two calls give the same
    bits (the means in a fixed order), also from a side stream, which gets
    a centre scratch of its own; every ticket is left at zero."""
    args = _args(cuda, poly=False)
    kw = dict(monochromatic=True)

    def call(**swap):
        a = list(args)
        for i, t in swap.items():
            a[int(i[1:])] = t
        before = dict(tk.LAUNCHES)
        out = tk.kirchhoff_integral_kernel(*a, **kw)
        return [o.detach() for o in out], _launched(before)
    ref, launched = call()
    assert launched == {'prep:mono': 1, 'kirchhoff_recentred:mono': 1}
    _, launched = call(a11=args[11].clone().requires_grad_(True))
    assert launched == {'kirchhoff_recentred:mono': 1}
    got, launched = call(a6=args[6].conj().resolve_conj().conj(),
                         a7=args[7].to(torch.complex128),
                         a10=torch.tensor(0.9, device=cuda))
    assert launched == {'prep:mono': 1, 'kirchhoff_recentred:mono': 1}
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    for swap, error in ((dict(a11=args[11].double()), TypeError),
                        (dict(a6=args[6].real.contiguous()), TypeError),
                        (dict(a10=args[10][:-1]), ValueError)):
        with pytest.raises(error):
            call(**swap)
    again, _ = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other, _ = call()
    side.synchronize()
    assert all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(ref, again, other))
    mine = [t for (dev, _), t in tk._PREP_SCRATCH.items()
            if dev == ref[0].device]
    assert len(mine) >= 2 and all(float(t[-1]) == 0.0 for t in mine)


# ---- B1, B2: the forward skeleton -----------------------------------------

ACCUMULATE = ['vpu', 'mxu', 'mxu2', 'mxu-fast', 'mxu32']


def _forward(D, S, P, scheme, v):
    return tk._launch_rows(scheme, v, *tk._forward_inputs(D, S, P),
                           S.shape[1])


@pytest.mark.parametrize('acc', ACCUMULATE)
@pytest.mark.parametrize('mode', ['mono', 'narrowband', 'poly'])
def test_every_accumulate_value_launches_the_kernel(cuda, mode, acc):
    args = _args(cuda, poly=mode != 'mono')
    kw = dict(monochromatic=mode == 'mono', narrowband=mode == 'narrowband')
    before = dict(tk.LAUNCHES)
    got = tk.kirchhoff_integral_kernel(*args, accumulate=acc, **kw)
    torch.cuda.synchronize()
    assert _launched(before) == {f'kirchhoff_recentred:{mode}': 1,
                                 f'prep:{mode}': 1}
    assert _rel(got, tk.kirchhoff_integral_recentred(*args, **kw)) < 2e-5


@pytest.mark.parametrize('Ns', [1, 255, 257])
@pytest.mark.parametrize('Nd', [1, 2, 31, 33, 257])
@pytest.mark.parametrize('mode', FORWARD)
def test_forward_tiling_edges(cuda, mode, Nd, Ns):
    """The first Nd of 300 destinations (one thread's two, a warp's edges,
    a tile and one more) against Ns sources (one, and either side of two
    128-source chunks).  A sum over one destination can cancel, so each
    output is held to 2e-5 of its largest magnitude over all 300."""
    args = _args(cuda, poly=mode != 'mono', Ns=Ns, Nd=300)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    ref = tk._plain_rows(scheme, v, D, S, P)
    scale = ref.abs().amax(dim=1, keepdim=True)
    got = _forward(D[:, :Nd].contiguous(), S, P, scheme, v)
    assert torch.isfinite(got).all()
    assert float(((got - ref[:, :Nd]).abs() / scale).max()) < 2e-5


@pytest.mark.parametrize('mode', FORWARD)
def test_forward_on_a_grid_of_one_block(cuda, mode):
    """33 destinations and 60 sources: one tile, one chunk, one group."""
    args = _args(cuda, poly=mode != 'mono', Ns=60, Nd=33)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    assert tk.forward_grid(33, tk.forward_sources(S).shape[0]) == (1, 1)
    got = _forward(D, S, P, scheme, v)
    assert _rel(got, tk._plain_rows(scheme, v, D, S, P)) < 2e-5


@pytest.mark.parametrize('mode', FORWARD)
def test_forward_gives_the_same_bits_twice(cuda, mode):
    """8192 x 16384: 64 source groups, whose partials a second kernel adds
    in a fixed order."""
    args = _args(cuda, poly=mode != 'mono', Ns=16384, Nd=8192)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    assert tk.forward_grid(8192, tk.forward_sources(S).shape[0])[1] > 1
    a = _forward(D, S, P, scheme, v)
    b = _forward(D, S, P, scheme, v)
    assert torch.equal(a, b)
    assert _rel(a, tk._plain_rows(scheme, v, D, S, P)) < 2e-5


@pytest.mark.parametrize('mode', ['mono', 'fast'])
def test_forward_from_a_side_stream(cuda, mode):
    args = _args(cuda, poly=mode != 'mono', Ns=3000, Nd=1000)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    ref = _forward(D, S, P, scheme, v)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = _forward(D, S, P, scheme, v)
    side.synchronize()
    assert torch.equal(ref, got)


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
    """(x, y, W, xbins, ybins, route) of one case, float32: the route the
    kernel takes for its table."""
    rng = np.random.RandomState(seed)
    xbins, ybins = 128, 128
    if case == 'ragged':
        n = 12_345
    x = rng.uniform(-1.1, 1.4, n)
    y = rng.uniform(-0.6, 1.8, n)
    if case == 'global':
        xbins, ybins = 1024, 1024
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
    return F(x), F(y), F(W), xbins, ybins, th.hist_route(xbins, ybins, k)


HIST_CASES = ['shared', 'global', '1d', 'focused', 'special', 'ragged']


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('case', HIST_CASES)
def test_hist2d_kernel_matches_plain(cuda, case, k):
    x, y, W, xbins, ybins, route = _hist_rays(cuda, case, k)
    ylim = None if y is None else YLIM
    th.LAUNCHES.clear()
    got = th.hist2d_kernel(x, y, W, xbins, ybins, XLIM, ylim)
    torch.cuda.synchronize()
    name = f'hist2d:k{k}:{route}'
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


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('case', HIST_CASES)
def test_hist2d_kernel_gives_the_same_bits_twice(cuda, case, k):
    """Fixed-point sums: no order of the adds shows in the result."""
    x, y, W, xbins, ybins, _ = _hist_rays(cuda, case, k)
    ylim = None if y is None else YLIM
    a = th.hist2d_kernel(x, y, W, xbins, ybins, XLIM, ylim)
    b = th.hist2d_kernel(x, y, W, xbins, ybins, XLIM, ylim)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize('k', [1, 3])
def test_hist2d_both_variants_agree_and_float64(cuda, k):
    """Both routes give the same bits on a table that a CTA's shared memory
    holds (64 x 64, and 128 x 128 at k = 1), and the float64 kernel holds
    the plain version to 1e-12."""
    for bins in (64, 128):
        x, y, W, _, _, route = _hist_rays(cuda, 'focused', k, n=200_001)
        routes = th.ROUTES[th.ROUTES.index(th.hist_route(bins, bins, k)):]
        outs = [th.hist2d_kernel(x, y, W, bins, bins, XLIM, YLIM, route=r)
                for r in routes]
        assert len(outs) == 2 or (bins, k) == (128, 3)
        for o in outs[1:]:
            assert torch.equal(outs[0].view(torch.int32), o.view(torch.int32))
    x, y, W, xbins, ybins, _ = _hist_rays(cuda, 'shared', k, n=200_001)
    d = th.hist2d_kernel(x.double(), y.double(), W.double(), xbins, ybins,
                         XLIM, YLIM)
    ref = th.hist2d_plain(x.double(), y.double(), W.double(), xbins, ybins,
                          XLIM, YLIM)
    assert float((d - ref).abs().max() / ref.abs().max()) < 1e-12


def test_hist2d_nonfinite_weights_give_the_plain_values(cuda):
    """A NaN, +inf or -inf weight makes its bin what index_add_ makes it;
    the other bins keep their sums."""
    x, y, W, xbins, ybins, _ = _hist_rays(cuda, 'shared', 3, n=100_000)
    W = W.clone()
    W[:7, 0] = torch.tensor([float('nan'), float('inf'), -float('inf'),
                             float('inf'), float('inf'), -float('inf'), 1.0])
    W[3:5, 1] = float('inf')
    W[4:6, 2] = -float('inf')
    for r in th.ROUTES:
        got = th.hist2d_kernel(x, y, W, 64, 64, XLIM, YLIM, route=r)
        ref = th.hist2d_plain(x, y, W, 64, 64, XLIM, YLIM,
                              sum_dtype=torch.float64)
        fin = torch.isfinite(ref)
        assert int((~fin).sum()) > 0
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert torch.equal(got[~fin & ~torch.isnan(ref)],
                           ref[~fin & ~torch.isnan(ref)].float())
        assert float((got[fin].double() - ref[fin]).abs().max()) < \
            1e-5 * float(ref[fin].abs().max())


def test_hist2d_refused_launch_raises(cuda):
    """A histogram too large for shared memory, forced onto the shared
    route, is refused by the C entry point; nothing falls back."""
    x, y, W, _, _, _ = _hist_rays(cuda, 'shared', 3, n=1000)
    th.LAUNCHES.clear()
    with pytest.raises(RuntimeError):
        th.hist2d_kernel(x, y, W, 1024, 1024, XLIM, YLIM, route='shared')
    with pytest.raises(TypeError):
        th.hist2d_kernel(x, y, W.double(), 16, 16, XLIM, YLIM)
    with pytest.raises(ValueError):
        th.hist2d_kernel(x, y, W, 16, 16, XLIM, YLIM, route='smem')
    assert not th.LAUNCHES


# ---- B4 on the trace's main path: a plot's eight histograms in one launch

CLIM = (8890.0, 9110.0)


def _plot_rays(device, case, bins, n=1_000_003, seed=1):
    """(x, y, cData, flux, w2d, mask) of one case, float32."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.1, 1.4, n)
    y = rng.uniform(-0.6, 1.8, n)
    c = rng.uniform(8870, 9130, n)
    f = rng.uniform(0.0, 2.0, n)
    w = f * rng.uniform(0.5, 1.0, n)
    m = rng.uniform(size=n) < 0.9
    if case == 'focused':       # 95% of the rays in four bins of each axis
        sel = rng.uniform(size=n) < 0.95
        x = np.where(sel, rng.uniform(0.0, 2 * 2.3 / bins, n), x)
        y = np.where(sel, rng.uniform(0.5, 0.5 + 2 * 2.2 / bins, n), y)
        c = np.where(sel, rng.uniform(9000.0, 9000.0 + 440.0 / bins, n), c)
    elif case == 'special':     # edges, hi, NaN and +-inf in every input
        for v, (lo, hi) in ((x, XLIM), (y, YLIM), (c, CLIM)):
            v[:bins + 1] = np.linspace(lo, hi, bins + 1)
        for j, v in enumerate((x, y, c, f, w)):
            v[2000 + 10 * j:2005 + 10 * j] = [np.nan, np.inf, -np.inf, 0, 7]

    def F(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(device)
    return F(x), F(y), F(c), F(f), F(w), torch.from_numpy(m).to(device)


def _plot(rays, bins, sat=1.0):
    return (*rays, (bins, bins, bins), (XLIM, YLIM, CLIM), 0.85, sat)


@pytest.mark.parametrize('bins', [128, 1024])
@pytest.mark.parametrize('case', ['uniform', 'focused', 'special'])
def test_hist_plot_matches_plain_float64_sums(cuda, case, bins):
    """Each of the eight histograms within 1e-5 of its largest bin (1e-4
    focused) of the plain version with float64 sums, with the same
    non-empty bins and the same non-finite ones; one launch."""
    args = _plot(_plot_rays(cuda, case, bins), bins)
    th.LAUNCHES.clear()
    got = th.hist_plot_kernel(*args)
    torch.cuda.synchronize()
    route = th.plot_route((bins,) * 3)
    assert dict(th.LAUNCHES) == {f'hist_plot:{route}': 1}
    ref = th.hist_plot_plain(*args, sum_dtype=torch.float64)
    lim = 1e-4 if case == 'focused' else 1e-5
    for k in th.PLOT_HISTS + ('intensity',):
        g, r = got[k], ref[k]
        assert g.dtype == torch.float32 and g.shape == r.shape, k
        fin = torch.isfinite(r)
        assert torch.equal(torch.isnan(g), torch.isnan(r)), k
        assert torch.equal(g[~fin & ~torch.isnan(r)],
                           r[~fin & ~torch.isnan(r)].float()), k
        assert torch.equal(g[fin] != 0, r[fin] != 0), k
        if fin.any():
            scale = float(r[fin].abs().max())
            assert float((g[fin].double() - r[fin]).abs().max()) <= \
                lim * scale, k


@pytest.mark.parametrize('sat', [1.0, 0.7, 1.6])
@pytest.mark.parametrize('bins', [32, 64, 128, 1024])
def test_hist_plot_same_bits_twice_and_on_every_route(cuda, bins, sat):
    """Two launches, and both routes where a CTA's shared memory takes the
    2D table (32 and 64 bins), give the same bits; float64 holds its plain
    version to 1e-12."""
    args = _plot(_plot_rays(cuda, 'focused', bins, n=300_001), bins, sat)
    first = th.plot_route((bins,) * 3)
    outs = [th.hist_plot_kernel(*args, route=r)
            for r in th.ROUTES[th.ROUTES.index(first):]]
    outs.append(th.hist_plot_kernel(*args))
    for o in outs[1:]:
        for k in th.PLOT_HISTS + ('intensity',):
            assert torch.equal(outs[0][k].view(torch.int32),
                               o[k].view(torch.int32)), k
    d64 = [v.double() if v.dtype == torch.float32 else v for v in args[:6]]
    got = th.hist_plot_kernel(*d64, *args[6:])
    ref = th.hist_plot_plain(*d64, *args[6:])
    for k in th.PLOT_HISTS:
        assert float((got[k] - ref[k]).abs().max()) < \
            1e-12 * float(ref[k].abs().max()), k


def test_histogram_plot_is_one_launch_on_the_card(cuda):
    """runner.histogram_plot on CUDA beams: one hist_plot launch for the
    eight histograms, no other histogram launch, and the CPU run's values
    within float32 sums' tolerance."""
    from xrt_tpu_torch import interop, plotspec as tps, runner
    rng = np.random.RandomState(2)
    n = 50_000
    d = dict(x=rng.uniform(-1.1, 1.4, n), y=np.zeros(n),
             z=rng.uniform(-0.6, 1.8, n), a=np.zeros(n), b=np.ones(n),
             c=np.zeros(n), E=rng.uniform(8880, 9120, n), path=np.zeros(n),
             Jss=rng.uniform(0, 2, n), Jpp=rng.uniform(0, 0.5, n),
             Jsp=np.zeros(n, complex),
             state=rng.choice([1, 1, 1, 2, 3, -1], n).astype(np.int32))
    plot = tps.XYCPlot(
        beam='screen', xaxis=tps.XYCAxis('x', 'mm', bins=64, limits=XLIM),
        yaxis=tps.XYCAxis('z', 'mm', bins=48, limits=YLIM),
        caxis=tps.XYCAxis('energy', 'eV', bins=32, limits=CLIM))
    res = {}
    for dev in ('cpu', 'cuda'):
        beam = interop.beam_from_numpy(d, device=dev, dtype=torch.float32)
        th.LAUNCHES.clear()
        res[dev] = runner.histogram_plot(plot, {'screen': beam})
        torch.cuda.synchronize()
        if dev == 'cuda':
            assert dict(th.LAUNCHES) == {'hist_plot:shared': 1}
    for k in th.PLOT_HISTS + ('intensity',):
        g, r = res['cuda'][k].cpu(), res['cpu'][k]
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max()), k


def _faint(rng, n, bins):
    """Weights from 1e-30 to 1 of the largest; the rays of the upper half
    of the bins (by x) only below the coarse word's half unit (2e-9), those
    of the upper quarter only below 1e-20."""
    x = rng.uniform(-1.0, 1.3, n)
    w = 10.0 ** np.where(x > 0.725, rng.uniform(-30, -20, n),
                         np.where(x > 0.15, rng.uniform(-15, -9, n),
                                  rng.uniform(-30, 0, n)))
    w[0], x[0] = 1.0, -0.9
    return x, w


def _per_bin(got, ref):
    """(same non-empty bins, the largest relative error of a bin)."""
    fin = torch.isfinite(ref) & (ref != 0)
    g, r = got.double(), ref
    return (torch.equal(got != 0, ref != 0),
            float(((g[fin] - r[fin]) / r[fin]).abs().max()))


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('route', ['shared', 'global'])
def test_hist2d_faint_bins_and_permutations(cuda, route, k):
    """Weights over thirty decades, bins that only faint rays fill: the
    same non-empty bins as float64 sums, each bin within 1e-5 of its
    float64 value; two launches and a permutation of the rays give the same
    bits."""
    rng = np.random.RandomState(7)
    n = 1_000_003
    x, w = _faint(rng, n, 64)
    y = rng.uniform(-0.5, 1.7, n)
    W = np.stack([w * rng.uniform(0.5, 1.0, n) for _ in range(k)], -1)
    F = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(cuda)  # noqa
    x, y, W = F(x), F(y), F(W)
    got = th.hist2d_kernel(x, y, W, 64, 64, XLIM, YLIM, route=route)
    ref = th.hist2d_plain(x, y, W, 64, 64, XLIM, YLIM,
                          sum_dtype=torch.float64)
    same, rel = _per_bin(got, ref)
    assert same and rel < 1e-5, rel
    perm = torch.from_numpy(rng.permutation(n)).to(cuda)
    for o in (th.hist2d_kernel(x, y, W, 64, 64, XLIM, YLIM, route=route),
              th.hist2d_kernel(x[perm], y[perm], W[perm], 64, 64, XLIM,
                               YLIM, route=route)):
        assert torch.equal(got.view(torch.int32), o.view(torch.int32))


@pytest.mark.parametrize('route', ['shared', 'global'])
def test_hist_plot_faint_bins_and_permutations(cuda, route):
    """hist_plot with |flux| and w2d over thirty decades: every histogram
    has the non-empty bins of float64 sums, each bin within 1e-5 of its
    float64 value, and two launches and a permutation of the rays give the
    same bits."""
    rng = np.random.RandomState(8)
    n, bins = 1_000_003, 64
    x, f = _faint(rng, n, bins)
    y = rng.uniform(-0.5, 1.7, n)
    c = rng.uniform(8890, 9110, n)
    m = rng.uniform(size=n) < 0.9
    m[0] = True
    F = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(cuda)  # noqa
    rays = [F(x), F(y), F(c), F(f), F(f * rng.uniform(0.5, 1.0, n)),
            torch.from_numpy(m).to(cuda)]
    spec = ((bins,) * 3, (XLIM, YLIM, CLIM), 0.85, 1.0)
    got = th.hist_plot_kernel(*rays, *spec, route=route)
    ref = th.hist_plot_plain(*rays, *spec, sum_dtype=torch.float64)
    for k in th.PLOT_HISTS + ('intensity',):
        same, rel = _per_bin(got[k], ref[k])
        assert same and rel < 1e-5, (k, rel)
    perm = torch.from_numpy(rng.permutation(n)).to(cuda)
    outs = [th.hist_plot_kernel(*rays, *spec, route=route),
            th.hist_plot_kernel(*[v[perm] for v in rays], *spec,
                                route=route)]
    for o in outs:
        for k in th.PLOT_HISTS + ('intensity',):
            assert torch.equal(got[k].view(torch.int32),
                               o[k].view(torch.int32)), k


def test_hist_plot_refuses_what_the_kernel_does_not_take(cuda):
    args = _plot(_plot_rays(cuda, 'uniform', 1024, n=1000), 1024)
    th.LAUNCHES.clear()
    with pytest.raises(RuntimeError):   # 12 MB of 2D colour table in a CTA
        th.hist_plot_kernel(*args, route='shared')
    with pytest.raises(ValueError):
        th.hist_plot_kernel(*[v.cpu() for v in args[:6]], *args[6:])
    with pytest.raises(TypeError):
        th.hist_plot_kernel(args[0].double(), *args[1:])
    with pytest.raises(ValueError):     # 1D tables past shared memory
        th.hist_plot_kernel(*args[:6], (8192, 8192, 8192), *args[7:])
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
    assert dict(th.LAUNCHES) == {f'hist2d:k3:{th.hist_route(xbins, ybins, 3)}':
                                 1, 'hist2d_bwd:k3': 1}
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


def _softimax_contact_tile():
    """The first 'fast' tile pair of the SoftiMAX M2 -> PG stage at 4000
    samples per wave (tools/torch_bench_softimax.py, float32 on the card):
    its kernel arguments."""
    import os
    import sys
    from xrt_tpu_torch import waves as W
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools'))
    import torch_bench_softimax as bs
    rc = bs.build_chain(nrays=4000, n_scr=8, tiled=True,
                        dtype=torch.float32, device='cuda')
    inputs = {}
    rc(inputs=inputs)
    args = W.kirchhoff_kernel_args(inputs['pg'], rc.waves['pg'])
    for _, (pm, _), pair, _ in W.tile_pair_args(args, rc.tilemaps['pg']):
        if pm == 'fast':
            return pair
    raise AssertionError('no contact tile')


def test_b2_on_a_softimax_contact_tile(cuda):
    """B2 on contact geometry (a tile pair of M2 -> PG) against its plain
    version, to 2e-5; two launches give the same bits."""
    pair = _softimax_contact_tile()
    tk.LAUNCHES.clear()
    a = tk.kirchhoff_integral_kernel(*pair, phase_mode='fast',
                                     monochromatic=True, accumulate='vpu',
                                     check_envelope=False)
    b = tk.kirchhoff_integral_kernel(*pair, phase_mode='fast',
                                     monochromatic=True, accumulate='vpu',
                                     check_envelope=False)
    assert tk.LAUNCHES['kirchhoff_ddphase:fast'] == 2
    ref = tk.kirchhoff_integral_dd(*pair, phase_mode='fast')
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert _rel(a, ref) < 2e-5


def test_undulator_field_float32_against_float64(cuda):
    """shine_wave on the card: float32 (double-float phase) against float64
    on the same samples, the bounds of tests/test_softimax_chain.py."""
    import os
    import sys
    from xrt_tpu_torch import waves as W
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools'))
    import torch_bench_softimax as bs
    el = bs.beamline(torch.float32, 'cuda')
    w32 = W.prepare_wave_on_aperture(el['slitFE'], el['src'], 20000,
                                     dtype=torch.float32, device='cuda')
    w64 = W.prepare_wave_on_aperture(el['slitFE'], el['src'], 0,
                                     samples=(w32.x.double(),
                                              w32.z.double()),
                                     dtype=torch.float64, device='cuda')
    e32 = el['src'].shine_wave(None, w32, bs.E0).Es.cpu().numpy()
    e64 = el['src'].shine_wave(None, w64, bs.E0).Es.cpu().numpy()
    assert abs(np.abs(e32).mean() / np.abs(e64).mean() - 1) < 1e-3
    ov = abs(np.vdot(e64, e32)) / np.sqrt(np.vdot(e64, e64).real *
                                          np.vdot(e32, e32).real)
    assert ov > 0.999


def _c5(dtype, device):
    import math
    from xrt_tpu_torch.apertures import RectangularAperture
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import NormalFZP
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import Undulator
    dk = dict(dtype=dtype, device=device)
    und = Undulator.create(
        nrays=100, eE=3.0, eI=0.5, period=18.0, n=111, targetE=(9000.0, 7),
        eEpsilonX=0.263, eEpsilonZ=0.008, betaX=9.0, betaZ=2.0,
        xPrimeMax=0.02, zPrimeMax=0.02, gNodes=64, eMin=8999.0,
        eMax=9001.0, **dk)
    slit = RectangularAperture.create(center=(0, 25000.0, 0),
                                      opening=(-0.04, 0.04, -0.04, 0.04))
    fzp = NormalFZP.create(f=2000.0, E=9000.0, N=60,
                           center=(0, 27000.0, 0), pitch=math.pi / 2,
                           material=Material.create('Au', rho=19.3,
                                                    kind='FZP', **dk))
    return und, slit, fzp, Screen.create(center=(0, 29000.0, 0))


def test_one_call_hops_stay_on_the_card_and_launch_b1(cuda):
    und, slit, fzp, scr = _c5(torch.float32, 'cuda')
    hop = dict(monochromatic=True, accumulate='vpu', narrowband=False)
    tk.LAUNCHES.clear()
    a = slit.propagate_wave(None, nrays=3000, prevOE=und, fixedEnergy=9000.0,
                            generator=torch.Generator().manual_seed(1))
    assert a.Es.device.type == 'cuda' and a.Es.dtype == torch.complex64
    assert sum(tk.LAUNCHES.values()) == 0
    glo, loc = fzp.propagate_wave(a, nrays=4000,
                                  generator=torch.Generator().manual_seed(2),
                                  **hop)
    assert tk.LAUNCHES['kirchhoff_recentred:mono'] == 1
    rN = fzp.limPhysX[1]
    dim = np.linspace(-0.2 * rN, 0.2 * rN, 16)
    f = scr.expose_wave(loc, dim, dim, prevOE=fzp, **hop)
    assert tk.LAUNCHES['kirchhoff_recentred:mono'] == 2
    for t in (glo.a, loc.Es, f.Es, f.Jss):
        assert t.device.type == 'cuda'
    assert bool(torch.isfinite(f.Jss).all()) and float(f.Jss.max()) > 0


def test_modes_and_coherence_on_the_card(cuda):
    from xrt_tpu_torch import coherence as tc, modes as tmodes
    rng = np.random.default_rng(3)
    base = np.exp(1j * rng.uniform(0, 6, 500))
    fields = [(base * (1 + 0.3 * rng.normal()) + 0.2 * rng.normal(size=500),
               0.1 * rng.normal(size=500) + 0j) for _ in range(12)]

    def run(dev, dt):
        f = [(torch.as_tensor(a, dtype=dt, device=dev),
              torch.as_tensor(b, dtype=dt, device=dev)) for a, b in fields]
        return tmodes.solve_modes(f, 4)
    m32, w32, _ = run('cuda', torch.complex64)
    m64, w64, _ = run('cpu', torch.complex128)
    assert w32.device.type == 'cuda' and m32[0][0].device.type == 'cuda'
    assert bool((w32[1:] >= w32[:-1]).all())       # ascending
    np.testing.assert_allclose(w32.cpu().numpy(), w64.numpy(), atol=1e-5)
    U = torch.as_tensor(rng.normal(size=(10, 12, 9)) +
                        1j * rng.normal(size=(10, 12, 9)))
    axis = torch.linspace(-1, 1, 12, dtype=torch.float64)
    for fn in (tc.calc_degree_of_transverse_coherence_PCA,
               lambda u: tc.calc_eigen_modes_PCA(u)[0],
               lambda u: tc.calc_1D_coherent_fraction(
                   u, 'x', axis.to(u.device))[6],
               lambda u: tc.degree_of_coherence_map(
                   u.reshape(10, -1))[0]):
        got = fn(U.to('cuda', torch.complex64))
        ref = fn(U)
        assert got.device.type == 'cuda'
        np.testing.assert_allclose(got.double().cpu().numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_bending_magnet_and_wiggler_on_the_card(cuda):
    import os
    from xrt_tpu_torch import runner
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    from xrt_tpu_torch.sources import BendingMagnet, Wiggler
    gold = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'golden', 'ref_sources.npz'))
    kws = {'bm': (BendingMagnet, dict(eE=6.0, eI=0.2, B0=0.85, eMin=10000,
                                      eMax=60000, xPrimeMax=1.0,
                                      zPrimeMax=0.3)),
           'wig': (Wiggler, dict(eE=3.0, eI=0.5, K=13.0, period=150.0, n=10,
                                 eMin=1000, eMax=30000, xPrimeMax=1.0,
                                 zPrimeMax=0.3))}
    for name, (cls, kw) in kws.items():
        src = cls.create(nrays=20000, dtype=torch.float32, device='cuda',
                         **kw)
        beam = src.shine(torch.Generator('cuda').manual_seed(4))
        assert beam.x.device.type == 'cuda'
        assert bool(torch.isfinite(beam.Jss).all())
        pts = [gold[f'{name}_{k}'] for k in ('E', 'theta', 'psi')]
        got = src.build_I_map(None, *(torch.as_tensor(
            v, dtype=torch.float32, device='cuda') for v in pts))
        ref = cls.create(dtype=torch.float64, device='cpu', **kw).build_I_map(
            None, *(torch.as_tensor(v) for v in pts))
        for g, r in zip(got, ref):
            assert g.device.type == 'cuda'
            r = r.numpy()
            assert np.abs(g.cpu().numpy() - r).max() < 1e-5 * np.abs(r).max()
        plot = XYCPlot(beam='b',
                       xaxis=XYCAxis('x', 'mm', bins=64, limits=(-2, 2)),
                       yaxis=XYCAxis('z', 'mm', bins=64, limits=(-2, 2)),
                       caxis=XYCAxis('energy', 'eV', bins=64,
                                     limits=(1000, 60000)))
        th.LAUNCHES.clear()
        runner.histogram_plot(plot, {'b': beam})
        assert sum(th.LAUNCHES.values()) == 1


def test_field_maps_on_the_card(cuda):
    from xrt_tpu_torch.sources import BendingMagnet, Undulator
    und_kw = dict(eE=3.0, eI=0.5, K=1.45, period=29.0, n=40,
                  eEpsilonX=0.3, eEpsilonZ=0.01, eEspread=1e-3,
                  eMin=3000.0, eMax=3200.0, xPrimeMax=0.05e-3,
                  zPrimeMax=0.05e-3, gNodes=48)
    kw = dict(energy=np.linspace(3050.0, 3150.0, 5), theta='auto',
              psi='auto', eSpreadNSamples=6)
    for make, kwm in ((lambda **d: Undulator.create(**und_kw, **d), kw),
                      (lambda **d: BendingMagnet.create(
                          eE=3.0, eI=0.5, B0=1.7, eMin=9000.0, eMax=11000.0,
                          **d), {})):
        got = make(dtype=torch.float32, device='cuda').intensities_on_mesh(
            **kwm)
        ref = make(dtype=torch.float64, device='cpu').intensities_on_mesh(
            **kwm)
        assert np.abs(got[0] - ref[0]).max() < 1e-5 * np.abs(ref[0]).max()
    Es, _ = Undulator.create(**und_kw, dtype=torch.float32,
                             device='cuda').multi_electron_stack(
        torch.Generator('cuda').manual_seed(1), energy=[3100.0])
    assert Es.device.type == 'cuda' and bool(torch.isfinite(Es.abs()).all())


def test_zone_mask_float32_on_the_card(cuda):
    _, _, fzp, _ = _c5(torch.float32, 'cuda')
    rN = fzp.limPhysX[1]
    xy = np.random.default_rng(5).uniform(-rN, rN, (2, 100000))
    ones = torch.ones(100000, dtype=torch.int32)
    x32, y32 = (torch.as_tensor(v, dtype=torch.float32, device='cuda')
                for v in xy)
    m32 = fzp.rays_good(x32, y32, ones.cuda()).cpu().numpy()
    x64, y64 = (torch.as_tensor(v.astype(np.float32).astype(np.float64))
                for v in xy)
    m64 = fzp.rays_good(x64, y64, ones).numpy()
    n = fzp._n_of_r(torch.hypot(x64, y64)).numpy()
    far = np.abs(n - np.round(n)) > 1e-4
    np.testing.assert_array_equal(m32[far], m64[far])
    assert 0.3 < np.mean(m32 == 1) < 0.5


def test_synchrotron_resampling_is_reproducible(cuda):
    """torch's 1D cumulative sum on the card changes its last bits from run
    to run; the resampling's row scan (``synchrotron.cumsum_rows``) does
    not, so a seed gives the same rays: a 1e6-candidate scan twice
    bit-identical and within 1e-6 of a float64 scan, and an undulator's
    shine twice from one seed bit-identical."""
    from xrt_tpu_torch.sources import Undulator
    from xrt_tpu_torch.sources.synchrotron import cumsum_rows
    g = torch.Generator('cuda').manual_seed(0)
    x = torch.rand(1000003, generator=g, device='cuda') ** 8
    a, b = cumsum_rows(x), cumsum_rows(x)
    assert torch.equal(a, b)
    ref = torch.cumsum(x.double().cpu(), 0)
    assert float(((a.double().cpu() - ref).abs() / ref).max()) < 1e-6
    und = Undulator.create(nrays=200000, eE=3.0, eI=0.5, period=18.0,
                           n=111, targetE=(9000.0, 7), eEpsilonX=0.263,
                           eEpsilonZ=0.008, eMin=8960.0, eMax=9040.0,
                           xPrimeMax=0.02, zPrimeMax=0.02, gNodes=64,
                           dtype=torch.float32, device='cuda')
    b1, b2 = (und.shine(torch.Generator('cuda').manual_seed(4))
              for _ in range(2))
    for f in ('E', 'x', 'a', 'Jss'):
        assert torch.equal(getattr(b1, f), getattr(b2, f)), f
