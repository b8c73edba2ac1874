"""The Kirchhoff stages' per-point preparation kernel
(``csrc/kirchhoff_prep.cuh``, launched by ``csrc/kirchhoff_prep.cu``) on
the CPU.

The header's centre and per-point functions are compiled for the host with
``g++ -ffp-contract=off`` against a stub of the CUDA runtime, behind the C
entry point of ``csrc/kirchhoff_prep.cu`` (loops over the blocks and
threads in place of the two launches), and put in place of the launch
(``ops.kirchhoff._prep_launch``): ``ops.kirchhoff._prep_kernel`` then runs
on CPU tensors as it runs on a card, from the twelve arguments to B1's and
B2's inputs.

* Given the six recentring means of the plain version, the kernel's D, its
  zero-padded source rows and P equal the plain ``_kernel_inputs`` with
  ``forward_sources`` bit for bit, for mono, narrowband, poly, 'fast' and
  'exact', on sizes that are no multiple of 128, slices that start 4 bytes
  past a 16-byte boundary, a field with a stride of 3 and a normal member
  broadcast from one value.
* Its own means, sums in double in the centre launch's fixed order, are
  the float64 means rounded (1.5 ulp), the plain version's (a double sum
  in torch's order) bit for bit, and within one ulp of the coordinates of
  the reference package's float32 sums; the scalars P from them are
  within a few ulp of the plain ones (relative to the size of the vector
  each belongs to).  For the recentred variants the ten sums of the pairs
  from its keys are within 1.5 times the distance from the float64 sums
  of those about the reference's centre: the recentring rounds its
  float32 offsets differently about another centre, by the scheme's own
  error (~1e-4 of the peak here).  'fast' and 'exact' have no centre:
  their keys are the plain bits whatever the means.
* A conjugate field, a complex128 field, one number for n . direction
  and weights of one element are taken (resolved, rounded, broadcast with
  a stride of 0) and give the plain keys; a real field, or another
  argument of another dtype, length or device, raises.
* It counts one launch under ``prep:<mode>``, a name that the benchmark's
  readers of the forward kernels (``kirchhoff_*``) do not match.
"""
import torch_harness

import ctypes

import numpy as np
import pytest
import torch

from xrt_tpu_torch import waves as W
from xrt_tpu_torch.ops import dd, kirchhoff as tk


MODES = ['mono', 'narrowband', 'poly', 'fast', 'exact']

# the C entry point of csrc/kirchhoff_prep.cu for the host: the centre
# launch's blocks and threads in loops, in its order, and the points one by
# one; prep_given_means makes it take six given means instead
HARNESS = r"""
#include <vector>
#include <cuda_runtime.h>
#include "kirchhoff_prep.cuh"
using namespace xkp;

static const float* given = nullptr;
extern "C" void prep_given_means(const float* mean) { given = mean; }

static void means(const Inputs& in, long long nd, long long ns,
                  float* mean) {
  const long long G = centre_blocks(nd, ns);
  std::vector<double> part(G * 6), sh(BLOCK * 6);
  for (long long b = 0; b < G; ++b) {
    for (int t = 0; t < BLOCK; ++t)
      centre_sums(in, nd, ns, b * BLOCK + t, G * BLOCK, &sh[t * 6]);
    for (int s = BLOCK / 2; s > 0; s >>= 1)
      for (int t = 0; t < s; ++t)
        for (int q = 0; q < 6; ++q) sh[t * 6 + q] += sh[(t + s) * 6 + q];
    for (int q = 0; q < 6; ++q) part[b * 6 + q] = sh[q];
  }
  for (int q = 0; q < 6; ++q) {
    double sum = 0.0;
    for (long long b = 0; b < G; ++b) sum += part[b * 6 + q];
    mean[q] = mean_of(sum, q < 3 ? nd : ns);
  }
}

template <int V>
static void points(const Inputs& in, long long nd, long long ns,
                   long long ns_pad, const float* cen, float* D,
                   float* rows) {
  for (long long i = 0; i < nd; ++i) {
    float d[8];
    dst_keys<V>(in, cen, i, d);
    for (int q = 0; q < ndk(V); ++q) D[q * nd + i] = d[q];
  }
  for (long long j = 0; j < ns_pad; ++j) {
    float s[24] = {0};
    if (j < ns) src_keys<V>(in, cen, j, s);
    for (int q = 0; q < width(V); ++q) rows[j * width(V) + q] = s[q];
  }
}

extern "C" int kirchhoff_prep_launch(int variant, const void* const* ptrs,
                                     const long long* strides, long long nd,
                                     long long ns, long long ns_pad, void* D,
                                     void* rows, void* cen, void*, void*,
                                     void*) {
  Inputs in;
  for (int k = 0; k < NIN; ++k) {
    in.p[k] = static_cast<const float*>(ptrs[k]);
    in.s[k] = strides[k];
  }
  float* c = static_cast<float*>(cen);
  if (variant <= POLY) {
    float mean[6];
    if (given != nullptr)
      for (int q = 0; q < 6; ++q) mean[q] = given[q];
    else
      means(in, nd, ns, mean);
    centre(mean, at(in, KH, 0), at(in, KL, 0), variant, c);
  }
  float* d = static_cast<float*>(D);
  float* r = static_cast<float*>(rows);
  switch (variant) {
    case MONO: points<MONO>(in, nd, ns, ns_pad, c, d, r); break;
    case NARROWBAND: points<NARROWBAND>(in, nd, ns, ns_pad, c, d, r); break;
    case POLY: points<POLY>(in, nd, ns, ns_pad, c, d, r); break;
    case FAST: points<FAST>(in, nd, ns, ns_pad, c, d, r); break;
    default: points<EXACT>(in, nd, ns, ns_pad, c, d, r);
  }
  return 0;
}
"""


@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    """csrc/kirchhoff_prep.cuh behind the kernel's C entry point, built for
    the host."""
    lib = torch_harness.host_build(tmp_path_factory, 'kirchhoff_prep',
                                   {'harness.cpp': HARNESS},
                                   headers=('kirchhoff_prep.cuh', 'dd.cuh'))
    lib.kirchhoff_prep_launch.argtypes = tk._PREP_ARGTYPES
    lib.kirchhoff_prep_launch.restype = ctypes.c_int
    lib.prep_given_means.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture
def host_prep(host_lib, monkeypatch):
    """The host build in place of the kernel's launch."""
    def launch(dev, *args):
        assert dev.type == 'cpu'
        assert host_lib.kirchhoff_prep_launch(*args, None) == 0
    monkeypatch.setattr(tk, '_prep_launch', launch)
    yield host_lib
    host_lib.prep_given_means(None)


def _off(a, dt=torch.float32, step=1):
    """*a* as a CPU tensor that starts 4 bytes past its storage's
    (16-byte aligned) start, every *step*-th element."""
    a = np.asarray(a)
    buf = torch.zeros(1 + step * a.size, dtype=dt)
    view = buf[1::step]
    view.copy_(torch.from_numpy(a))
    return view


def _inputs(mode, Nd=1187, Ns=2313, seed=5):
    """The twelve arguments of a SoftiMAX-like step on the CPU: a mirror's
    source cloud ~10 m from the source, a receiving cloud 16 m beyond it
    and off its axis (every component of L counts), 280 eV (a 1e-4 spread
    in k but for mono), lo parts on every position, a tenth of the weights
    zero, a field with a stride of 3 and the normal's last member one value
    for every source."""
    rng = np.random.RandomState(seed)
    xs = rng.uniform(-5, 5, Ns)
    ys = 1e4 + rng.uniform(-200, 200, Ns)
    zs = rng.uniform(-0.5, 0.5, Ns) + 1e-3 * xs ** 2
    xd = 40.0 + rng.uniform(-3, 3, Nd)
    yd = 2.6e4 + rng.uniform(-300, 300, Nd)
    zd = 25.0 + rng.uniform(-1, 1, Nd)
    k = np.full(Ns, 280.0 / 1973.269788 * 1e7)
    if mode != 'mono':
        k = k * (1 + rng.uniform(-1e-4, 1e-4, Ns))
    Es = rng.normal(size=Ns) + 1j * rng.normal(size=Ns)
    Ep = 0.1 * (rng.normal(size=Ns) + 1j * rng.normal(size=Ns))
    n0 = rng.uniform(-0.3, 0.3, Ns)
    n1 = rng.uniform(0.9, 1.0, Ns)
    w = (rng.uniform(size=Ns) > 0.1).astype(np.float32)

    def D(v):
        return tuple(_off(a) for a in dd.from_f64(v))
    return (D(xd), D(yd), D(zd), D(xs), D(ys), D(zs),
            _off(Es.astype(np.complex64), torch.complex64, step=3),
            _off(Ep.astype(np.complex64), torch.complex64), D(k),
            [_off(n0), _off(n1), torch.tensor(0.2, dtype=torch.float32)],
            _off(rng.uniform(0.01, 0.05, Ns)), _off(w))


def _flat(args):
    ns = args[3][0].shape[0]
    return tk._flat_args(*args[:9], tk._broadcast_n(args[9], ns, args[3][0]),
                         *args[10:])


def _plain_means(args, dtype=torch.float64):
    """The plain version's six means (``recentre_kirchhoff_inputs``'
    mean_h) of the hi parts; with *dtype* float32, the reference package's
    float32 sums."""
    return np.array([float(torch.sum(t[0], dtype=dtype).float() *
                           (1.0 / t[0].shape[0])) for t in args[:6]],
                    np.float32)


def _bits(t):
    return t.contiguous().numpy().view(np.int32)


def test_inputs_start_off_a_16_byte_boundary():
    args = _inputs('mono')
    flat = _flat(args)
    assert all(t.data_ptr() % 16 for t in flat if t.stride(0))
    assert flat[12].stride(0) == 6 and flat[20].stride(0) == 0
    assert tk._takes_prep_kernel(args) is False     # CPU tensors


@pytest.mark.parametrize('mode', MODES)
def test_keys_equal_the_plain_version_given_its_means(host_prep, mode):
    args = _inputs(mode)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    rows = tk.forward_sources(tk._pad_sources(S))
    means = _plain_means(args)
    host_prep.prep_given_means(means.ctypes.data_as(ctypes.c_void_p))
    got = tk._prep_kernel(mode, _flat(args))
    assert got[:2] == (scheme, v)
    assert got[2].shape == D.shape and got[3].shape == rows.shape
    assert rows.shape[0] % tk.KERNEL_SRC_CHUNK == 0
    assert np.array_equal(_bits(got[2]), _bits(D))
    assert np.array_equal(_bits(got[3]), _bits(rows))
    if scheme == 'recentred':
        assert np.array_equal(_bits(got[4]), _bits(P))
    else:
        assert got[4] is None and P is None


@pytest.mark.parametrize('mode', ['mono', 'narrowband', 'poly'])
def test_fixed_order_means_and_scalars(host_prep, mode):
    args = _inputs(mode)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    got = tk._prep_kernel(mode, _flat(args))
    # the means, as the centre put them beside P
    cen = got[4]._base if got[4]._base is not None else got[4]
    mine = cen[10:16].numpy().astype(np.float64)
    plain = _plain_means(args)
    exact = np.array([float(t[0].double().mean()) for t in args[:6]])
    # its means are the float64 ones rounded (1.5 ulp: the sum, 1/n and
    # their product each round once), the plain version's (a double sum in
    # torch's order) bit for bit; the reference's float32 sums lose more
    # where the coordinates cancel, but within an ulp of the coordinates
    assert np.all(np.abs(mine - exact) <= 1.5 * np.spacing(
        np.abs(exact).astype(np.float32)))
    assert np.array_equal(mine.astype(np.float32), plain)
    scale = np.array([float(t[0].abs().max()) for t in args[:6]],
                     np.float32)
    assert np.all(np.abs(mine - _plain_means(args, torch.float32)) <=
                  np.spacing(scale))
    # P: C and L as vectors, rho against R0^2 (it is what R0 leaves of |C|^2)
    Pg, Pp = got[4].double().numpy(), P.double().numpy()
    R0 = np.linalg.norm(Pp[0:3])
    eps = np.finfo(np.float32).eps
    assert np.linalg.norm(Pg[0:3] - Pp[0:3]) <= 4 * eps * R0
    assert np.linalg.norm(Pg[3:6] - Pp[3:6]) <= 4 * eps
    assert abs(Pg[6] - Pp[6]) <= 4 * eps * R0 ** 2
    assert abs(Pg[7] / Pp[7] - 1) <= 4 * eps
    assert np.array_equal(Pg[8:], Pp[8:])     # kappa_0: the first source's


def _sums_f64(args):
    """The five sums of *args* by the port's float64 path on hi + lo."""
    def f(p):
        return p[0].double() + p[1].double()
    ns = args[3][0].shape[0]
    n = [t.double() for t in tk._broadcast_n(args[9], ns, args[3][0])]
    return W.kirchhoff_integral_xla(
        *(f(a) for a in args[:6]), args[6].to(torch.complex128),
        args[7].to(torch.complex128), f(args[8]), n, args[10].double(),
        args[11].double())


def _err(rows, ref):
    """The largest |rows' sum - ref| over each output's peak, of the five
    outputs."""
    rows = rows.double()
    return max(float((torch.complex(rows[2 * i], rows[2 * i + 1]) -
                      ref[i]).abs().max() / ref[i].abs().max())
               for i in range(5))


@pytest.mark.parametrize('mode', ['mono', 'narrowband', 'poly'])
def test_pair_sums_from_the_kernels_keys(host_prep, mode):
    """The ten sums of every pair from the kernel's keys, about its own
    centre, are as close to the float64 sums as those about the reference
    package's centre (its float32 sums): the recentring's float32
    rounding, ~1e-4 of the peak here at 280 eV, falls otherwise about
    another centre, and the two differ by as much.  The plain keys, about
    the plain version's centre, give the same sums."""
    args = _inputs(mode, Nd=307, Ns=611)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)

    def sums(got):
        nsk = S.shape[0]
        assert not got[3][S.shape[1]:].any() and not got[3][:, nsk:].any()
        return tk._plain_rows(scheme, v, got[2],
                              got[3][:S.shape[1], :nsk].t(), got[4])
    have = sums(tk._prep_kernel(mode, _flat(args)))
    means32 = _plain_means(args, torch.float32)
    host_prep.prep_given_means(means32.ctypes.data_as(ctypes.c_void_p))
    want = sums(tk._prep_kernel(mode, _flat(args)))
    ref = _sums_f64(args)
    assert _err(have, ref) <= 1.5 * _err(want, ref), \
        (_err(have, ref), _err(want, ref))
    assert torch.equal(have, tk._plain_rows(scheme, v, D, S, P))


def test_one_launch_counted_outside_the_forward_kernels_names(host_prep):
    before = dict(tk.LAUNCHES)
    for mode in MODES:
        tk._prep_kernel(mode, _flat(_inputs(mode, Nd=40, Ns=70)))
    after = dict(tk.LAUNCHES)
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {f'prep:{m}': 1
                                                  for m in MODES}
    assert not any(k.startswith('kirchhoff_') for k in after
                   if after[k] != before.get(k, 0))


def _with(args, **kw):
    """*args* with the arguments named in *kw* replaced."""
    names = ('xd', 'yd', 'zd', 'xs', 'ys', 'zs', 'Es', 'Ep', 'k', 'n', 'nl',
             'weights')
    return tuple(kw.get(name, a) for name, a in zip(names, args))


@pytest.mark.parametrize('mode', MODES)
def test_conjugate_field_and_single_values(host_prep, mode):
    """A field that is a conjugate view, a complex128 field, n . direction
    given as one number and weights as a tensor of one element: the kernel
    takes them (the view resolved, the field rounded, the values broadcast
    with a stride of 0) and gives the plain version's keys given its
    means."""
    base = _inputs(mode, Nd=301, Ns=509)
    args = _with(base, Es=base[6].conj(), Ep=base[7].to(torch.complex128),
                 nl=0.03, weights=torch.tensor([0.75]))
    assert args[6].is_conj()
    flat = _flat(args)
    assert flat[21].stride(0) == 0 and flat[22].stride(0) == 0
    assert torch.equal(flat[13], -base[6].imag)
    scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
    host_prep.prep_given_means(_plain_means(args).ctypes.data_as(
        ctypes.c_void_p))
    got = tk._prep_kernel(mode, flat)
    assert np.array_equal(_bits(got[2]), _bits(D))
    assert np.array_equal(_bits(got[3]),
                          _bits(tk.forward_sources(tk._pad_sources(S))))


@pytest.mark.parametrize('name,value,error', [
    ('weights', lambda w: w.double(), TypeError),
    ('Ep', lambda e: e.real.contiguous(), TypeError),
    ('nl', lambda t: t[:-1], ValueError),
    ('weights', lambda w: w.reshape(-1, 1), ValueError),
    ('nl', lambda t: t.to('meta'), ValueError),
])
def test_what_the_kernel_cannot_take_raises(name, value, error):
    """On a card the kernel prepares every call without gradients, so an
    argument it cannot read raises (as the forward kernels raise on it),
    and nothing falls back to the plain preparation."""
    args = _inputs('mono', Nd=40, Ns=70)
    i = ('Es', 'Ep', 'k', 'n', 'nl', 'weights').index(name) + 6
    with pytest.raises(error):
        _flat(_with(args, **{name: value(args[i])}))


def _reader(monkeypatch, counters):
    """The benchmark's reader ``chain.prep_fused`` over a program whose
    profiler holds *counters* (None: a profiler with no records)."""
    import os
    import sys
    import types
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'beambench'))
    import harness
    fake = types.ModuleType('xrt_tpu_torch.profiler')
    if counters is not None:
        fake.spans = lambda: []
        fake.counters = lambda: counters
    monkeypatch.setitem(sys.modules, 'xrt_tpu_torch.profiler', fake)
    return harness.load_module('metrics', 'chain.prep_fused').read(
        dict(units=[dict(t0=0.0, t1=1.0)]))


@pytest.mark.parametrize('counters,share', [
    (None, None),                                   # no records
    ({1: {'kirchhoff.launches': 108}}, None),       # no such counter
    ({1: {'kirchhoff.prep_fused': 108, 'kirchhoff.launches': 108},
      2: {'kirchhoff.prep_fused': 108, 'kirchhoff.launches': 108}}, 100.0),
    ({1: {'kirchhoff.prep_fused': 1, 'kirchhoff.launches': 3}},
     100.0 / 3),
])
def test_prep_fused_reader(monkeypatch, counters, share):
    got = _reader(monkeypatch, counters)
    assert got == (None if share is None else pytest.approx(share))
