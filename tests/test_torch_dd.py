"""The port's double-float library against the JAX package's, bit for bit.

Both run op by op in float32 on the CPU (JAX eagerly: every primitive is
its own computation, so nothing is contracted into an FMA), on the same
numpy inputs.  Tolerance: none — every output must be bit-identical, since
the CUDA helpers (csrc/dd.cuh) are held to the torch versions bit for bit
on the card.
"""
import torch_harness  # noqa: F401

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from xrt_tpu.ops import dd as jdd
from xrt_tpu_torch.ops import dd as tdd

N = 4096


def _inputs(seed):
    rng = np.random.default_rng(seed)
    big = rng.uniform(-1e6, 1e6, N).astype(np.float32)
    small = rng.uniform(-1e-3, 1e-3, N).astype(np.float32)
    mid = rng.uniform(-3e3, 3e3, N).astype(np.float32)
    pos = rng.uniform(1.0, 1e9, N).astype(np.float32)
    cyc = rng.uniform(-0.5, 0.5, N).astype(np.float32)
    # (hi, lo) pairs from float64 values
    h1, l1 = jdd.from_f64(rng.uniform(1e3, 3e4, N))
    h2, l2 = jdd.from_f64(rng.uniform(-50.0, 50.0, N))
    # phases in cycles ~ kappa * r at beamline scale
    mh, ml = jdd.from_f64(rng.uniform(1e9, 1e11, N))
    return dict(big=big, small=small, mid=mid, pos=pos, cyc=cyc, h1=h1,
                l1=l1, h2=h2, l2=l2, mh=mh, ml=ml)


CASES = {
    'two_sum': ('two_sum', ('big', 'small')),
    'quick_two_sum': ('quick_two_sum', ('big', 'small')),
    '_split': ('_split', ('mid',)),
    'two_prod': ('two_prod', ('mid', 'big')),
    'add': ('add', ('h1', 'l1', 'h2', 'l2')),
    'sub': ('sub', ('h1', 'l1', 'h2', 'l2')),
    'add_f': ('add_f', ('h1', 'l1', 'mid')),
    'mul': ('mul', ('h1', 'l1', 'h2', 'l2')),
    'mul_f': ('mul_f', ('h1', 'l1', 'mid')),
    'sqr': ('sqr', ('h2', 'l2')),
    'div': ('div', ('h1', 'l1', 'h2', 'l2')),
    'sqrt': ('sqrt', ('h1', 'l1')),
    'sqrt_nonpositive': ('sqrt', ('h2', 'l2')),
    'frac_cycles': ('frac_cycles', ('mh', 'ml')),
    'frac_two_pi': ('frac_two_pi', ('mh', 'ml')),
    'sincos_cycles': ('sincos_cycles', ('cyc',)),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_dd_function_bit_identical(case):
    fname, keys = CASES[case]
    ins = _inputs(sorted(CASES).index(case))
    j = getattr(jdd, fname)(*[jnp.asarray(ins[k]) for k in keys])
    t = getattr(tdd, fname)(*[torch.from_numpy(ins[k]) for k in keys])
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_dd_constants_and_from_f64():
    assert tdd.INV_TWO_PI_HI == jdd.INV_TWO_PI_HI
    assert tdd.INV_TWO_PI_LO == jdd.INV_TWO_PI_LO
    assert tdd._TWO_PI_HI == jdd._TWO_PI_HI
    assert tdd._TWO_PI_LO == jdd._TWO_PI_LO
    x = np.random.default_rng(7).uniform(-2e4, 2e4, N)
    for a, b in zip(jdd.from_f64(x), tdd.from_f64(x)):
        np.testing.assert_array_equal(a, b)


def test_dd_selftest_plain_rows():
    """The CPU branch of the selftest wrapper stacks the dd functions in
    the kernel's row order."""
    ins = _inputs(11)
    a, b, c = (torch.from_numpy(ins[k]) for k in ('mh', 'ml', 'cyc'))
    rows = tdd.selftest(a, b, c)
    assert rows.shape == (7, N)
    ref = [*tdd.two_sum(a, b), *tdd.two_prod(a, b), tdd.frac_cycles(a, b),
           *tdd.sincos_cycles(c)]
    for r, e in zip(rows, ref):
        assert torch.equal(r, e)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_sqrt_rn_forward_bits_do_not_depend_on_requires_grad(dtype):
    """The correctly rounded CPU root is an autograd function: asking for
    a gradient must not switch it to torch's vectorized root, which is off
    by one ulp on a fraction of a percent of inputs (one ulp of r is ~1e-6
    rad of Kirchhoff phase)."""
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 1e4, 200_000)).to(dtype)
    plain = tdd.sqrt_rn(x)
    tracked = tdd.sqrt_rn(x.clone().requires_grad_(True))
    assert plain.grad_fn is None and tracked.grad_fn is not None
    assert torch.equal(plain, tracked.detach())
    ref = np.sqrt(x.numpy())
    assert np.array_equal(plain.numpy(), ref)
    # the premise: torch's own CPU root differs somewhere on these inputs
    # in at least one of the two dtypes; numpy's never does
    assert plain.dtype == dtype


def test_sqrt_rn_gradcheck_and_forward_mode():
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        0.1, 10, 20)).requires_grad_(True)
    assert torch.autograd.gradcheck(tdd.sqrt_rn, (x,))
    y, t = torch.func.jvp(tdd.sqrt_rn, (x.detach(),),
                          (torch.ones_like(x),))
    assert torch.equal(y, tdd.sqrt_rn(x.detach()))
    assert torch.allclose(t, 0.5 / y, rtol=1e-15)
    g, = torch.autograd.grad(tdd.sqrt(x, torch.zeros_like(x))[0].sum(), [x])
    assert torch.allclose(g, 0.5 / torch.sqrt(x.detach()), rtol=1e-12)
