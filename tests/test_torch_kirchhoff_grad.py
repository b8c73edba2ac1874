"""Gradients through the port's Kirchhoff wrapper against the JAX package's
custom VJP, and against finite differences.

* All twelve cotangents (positions hi and lo, Es, Ep, k hi and lo, the
  three normal components, nl, weights) of every variant (recentred poly,
  mono, narrowband; per-pair double-float 'fast', 'exact'): the port's
  ``kirchhoff_integral_kernel`` on CPU tensors (its autograd function with
  the plain forward and the plain blocked backward) against ``jax.grad``
  through ``kirchhoff_integral_pallas(..., interpret=True)`` (the
  interpret-mode kernel forward, the blocked XLA backward), in float32.
  The JAX side runs in a subprocess at XLA ``O0``, as the other
  interpret-mode parity tests do.  Inputs: those of
  ``tests/test_kirchhoff_grad.py::_problem`` (Nd = 37, Ns = 61) with the
  hi parts snapped to a binary grid, so that the f32 cloud means that
  anchor the recentring are exact in any summation order.  The loss is a
  fixed random complex contraction of all five outputs.  Tolerance: 1e-4
  of the largest component of each cotangent, the reference's own
  ``atol=1e-4*scale``; measured: <= 4e-7 (poly, mono, exact) and 3e-5
  (narrowband).  Two variants have no backward of their own in the JAX
  package: its blocked backward differentiates the exact-poly formulation
  for 'narrowband' and the 'exact' formulation for 'fast'
  (``xrt_tpu/ops/kirchhoff.py:1105-1117``), while the port differentiates
  the variant that ran.  'narrowband' stays inside 1e-4; 'fast' carries
  its own phase error (~1e-3 rad here) into the gradient and is held to
  5e-3 (measured 1.8e-3), and to finite differences in float64 below.
* For a real loss JAX returns the cotangent of a complex leaf as
  dL/dRe - i dL/dIm, PyTorch's ``.grad`` is dL/dRe + i dL/dIm: the
  comparison conjugates JAX's.
* The reference's finite-difference cases (``tests/test_kirchhoff_grad.py``
  lines 61-153), in float64 through the same wrapper (plain path), at the
  reference's rtol of 1e-4 to 3e-4.
* The blocked backward against unblocked autograd of the same plain
  function: Nd not a multiple of the block, a destination that coincides
  with the zero-padding candidate point of the sources: agreement <= 1e-6
  of each row's largest value, no NaN.
* The forward value does not depend on whether a gradient is asked for.
"""
import torch_harness  # noqa: F401

import numpy as np
import pytest
import torch

from xrt_tpu_torch.ops import dd as tdd, kirchhoff as tk

KV = 9000.0 / 1973.269788 * 1e7

INPUTS_CODE = r'''
import numpy as np

KV = 9000.0 / 1973.269788 * 1e7


def problem(Nd=37, Ns=61, seed=0, poly=False, grid=True):
    """The inputs of tests/test_kirchhoff_grad.py::_problem; with *grid*
    the positions are snapped to a binary grid (x, z and the sources to
    2^-14 mm, the destinations' y to 2^-6 mm) plus sub-ulp low parts."""
    rng = np.random.default_rng(seed)
    xd = rng.normal(0, .5, Nd)
    yd = np.full((Nd,), 5000.0) + rng.normal(0, 0.1, Nd)
    zd = rng.normal(0, .5, Nd)
    xs = rng.normal(0, .3, Ns)
    ys = rng.normal(0, .3, Ns)
    zs = rng.normal(0, .1, Ns)
    Es = rng.normal(size=Ns) + 1j * rng.normal(size=Ns)
    Ep = 0.5 * Es
    k = np.full((Ns,), KV)
    n = [np.zeros(Ns), np.ones(Ns), np.zeros(Ns)]
    nl = rng.uniform(0.8, 1.0, Ns)
    w = np.ones(Ns)
    if poly:
        k = k * (1 + rng.uniform(-1e-4, 1e-4, Ns))
    if grid:
        def snap(v, bits):
            q = np.round(v * 2.0 ** bits) / 2.0 ** bits
            return q + rng.uniform(-1, 1, v.shape) * 2.0 ** -42
        xd, zd, xs, ys, zs = (snap(v, 14) for v in (xd, zd, xs, ys, zs))
        yd = snap(yd, 6)
    return dict(xd=xd, yd=yd, zd=zd, xs=xs, ys=ys, zs=zs, Es=Es, Ep=Ep,
                k=k, n=n, nl=nl, w=w)


def cotangents(Nd, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=Nd) + 1j * rng.normal(size=Nd)
            for _ in range(5)]
'''
exec(INPUTS_CODE)

#: (phase_mode, monochromatic, narrowband) of each case
CASES = {'poly': ('recentred', False, False),
         'mono': ('recentred', True, False),
         'narrowband': ('recentred', False, True),
         'fast': ('fast', False, False),
         'exact': ('exact', False, False)}
#: limit on |d cotangent| / max|cotangent| against JAX (module docstring)
TOL = {'poly': 1e-4, 'mono': 1e-4, 'narrowband': 1e-4, 'exact': 1e-4,
       'fast': 5e-3}
#: the twelve differentiable inputs, as flat names
NAMES = ('xd_hi', 'xd_lo', 'yd_hi', 'yd_lo', 'zd_hi', 'zd_lo', 'xs_hi',
         'xs_lo', 'ys_hi', 'ys_lo', 'zs_hi', 'zs_lo', 'Es', 'Ep', 'k_hi',
         'k_lo', 'n0', 'n1', 'n2', 'nl', 'w')

JAX_CODE = INPUTS_CODE + r'''
import jax
import jax.numpy as jnp
from xrt_tpu.ops import dd
from xrt_tpu.ops.kirchhoff import kirchhoff_integral_pallas

def jargs(a):
    d = lambda v: tuple(map(jnp.asarray, dd.from_f64(v)))
    f = lambda v: jnp.asarray(v, jnp.float32)
    return (d(a['xd']), d(a['yd']), d(a['zd']), d(a['xs']), d(a['ys']),
            d(a['zs']), jnp.asarray(a['Es'], jnp.complex64),
            jnp.asarray(a['Ep'], jnp.complex64), d(a['k']),
            [f(v) for v in a['n']], f(a['nl']), f(a['w']))

out = {}
for name, (pm, mono, nb) in CASES.items():
    a = problem(poly=not mono)
    cts = [jnp.asarray(c, jnp.complex64) for c in cotangents(37)]

    def loss(*args):
        o = kirchhoff_integral_pallas(
            *args, phase_mode=pm, monochromatic=mono, accumulate='vpu',
            interpret=True, narrowband=nb)
        return sum(jnp.sum(jnp.real(v * jnp.conj(c)))
                   for v, c in zip(o, cts))
    val, g = jax.value_and_grad(loss, argnums=tuple(range(12)))(*jargs(a))
    flat = []
    for gi in g:
        flat += list(gi) if isinstance(gi, (tuple, list)) else [gi]
    out[name + ':loss'] = np.asarray(val)
    for nm, v in zip(NAMES, flat):
        out[name + ':' + nm] = np.asarray(v)
np.savez(OUT, **out)
print('OK')
'''


def targs(a, dtype=torch.float32):
    """The port's arguments from the numpy inputs: (hi, lo) pairs in
    float32, plain tensors in float64."""
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128

    def d(v):
        if dtype == torch.float64:
            return torch.from_numpy(np.asarray(v, np.float64))
        return tuple(torch.from_numpy(x) for x in tdd.from_f64(v))

    def f(v):
        return torch.from_numpy(np.asarray(v)).to(dtype)
    return [d(a['xd']), d(a['yd']), d(a['zd']), d(a['xs']), d(a['ys']),
            d(a['zs']), torch.from_numpy(a['Es']).to(cdt),
            torch.from_numpy(a['Ep']).to(cdt), d(a['k']),
            [f(v) for v in a['n']], f(a['nl']), f(a['w'])]


def leaves_of(args):
    """(args with every tensor a leaf that requires grad, the flat list of
    those leaves in :data:`NAMES` order)."""
    flat = []

    def leaf(t):
        t = t.clone().requires_grad_(True)
        flat.append(t)
        return t
    new = [type(a)(leaf(t) for t in a) if isinstance(a, (tuple, list))
           else leaf(a) for a in args]
    return new, flat


def contraction(out, cts):
    return sum((o * torch.conj(c)).real.sum() for o, c in zip(out, cts))


@pytest.fixture(scope='module')
def jax_grads(clean_env_runner, tmp_path_factory):
    out = tmp_path_factory.mktemp('kg') / 'jax_grads.npz'
    code = (f'CASES = {CASES!r}\nNAMES = {NAMES!r}\nOUT = {str(out)!r}\n'
            + JAX_CODE)
    stdout, _ = clean_env_runner(code, timeout=1200, f32=True)
    assert 'OK' in stdout
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize('case', list(CASES))
def test_all_twelve_cotangents_match_jax_custom_vjp(jax_grads, case):
    pm, mono, nb = CASES[case]
    a = problem(poly=not mono)
    args, flat = leaves_of(targs(a))
    cts = [torch.from_numpy(c).to(torch.complex64) for c in cotangents(37)]
    out = tk.kirchhoff_integral_kernel(*args, phase_mode=pm,
                                       monochromatic=mono, accumulate='vpu',
                                       narrowband=nb)
    loss = contraction(out, cts)
    # the contraction cancels: hold the loss to 1e-5 of the sum of its
    # terms' magnitudes (1e-3 for 'fast': its own phase error)
    terms = float(sum((o.abs() * c.abs()).sum() for o, c in zip(out, cts)))
    assert abs(float(loss.detach()) - float(jax_grads[case + ':loss'])) <= \
        (1e-3 if case == 'fast' else 1e-5) * terms
    grads = torch.autograd.grad(loss, flat)
    assert len(grads) == len(NAMES) == 21
    worst = {}
    for nm, g in zip(NAMES, grads):
        ref = jax_grads[f'{case}:{nm}']
        if nm in ('Es', 'Ep'):
            ref = np.conj(ref)      # JAX: dL/dRe - i dL/dIm
        scale = float(np.abs(ref).max())
        err = float(np.abs(g.numpy() - ref).max())
        assert np.isfinite(g.numpy()).all()
        worst[nm] = err / scale if scale > 0 else err
        assert err <= TOL[case] * scale, (case, nm, err, scale)
    print(case, 'worst relative error', max(worst.values()))
    if pm != 'recentred':
        # the kernel's hi and lo keys of a coordinate share one cotangent
        assert torch.equal(grads[0], grads[1])
        assert torch.equal(grads[6], grads[7])


def _loss64(args, **kw):
    out = tk.kirchhoff_integral_kernel(*args, **kw)
    return torch.sum(torch.abs(out[0]) ** 2) + \
        torch.sum(torch.abs(out[2]) ** 2) * 1e-20


def _fd_check(index, elem, h, rtol, kw, sub=None, imag=False, Nd=37, Ns=61):
    """Central finite difference of the float64 loss in one element of one
    input against the autograd gradient."""
    a = problem(Nd=Nd, Ns=Ns, grid=False)
    args = targs(a, torch.float64)

    def get(arr):
        return arr[index] if sub is None else arr[index][sub]

    def value(delta):
        b = [list(v) if isinstance(v, list) else v for v in args]
        t = get(b).clone()
        t[elem] = t[elem] + delta
        if sub is None:
            b[index] = t
        else:
            b[index][sub] = t
        with torch.no_grad():
            return float(_loss64(b, **kw))
    step = 1j * h if imag else h
    fd = (value(step) - value(-step)) / (2 * h)
    largs, _ = leaves_of(args)
    leaf = get(largs)
    g, = torch.autograd.grad(_loss64(largs, **kw), [leaf])
    got = float(g[elem].imag if imag else g[elem].real)
    assert fd != 0
    assert got == pytest.approx(fd, rel=rtol), (got, fd)


FD_CASES = {
    # name: (input index, element, h, rtol, wrapper keywords, sizes)
    'src_z': (5, 7, 1e-9, 1e-4, dict(accumulate='vpu'), (37, 61)),
    'dst_z': (2, 3, 1e-9, 1e-4, dict(accumulate='vpu'), (37, 61)),
    'weights': (11, 5, 1e-6, 3e-4, dict(accumulate='vpu'), (17, 23)),
    'src_z_mono': (5, 7, 1e-9, 2e-4,
                   dict(accumulate='vpu', monochromatic=True), (17, 23)),
    'src_z_fast': (5, 7, 1e-9, 2e-4, dict(phase_mode='fast'), (17, 23)),
}


@pytest.mark.parametrize('case', list(FD_CASES))
def test_gradient_matches_finite_differences_f64(case):
    index, elem, h, rtol, kw, (Nd, Ns) = FD_CASES[case]
    _fd_check(index, elem, h, rtol, kw, Nd=Nd, Ns=Ns)


@pytest.mark.parametrize('imag', [False, True])
def test_field_gradient_matches_finite_differences_f64(imag):
    """PyTorch's ``.grad`` of a complex leaf is dL/dRe + i dL/dIm."""
    _fd_check(6, 5, 1e-6, 3e-4, dict(accumulate='vpu'), imag=imag, Nd=17,
              Ns=23)


def _soa(a, case, dtype):
    args = [tk._astuple(v) if i in (0, 1, 2, 3, 4, 5, 8) else v
            for i, v in enumerate(targs(a, dtype))]
    return tk._kernel_inputs(*args, case)


@pytest.mark.parametrize('case', list(CASES))
def test_blocked_backward_matches_unblocked_autograd(case):
    """Nd = 37 in blocks of 16 (ragged last block), sources in chunks of
    16 (zero-padded to 64).  For the per-pair schemes the last destination
    but one sits at the origin, where the padded sources are: a
    zero-padded destination block would meet r = 0 there, the edge-padded
    one repeats the last destination."""
    pm, mono, nb = CASES[case]
    a = problem(poly=not mono, grid=False)
    if pm != 'recentred':
        for kk in ('xd', 'yd', 'zd'):
            a[kk][-1] = 1.0 if kk == 'yd' else 0.0
    scheme, v, D, S, P = _soa(a, case, torch.float64)
    G = torch.from_numpy(np.random.default_rng(2).normal(size=(10, 37)))
    got = tk.kirchhoff_bwd_blocked(scheme, v, D, S, P, G, dst_block=16,
                                   src_chunk=16)
    wrt = [t.clone().requires_grad_(True) for t in (D, S, P)
           if t is not None]
    out = tk._plain_rows(scheme, v, *wrt)
    ref = torch.autograd.grad(out, wrt, G, allow_unused=True)
    for g, r in zip(got, ref):
        if r is None:
            continue
        assert torch.isfinite(g).all()
        for i in range(r.shape[0]):
            scale = float(r[i].abs().max())
            assert float((g[i] - r[i]).abs().max()) <= 1e-6 * scale + 1e-300


@pytest.mark.parametrize('case', list(CASES))
def test_forward_bits_do_not_depend_on_requires_grad(case):
    pm, mono, nb = CASES[case]
    a = problem(poly=not mono)
    kw = dict(phase_mode=pm, monochromatic=mono, accumulate='vpu',
              narrowband=nb)
    plain = tk.kirchhoff_integral_kernel(*targs(a), **kw)
    args, _ = leaves_of(targs(a))
    tracked = tk.kirchhoff_integral_kernel(*args, **kw)
    for p, t in zip(plain, tracked):
        assert p.grad_fn is None and t.grad_fn is not None
        assert torch.equal(p, t.detach())


def test_params_reach_the_function_as_tensors():
    """The ten scalars of the recentred scheme are one (10,) tensor built
    without a host read, and a gradient flows through it: a destination
    coordinate gets a cotangent through the cloud means (rho, C, L) alone,
    which a parameter vector read to the host would drop."""
    a = problem()
    args, flat = leaves_of(targs(a))
    t = [tk._astuple(v) if i in (0, 1, 2, 3, 4, 5, 8) else v
         for i, v in enumerate(args)]
    _, _, D, S, P = tk._kernel_inputs(*t, 'mono')
    assert P.shape == (10,) and P.grad_fn is not None
    assert float(P.detach()[tk._PARAM_KEYS.index('invR0')]) == \
        pytest.approx(1 / 5000.0, rel=1e-3)
    G = torch.from_numpy(np.random.default_rng(1).normal(size=(10, 37))).to(
        torch.float32)
    leaf = flat[2]      # yd, hi part
    through_params, = torch.autograd.grad(
        (tk._KirchhoffRecentred.apply(D.detach(), S.detach(), P, 0)
         * G).sum(), [leaf])
    assert torch.isfinite(through_params).all()
    assert float(through_params.abs().min()) > 0
