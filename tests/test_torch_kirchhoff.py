"""The port's plain Kirchhoff versions against the JAX package's kernels.

* B1 (recentred; mono, narrowband, poly) and B2 (per-pair double-float;
  'fast', 'exact'): the port's plain PyTorch version — what the CUDA
  kernels are held to on the card — against the JAX package's Pallas
  kernels run in interpret mode on the CPU ('vpu' accumulation), at
  1000 sources x 900 destinations with dst_tile 128 and src_chunk 256.
  Tolerance max|d| / max|ref| < 2e-5: both sides compute the same f32
  operations; only the order of the f32 sums differs (measured ~2e-7).

  The JAX side runs in a subprocess with XLA:CPU optimizations off, as
  the JAX package's own float32 tests do (conftest ``run_in_clean_env``):
  the jitted interpret mode at O1+ contracts the double-float
  error-free transforms into FMAs and loses their exactness.  The inputs
  lie on a 2^-14 mm grid (plus sub-ulp low parts), so the f32 cloud means
  that anchor the recentring are exact in any summation order: a one-ulp
  difference there moves every phase by ~1e-4 rad.
* The float64 plain path (``kirchhoff_integral_xla``) against JAX's, and
  against the golden ``ref_kirchhoff.npz`` of the reference xrt.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from xrt_tpu.ops.kirchhoff import (narrowband_err_cycles as j_nb_err,
                                   recentred_series_e_max as j_e_max)
from xrt_tpu.physconsts import CHBAR
from xrt_tpu.waves import kirchhoff_integral_xla as j_kxla
from xrt_tpu_torch.ops import dd as tdd, kirchhoff as tk
from xrt_tpu_torch.waves import kirchhoff_integral_xla as t_kxla

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')

# the inputs, made the same way in this process and in the JAX subprocess
INPUTS_CODE = r'''
import numpy as np

def make_inputs(seed, Ns, Nd, poly):
    """Beamline-like geometry (the JAX MXU parity test's): a source cloud
    1 x 0.1 x 1 mm and a 2 x 2 mm destination patch 10 m away, 9 keV."""
    rng = np.random.RandomState(seed)

    def grid(v):
        q = np.round(v * 2.0 ** 14) / 2.0 ** 14
        lo = rng.uniform(-1, 1, v.shape) * 2.0 ** -40
        lo[np.abs(q) < 2.0 ** -10] = 0.0
        return q + lo
    xs = grid(rng.uniform(-0.5, 0.5, Ns))
    ys = grid(rng.uniform(-0.05, 0.05, Ns))
    zs = grid(rng.uniform(-0.5, 0.5, Ns))
    xd = grid(rng.uniform(-1, 1, Nd))
    yd = np.full(Nd, 10000.0)
    zd = grid(rng.uniform(-1, 1, Nd))
    Es = np.exp(1j * rng.uniform(0, 2 * np.pi, Ns))
    kk = np.full(Ns, 9000.0 / 1973.269788 * 1e7)
    if poly:
        kk = kk * (1 + rng.uniform(-1e-4, 1e-4, Ns))
    n = [np.full(Ns, 0.01), np.full(Ns, 0.99), np.full(Ns, 0.02)]
    return dict(xd=xd, yd=yd, zd=zd, xs=xs, ys=ys, zs=zs, Es=Es,
                Ep=0.3 * Es, k=kk, n=n, nl=np.full(Ns, 0.9),
                w=np.ones(Ns))
'''
exec(INPUTS_CODE)

NS, ND = 1000, 900
#: (phase_mode, monochromatic, narrowband) of each case
CASES = {'mono': ('recentred', True, False),
         'narrowband': ('recentred', False, True),
         'poly': ('recentred', False, False),
         'fast': ('fast', False, False),
         'exact': ('exact', False, False)}

JAX_CODE = INPUTS_CODE + r'''
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
for name, (pm, mono, nb, acc, seed) in CASES.items():
    a = make_inputs(seed, NS, ND, poly=not mono)
    r = kirchhoff_integral_pallas(
        *jargs(a), dst_tile=128, src_chunk=256, sublanes=8,
        phase_mode=pm, monochromatic=mono, accumulate=acc,
        interpret=True, narrowband=nb)
    out[name] = np.stack([np.asarray(v) for v in r])
np.savez(OUT, **out)
print('OK')
'''


def run_jax_kernels(runner, tmp_path, cases):
    """{case: (5, Nd) complex64} from the JAX interpret-mode kernels, run
    with XLA:CPU optimizations off (see the module docstring)."""
    out = tmp_path / 'jax_kernels.npz'
    code = (f'CASES = {cases!r}\nNS, ND = {NS}, {ND}\nOUT = {str(out)!r}\n'
            + JAX_CODE)
    stdout, _ = runner(code, f32=True)
    assert 'OK' in stdout
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def targs(a):
    def d(v):
        return tuple(torch.from_numpy(x) for x in tdd.from_f64(v))

    def f(v):
        return torch.from_numpy(np.asarray(v, np.float32))
    return (d(a['xd']), d(a['yd']), d(a['zd']), d(a['xs']), d(a['ys']),
            d(a['zs']), torch.from_numpy(a['Es'].astype(np.complex64)),
            torch.from_numpy(a['Ep'].astype(np.complex64)), d(a['k']),
            [f(v) for v in a['n']], f(a['nl']), f(a['w']))


def rel_errors(got, ref):
    return [float(np.abs(g - r).max() / np.abs(r).max())
            for g, r in zip(got, ref)]


@pytest.fixture(scope='module')
def jax_vpu(clean_env_runner, tmp_path_factory):
    cases = {name: (pm, mono, nb, 'vpu', 20 + i)
             for i, (name, (pm, mono, nb)) in enumerate(CASES.items())}
    return run_jax_kernels(clean_env_runner, tmp_path_factory.mktemp('k'),
                           cases)


@pytest.mark.parametrize('case', list(CASES))
def test_plain_kernel_versions_match_jax_interpret(jax_vpu, case):
    pm, mono, nb = CASES[case]
    a = make_inputs(20 + list(CASES).index(case), NS, ND, poly=not mono)
    got = tk.kirchhoff_integral_kernel(*targs(a), phase_mode=pm,
                                       monochromatic=mono, accumulate='vpu',
                                       narrowband=nb)
    got = np.stack([v.numpy() for v in got])
    errs = rel_errors(got, jax_vpu[case])
    assert max(errs) < 2e-5, (case, errs)


def test_wrapper_on_cpu_is_the_plain_version():
    a = make_inputs(7, 300, 200, poly=True)
    before = dict(tk.LAUNCHES)
    for pm in ('recentred', 'fast', 'exact'):
        w = tk.kirchhoff_integral_kernel(*targs(a), phase_mode=pm,
                                         accumulate='vpu', narrowband=False)
        if pm == 'recentred':
            p = tk.kirchhoff_integral_recentred(*targs(a))
        else:
            p = tk.kirchhoff_integral_dd(*targs(a), phase_mode=pm)
        for x, y in zip(w, p):
            assert torch.equal(x, y)
    assert dict(tk.LAUNCHES) == before      # no kernel on the CPU


def test_envelope_helpers_match_jax():
    a = make_inputs(8, 500, 300, poly=True)
    pos = [a[k] for k in ('xd', 'yd', 'zd', 'xs', 'ys', 'zs')]
    assert tk.recentred_series_e_max(*pos) == pytest.approx(
        j_e_max(*pos), rel=1e-12)
    assert tk.narrowband_err_cycles(a['k'], *pos) == pytest.approx(
        j_nb_err(a['k'], *pos), rel=1e-12)
    # long grazing footprint at short distance: outside the envelope
    rng = np.random.RandomState(4)
    ys = rng.uniform(-300, 300, 500)
    e2 = tk.recentred_series_e_max(
        rng.uniform(-1, 1, 300), np.full(300, 500.0),
        np.full(300, 4.0) + rng.uniform(-1, 1, 300), np.zeros(500), ys,
        ys * 0.004)
    assert e2 > tk.SERIES_E_MAX


def test_mxu_envelope_fallback_warns():
    """Outside the 1/A-series envelope an 'mxu' request warns and runs the
    exact contraction (the same result as 'vpu')."""
    rng = np.random.RandomState(5)
    Ns, Nd = 600, 300
    ys = rng.uniform(-300, 300, Ns)
    a = dict(xd=rng.uniform(-1, 1, Nd), yd=np.full(Nd, 500.0),
             zd=np.full(Nd, 4.0) + rng.uniform(-0.5, 0.5, Nd),
             xs=rng.uniform(-1, 1, Ns), ys=ys, zs=ys * 0.004,
             Es=np.exp(1j * rng.uniform(0, 2 * np.pi, Ns)),
             Ep=np.zeros(Ns, complex), k=np.full(Ns, 9000.0 / CHBAR * 1e7),
             n=[np.zeros(Ns), np.full(Ns, -0.004), np.ones(Ns)],
             nl=np.full(Ns, 0.9), w=np.ones(Ns))
    with pytest.warns(UserWarning, match='series envelope'):
        got = tk.kirchhoff_integral_kernel(*targs(a), monochromatic=True,
                                           accumulate='mxu')
    ref = tk.kirchhoff_integral_kernel(*targs(a), monochromatic=True,
                                       accumulate='vpu')
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _xla_inputs(seed, Ns=700, Nd=150):
    rng = np.random.RandomState(seed)
    xs = rng.uniform(-0.3, 0.3, Ns)
    ys = rng.uniform(-20, 20, Ns)
    zs = ys * 6e-3 + rng.uniform(-1e-3, 1e-3, Ns)
    xd = rng.uniform(-0.02, 0.02, Nd)
    yd = np.full(Nd, 1000.0) + rng.uniform(-1, 1, Nd)
    zd = rng.uniform(-0.02, 0.02, Nd)
    Es = np.exp(1j * rng.uniform(0, 2 * np.pi, Ns)) * rng.uniform(
        0.5, 1, Ns)
    Ep = 0.2j * Es
    k = np.full(Ns, 500.0 / CHBAR * 1e7)
    n = [np.zeros(Ns), np.full(Ns, -6e-3), np.ones(Ns)]
    nl = rng.uniform(0.005, 0.007, Ns)
    w = (rng.uniform(0, 1, Ns) > 0.1).astype(float)
    return (xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, w)


def test_kirchhoff_integral_xla_f64_matches_jax():
    """float64 plain path: the same IEEE operations on the same inputs;
    tolerance 1e-12 relative (the per-chunk sum order may differ).  JAX
    runs with jit disabled: its scan body compiled as a whole contracts
    a*a + b*b into FMAs, moving r by an ulp (~1e-7 rad at k r ~ 2.5e9)."""
    args = _xla_inputs(9)
    with jax.disable_jit():
        J = j_kxla(*[jnp.asarray(v) for v in args[:9]],
                   [jnp.asarray(v) for v in args[9]],
                   jnp.asarray(args[10]), jnp.asarray(args[11]))
    T = t_kxla(*[torch.from_numpy(np.ascontiguousarray(v))
                 for v in args[:9]],
               [torch.from_numpy(v) for v in args[9]],
               torch.from_numpy(args[10]), torch.from_numpy(args[11]))
    errs = rel_errors([t.numpy() for t in T], [np.asarray(j) for j in J])
    assert max(errs) < 1e-12, errs


def test_kirchhoff_integral_xla_vs_reference_golden():
    """The golden data of the reference xrt (OpenCL, float64), at the
    tolerances of the JAX package's own test."""
    ref = np.load(os.path.join(GOLDEN, 'ref_kirchhoff.npz'))
    T = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    k = T(ref['src_E']) / CHBAR * 1e7
    N = ref['src_x'].shape
    n = [torch.zeros(N, dtype=torch.float64),
         torch.ones(N, dtype=torch.float64),
         torch.zeros(N, dtype=torch.float64)]
    w = T(ref['good'].astype(float))
    Es, Ep, aE, bE, cE = t_kxla(
        T(ref['dst_x']), T(ref['dst_y']), T(ref['dst_z']),
        T(ref['src_x']), T(ref['src_y']), T(ref['src_z']),
        T(ref['src_Es']), T(ref['src_Ep']), k, n, n[1], w)
    np.testing.assert_allclose(Es.numpy(), ref['Es'], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(Ep.numpy(), ref['Ep'], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(aE.numpy(), ref['aE'], rtol=1e-8, atol=1e-3)
    np.testing.assert_allclose(bE.numpy(), ref['bE'], rtol=1e-8, atol=1e-3)
    np.testing.assert_allclose(cE.numpy(), ref['cE'], rtol=1e-8, atol=1e-3)


def test_skipping_the_envelope_check_gives_the_same_bits(monkeypatch):
    """``check_envelope=False`` (a chain whose modes were chosen at build
    time) reads nothing back to the host and gives the bits of a checked
    call on a geometry inside the envelope."""
    a = make_inputs(9, 500, 300, poly=False)
    pos = [a[k] for k in ('xd', 'yd', 'zd', 'xs', 'ys', 'zs')]
    assert tk.recentred_series_e_max(*pos) < tk.SERIES_E2_MAX
    checked = tk.kirchhoff_integral_kernel(*targs(a), monochromatic=True,
                                           accumulate='mxu')

    def no_host_read(*args):
        raise AssertionError('the envelope check ran')
    monkeypatch.setattr(tk, 'recentred_series_e_max', no_host_read)
    skipped = tk.kirchhoff_integral_kernel(*targs(a), monochromatic=True,
                                           accumulate='mxu',
                                           check_envelope=False)
    for x, y in zip(checked, skipped):
        assert torch.equal(x, y)
    with pytest.raises(AssertionError, match='envelope check ran'):
        tk.kirchhoff_integral_kernel(*targs(a), monochromatic=True,
                                     accumulate='mxu')
