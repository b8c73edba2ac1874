"""The port's undulator against the JAX package's, and against xrt's golden
data.

* ``Undulator.create`` with ``targetE`` (the SoftiMAX source): K, E1, the
  e-beam sizes and the node grid (tg, ag) to 1e-12 relative, float64.
* ``build_I_map`` on the far-field and elliptic grids of
  ``ref_undulator.npz`` and with an energy spread (the Lorentz factor
  shifted per ray): against the JAX function to 1e-10 of each output's
  largest magnitude, and against the golden to ``tests/test_undulator.py``'s
  own tolerances.
* ``shine_wave`` on the SoftiMAX golden's FE-slit samples: float64 against
  the JAX field to 1e-9 of max|Es| (the spherical phase k r is ~3e10 rad,
  where one ulp of r is ~4e-6 rad), and against xrt's field (overlap and
  amplitude, the bounds of ``tests/test_softimax_chain.py``); float32
  against the float64 field: the amplitude to 1e-5 of max|Es|, and no
  farther from it than the JAX package's float32 field, run in a
  subprocess at XLA O0 (conftest ``run_in_clean_env(f32=True)``: at O1+
  the double-float phase loses its exactness), which loses ~2e-3 in the
  periodic factor (ROADMAP C16).
* A run blocked into rays of ``ray_block`` equals the unblocked run bit for
  bit.
* The options once left to ROADMAP A8 (taper, near field, the quadrature
  search) build; the sources' entry points raise without a card unless
  made for the CPU.
"""
import torch_harness  # noqa: F401

import math
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from xrt_tpu.sources import Undulator as JUndulator
from xrt_tpu.waves import Wave as JWave
from xrt_tpu_torch import interop
from xrt_tpu_torch.ops import dd as tdd
from xrt_tpu_torch.sources import Undulator

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
F64 = torch.float64

#: the SoftiMAX source of tools/bench_softimax.py
SOFTIMAX = dict(eE=3.0, eI=0.5, eEspread=0.0, eEpsilonX=0.0, eEpsilonZ=0.0,
                betaX=9.0, betaZ=2.0, period=48.0, n=77, targetE=(280.0, 1),
                eMin=279.5, eMax=280.5, xPrimeMax=0.11, zPrimeMax=0.21,
                xPrimeMaxAutoReduce=False, zPrimeMaxAutoReduce=False,
                gNodes=402, gIntervals=2)
#: the source of tests/test_undulator.py
GOLDEN_UND = dict(nrays=1000, eE=6.0, eI=0.1, eEpsilonX=0.0, eEpsilonZ=0.0,
                  period=33.0, n=50, K=1.5, eMin=9000, eMax=9600,
                  xPrimeMax=0.02, zPrimeMax=0.02, gNodes=400, gIntervals=2)


def rel(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return float(np.abs(t - j).max() / np.abs(j).max())


@pytest.fixture(scope='module')
def und_ref():
    return np.load(os.path.join(GOLDEN, 'ref_undulator.npz'))


@pytest.fixture(scope='module')
def sx_ref():
    return np.load(os.path.join(GOLDEN, 'ref_softimax.npz'))


@pytest.mark.parametrize('args', [SOFTIMAX, dict(GOLDEN_UND, eEpsilonX=1.0,
                                                 eEpsilonZ=0.02)],
                         ids=['softimax', 'emittance'])
def test_create_matches_jax(args):
    t, j = Undulator.create(**args), JUndulator.create(**args)
    for name in ('Kx', 'Ky', 'dx', 'dz', 'dxprime', 'dzprime'):
        assert getattr(t, name) == pytest.approx(
            float(getattr(j, name)), rel=1e-12, abs=1e-300), name
    assert t.E1 == pytest.approx(j.E1, rel=1e-12)
    assert (t.xPrimeMax, t.zPrimeMax) == pytest.approx(
        (j.xPrimeMax, j.zPrimeMax), rel=1e-12)
    assert t.Theta_max == pytest.approx(j.Theta_max, rel=1e-12)
    assert t.xzE == pytest.approx(j.xzE, rel=1e-12)
    assert t.tg.shape == np.asarray(j.tg).shape
    assert t.tg.shape[0] % 64 == 0
    np.testing.assert_allclose(t.tg, np.asarray(j.tg), rtol=1e-12, atol=0)
    np.testing.assert_allclose(t.ag, np.asarray(j.ag), rtol=1e-12, atol=0)


def test_softimax_targetE_tunes_the_fundamental():
    assert Undulator.create(**SOFTIMAX).E1 == pytest.approx(280.0, rel=2e-3)


@pytest.mark.parametrize('case', ['und', 'unde', 'espread'])
def test_build_I_map_matches_jax_and_golden(und_ref, case):
    kw = dict(K=None, Kx=1.0, Ky=1.2, phaseDeg=30.0, eMin=4000,
              eMax=4500) if case == 'unde' else {}
    if case == 'espread':
        kw = dict(eEspread=1e-3)
    args = dict(GOLDEN_UND, **kw)
    t, j = Undulator.create(**args), JUndulator.create(**args)
    E = und_ref['und_E'] * (0.5 if case == 'unde' else 1.0)
    th, ps = und_ref['und_theta'], und_ref['und_psi']
    dgamma = None
    if case == 'espread':
        dgamma = np.random.RandomState(3).normal(size=E.shape) * \
            t.gamma * 1e-3
    got = t.build_I_map(None, *(torch.from_numpy(v) for v in (E, th, ps)),
                        dgamma=None if dgamma is None
                        else torch.from_numpy(dgamma))
    ref = j.build_I_map(jax.random.PRNGKey(0),
                        *(jnp.asarray(v) for v in (E, th, ps)),
                        dgamma=None if dgamma is None
                        else jnp.asarray(dgamma))
    for g, r in zip(got, ref):
        assert rel(g, r) < 1e-10
    if case != 'espread':
        I, Es, Ep = (v.numpy() for v in got)
        np.testing.assert_allclose(I, und_ref[case + '_I'], rtol=1e-6,
                                   atol=1e-3)
        np.testing.assert_allclose(Es, und_ref[case + '_Es'], rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(Ep, und_ref[case + '_Ep'], rtol=1e-6,
                                   atol=1e-8)


def test_sigma_r_matches_golden(und_ref):
    und = Undulator.create(**GOLDEN_UND)
    E = und_ref['und_E'][:5]
    np.testing.assert_allclose(und.get_sigma_r02(E), und_ref['und_sigma_r02'],
                               rtol=1e-10)
    np.testing.assert_allclose(und.get_sigmaP_r02(E),
                               und_ref['und_sigmaP_r02'], rtol=1e-10)


def slit_wave_arrays(ref, f32=False):
    """The SoftiMAX golden's FE-slit wave as numpy arrays (the receiving
    points as double-float pairs when *f32*)."""
    n = len(ref['slit_xDiffr'])
    xD, yD, zD = ref['slit_xDiffr'], ref['slit_yDiffr'], ref['slit_zDiffr']
    r = np.sqrt(xD ** 2 + yD ** 2 + zD ** 2)
    a = dict(x=ref['slit_x'], y=ref['slit_y'], z=ref['slit_z'],
             a=xD / r, b=yD / r, c=zD / r, E=np.full(n, 280.0),
             state=np.ones(n, np.int32), path=np.zeros(n),
             Jss=np.zeros(n), Jpp=np.zeros(n), Jsp=np.zeros(n, complex),
             xDiffr=xD, yDiffr=yD, zDiffr=zD, rDiffr=r,
             dS=np.asarray(ref['slit_dS']),
             area=np.asarray(float(ref['slit_area'])))
    if f32:
        for k in ('xDiffr', 'yDiffr', 'zDiffr'):
            a[k], a[k + '_lo'] = tdd.from_f64(a[k])
    return a


def _overlap(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return abs(np.vdot(a, b)) / math.sqrt(np.vdot(a, a).real *
                                          np.vdot(b, b).real)


def test_shine_wave_f64_matches_jax_and_xrt(sx_ref):
    arrays = slit_wave_arrays(sx_ref)
    t = Undulator.create(**SOFTIMAX)
    j = JUndulator.create(**SOFTIMAX)
    tw = interop.wave_from_numpy(arrays, device='cpu', dtype=F64)
    jw = JWave(**{k: jnp.asarray(v) for k, v in arrays.items()})
    got = t.shine_wave(None, tw, 280.0)
    ref = j.shine_wave(jax.random.PRNGKey(0), jw, 280.0)
    scale = float(np.abs(np.asarray(ref.Es)).max())
    for name in ('Es', 'Ep'):
        d = np.abs(getattr(got, name).numpy() - np.asarray(getattr(ref,
                                                                   name)))
        assert d.max() / scale < 1e-9, name
    for name in ('a', 'b', 'c', 'Jss'):
        assert rel(getattr(got, name), getattr(ref, name)) < 1e-12, name
    assert float(got.accepted) == pytest.approx(float(ref.accepted),
                                                rel=1e-10)
    es_r = sx_ref['slit_Es']
    es_o = got.Es.numpy()
    assert abs(np.abs(es_o).mean() / np.abs(es_r).mean() - 1) < 1e-3
    assert _overlap(es_r, es_o) > 0.9999


JAX_F32 = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
from xrt_tpu.sources import Undulator
from xrt_tpu.waves import Wave
a = dict(np.load(IN))
src = Undulator.create(**ARGS)
w = Wave(**{k: jnp.asarray(v, jnp.int32 if k == 'state' else
                           (jnp.complex64 if np.iscomplexobj(v)
                            else jnp.float32)) for k, v in a.items()})
out = src.shine_wave(jax.random.PRNGKey(0), w, 280.0)
np.savez(OUT, Es=np.asarray(out.Es), Ep=np.asarray(out.Ep))
print('OK')
'''


def test_shine_wave_f32_matches_jax_f32(sx_ref, clean_env_runner, tmp_path):
    arrays = slit_wave_arrays(sx_ref, f32=True)
    arrays = {k: (v.astype(np.float32) if np.asarray(v).dtype == np.float64
                  else v) for k, v in arrays.items()}
    np.savez(tmp_path / 'in.npz', **arrays)
    code = (f'IN = {str(tmp_path / "in.npz")!r}\n'
            f'OUT = {str(tmp_path / "out.npz")!r}\nARGS = {SOFTIMAX!r}\n'
            + JAX_F32)
    stdout, _ = clean_env_runner(code, f32=True)
    assert 'OK' in stdout
    ref = np.load(tmp_path / 'out.npz')
    tw = interop.wave_from_numpy(arrays, device='cpu', dtype=torch.float32)
    got = Undulator.create(**SOFTIMAX).shine_wave(None, tw, 280.0)
    assert got.Es.dtype == torch.complex64
    f64 = Undulator.create(**SOFTIMAX).shine_wave(
        None, interop.wave_from_numpy(slit_wave_arrays(sx_ref), device='cpu',
                                      dtype=F64), 280.0)
    scale = float(np.abs(f64.Es.numpy()).max())
    for name in ('Es', 'Ep'):
        t, j, e = (np.asarray(v) for v in (getattr(got, name).numpy(),
                                            ref[name],
                                            getattr(f64, name).numpy()))
        # the port evaluates the periodic factor in float64 (ROADMAP C16):
        # its float32 amplitude holds float64 to 1e-5 of the largest (the
        # JAX package's float32 to ~2e-3), and its float32 field is no
        # farther from float64 than the JAX package's
        assert np.abs(np.abs(t) - np.abs(e)).max() / scale < 1e-5, name
        assert np.abs(t - e).max() <= np.abs(j - e).max() + 1e-5 * scale, \
            name
    # the double-float phase holds
    assert _overlap(f64.Es.numpy(), got.Es.numpy()) > 0.9999


@pytest.mark.parametrize('dtype', [torch.float32, F64])
def test_blocked_run_equals_unblocked(sx_ref, dtype):
    arrays = slit_wave_arrays(sx_ref, f32=dtype == torch.float32)
    w = interop.wave_from_numpy(arrays, device='cpu', dtype=dtype)
    src = Undulator.create(**SOFTIMAX)
    whole = src.shine_wave(None, w, 280.0)
    n = w.xDiffr.shape[0]
    blocked = src.shine_wave(None, w, 280.0, ray_block=300)
    assert n > 2 * 300 and n % 300
    for name in ('Es', 'Ep', 'Jss', 'accepted', 'a'):
        assert torch.equal(getattr(whole, name), getattr(blocked, name)), \
            name


def test_unported_undulator_options_raise_naming_the_roadmap():
    # nothing of the undulator is left to ROADMAP A8: the taper, the near
    # field and the quadrature search (its probes run on the source's
    # device) build; their parity with the JAX package:
    # tests/test_torch_undulator_nearfield.py
    for kw in (dict(taper=(1.09, 11.0)), dict(R0=5000.0),
               dict(gNodes=None, gp=1e-4, device='cpu')):
        src = Undulator.create(**dict(GOLDEN_UND, **kw))
        assert src.tg.shape[0] % 64 == 0 and src.quadm >= 3, kw
    und = Undulator.create(**GOLDEN_UND)
    # the power is host arithmetic; the ray-mode shine and the field maps
    # on meshes are ported: they run on the card unless the source was
    # made for the CPU
    assert und.power_vs_K() > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            und.shine()
        for call in (und.intensities_on_mesh, und.multi_electron_stack):
            with pytest.raises(RuntimeError, match='CUDA'):
                call()
