"""The port's ray-mode undulator ``shine`` against the JAX package.

* With the draws injected (the candidates' uniforms in E, theta and psi,
  the energy-spread normals, the resampling uniforms, the e-beam
  divergence and position normals, all taken from the JAX package's own
  keys), the beam the port makes equals the JAX package's ``shine``, every
  field and the flux bookkeeping to 1e-9 of each field's largest
  magnitude, float64: the BASELINE configuration-4 undulator (Si(111)
  band, gNodes 64), the same with an energy spread and a pitch, and at a
  fixed energy.
* The candidates' integral in ray blocks equals the one in a single block.
* The Tanaka-Kitamura sizes and divergences with an energy spread
  (``get_SIGMA``, ``get_SIGMAP``, ``tanaka_kitamura_Qa2``) to 1e-12.
* A free run with the port's own generator: unit amplitudes, the
  coherency matrix of a unit intensity, energies and angles inside the
  acceptance, and the moments against a free run of the JAX package
  (sizes, divergences and mean energy within their Monte-Carlo spreads).
"""
import torch_harness  # noqa: F401

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from xrt_tpu.sources import Undulator as JUndulator
from xrt_tpu_torch.sources import Undulator, undulator as tund

F64 = torch.float64
E0 = 9000.0
KW = dict(nrays=500, eE=3.0, eI=0.5, period=18.0, n=111, targetE=(E0, 7),
          eEpsilonX=0.263, eEpsilonZ=0.008, betaX=9.0, betaZ=2.0,
          xPrimeMax=0.02, zPrimeMax=0.02, gNodes=64, eMin=E0 - 40,
          eMax=E0 + 40)
CASES = {'config4': ({}, {}),
         'spread_pitch': (dict(eEspread=8e-4, pitch=2e-4), {}),
         'fixed_energy': ({}, dict(fixedEnergy=E0 + 5.0))}
FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'Jss', 'Jpp', 'Jsp', 'Es', 'Ep',
          'accepted', 'acceptedE', 'seeded', 'seededI')


def jax_draws(key, nrays, M, dt=jnp.float64):
    """The draws of the JAX package's ``shine`` from *key*, as numpy."""
    keys = jax.random.split(key, 10)
    k1, k2 = jax.random.split(keys[8])
    d = dict(E=jax.random.uniform(keys[0], (M,), dt),
             theta=jax.random.uniform(keys[1], (M,), dt),
             psi=jax.random.uniform(keys[2], (M,), dt),
             gamma=jax.random.normal(keys[3], (M,), dt),
             choice=jax.random.uniform(keys[4], (nrays,), dt),
             dtheta=jax.random.normal(keys[5], (nrays,), dt),
             dpsi=jax.random.normal(keys[7], (nrays,), dt),
             x=jax.random.normal(k1, (nrays,), dt),
             z=jax.random.normal(k2, (nrays,), dt))
    return {k: np.array(v) for k, v in d.items()}


@pytest.mark.parametrize('case', sorted(CASES))
def test_shine_with_injected_draws_matches_jax(case):
    extra, shine_kw = CASES[case]
    kw = dict(KW, **extra)
    ju = JUndulator.create(**kw)
    tu = Undulator.create(**kw, dtype=F64, device='cpu')
    key = jax.random.PRNGKey(4)
    jb = jax.jit(lambda k: ju.shine(k, **shine_kw))(key)
    tb = tu.shine(None, draws=jax_draws(key, 500, 500 * tu.oversample),
                  **shine_kw)
    for f in FIELDS:
        j = np.asarray(getattr(jb, f))
        t = getattr(tb, f).numpy()
        scale = max(float(np.abs(j).max()), 1e-300)
        assert np.abs(t - j).max() / scale < 1e-9, f
    np.testing.assert_array_equal(tb.state.numpy(), np.asarray(jb.state))


def test_ray_blocks_match_one_block(monkeypatch):
    tu = Undulator.create(**dict(KW, eEspread=8e-4), dtype=F64, device='cpu')
    draws = jax_draws(jax.random.PRNGKey(1), 500, 2000)
    one = tu.shine(None, draws=draws)
    monkeypatch.setattr(tund, 'RAY_BLOCK', 300)
    blocks = tu.shine(None, draws=draws)
    for f in ('x', 'z', 'a', 'c', 'E', 'Jss', 'Es', 'accepted'):
        assert torch.equal(getattr(one, f), getattr(blocks, f)), f


def test_source_sizes_with_energy_spread():
    kw = dict(KW, eEspread=1e-3)
    ju = JUndulator.create(**kw)
    tu = Undulator.create(**kw, dtype=F64, device='cpu')
    E = np.linspace(1000.0, 40000.0, 57)
    for meth in ('get_SIGMA', 'get_SIGMAP'):
        for odd in (True, False):
            for t, j in zip(getattr(tu, meth)(torch.from_numpy(E), odd),
                            getattr(ju, meth)(jnp.asarray(E), odd)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-12)
    x = np.linspace(0.0, 3.0, 31)
    from xrt_tpu.sources.undulator import tanaka_kitamura_Qa2 as jQa2
    np.testing.assert_allclose(
        tund.tanaka_kitamura_Qa2(torch.from_numpy(x)).numpy(),
        np.asarray(jQa2(jnp.asarray(x))), rtol=1e-12)


def test_free_run_moments():
    n = 3000
    kw = dict(KW, nrays=n)
    tb = Undulator.create(**kw, dtype=F64, device='cpu').shine(
        torch.Generator().manual_seed(3))
    jb = jax.jit(lambda k: JUndulator.create(**kw).shine(k))(
        jax.random.PRNGKey(3))
    np.testing.assert_allclose(torch.abs(tb.Es).numpy(), 1.0, rtol=1e-12)
    np.testing.assert_allclose((tb.Jss + tb.Jpp).numpy(), 1.0, rtol=1e-12)
    assert float(tb.E.min()) >= E0 - 40 and float(tb.E.max()) <= E0 + 40
    assert float(tb.accepted) > 0 and torch.isfinite(tb.accepted)
    for f in ('x', 'z', 'a', 'c'):
        t, j = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert abs(t.std() / j.std() - 1) < 0.1, f
        assert abs(t.mean() - j.mean()) < 5 * j.std() / np.sqrt(n), f
    assert abs(float(tb.E.mean()) - float(np.asarray(jb.E).mean())) < \
        5 * float(np.asarray(jb.E).std()) / np.sqrt(n)
    assert abs(float(tb.accepted) / float(jb.accepted) - 1) < 0.1
