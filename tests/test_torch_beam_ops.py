"""The port's beam helpers and frame transforms against the JAX package.

* ``concatenate``, ``filter_by_index`` (indices and a mask),
  ``filter_good``, ``replace_by_index`` (indices and a mask),
  ``copy_beam``, ``absorb_intensity``, ``project_energy_to_band``,
  ``add_wave`` and ``make_uniform_energy_band`` (the JAX package's
  uniforms injected), and the ``Beam`` properties ``nrays``, ``good``,
  ``alive``, ``intensity``, ``flux_good``, ``with_amplitudes`` and
  ``masked_replace``: equal to the JAX package's to 1e-15, float64.
* ``rotate_point``, and ``global_to_virgin_local`` /
  ``virgin_local_to_global`` with a beamline azimuth (and their
  ``skip_xyz`` / ``skip_abc`` forms): to 1e-12, and the round trip.
"""
import torch_harness  # noqa: F401

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from xrt_tpu import beam as jb, transforms as jt
from xrt_tpu_torch import beam as tb, interop, transforms as tt

F64 = torch.float64


def _rays(n, seed, amps=True):
    rng = np.random.RandomState(seed)
    a, c = rng.normal(0, 1e-3, n), rng.normal(0, 1e-3, n)
    d = dict(x=rng.normal(size=n), y=rng.normal(size=n),
             z=rng.normal(size=n), a=a, b=np.sqrt(1 - a ** 2 - c ** 2), c=c,
             E=rng.uniform(8000, 9000, n),
             state=rng.choice([-1, 0, 1, 1, 1, 2, 3], n).astype(np.int32),
             path=rng.uniform(0, 10, n), Jss=rng.uniform(size=n),
             Jpp=rng.uniform(size=n),
             Jsp=rng.normal(size=n) + 1j * rng.normal(size=n))
    if amps:
        d.update(Es=rng.normal(size=n) + 1j * rng.normal(size=n),
                 Ep=rng.normal(size=n) + 1j * rng.normal(size=n))
    return d


def _both(d, accepted=None):
    j = jb.Beam(**{k: jnp.asarray(v) for k, v in d.items()})
    t = interop.beam_from_numpy(d, device='cpu', dtype=F64)
    if accepted is not None:
        j = j.replace(accepted=jnp.asarray(accepted))
        t = t.replace(accepted=torch.tensor(accepted, dtype=F64))
    return j, t


def _same(t, j, tol=1e-15):
    for f in jb.Beam.__dataclass_fields__:
        jv, tv = getattr(j, f), getattr(t, f)
        if jv is None:
            assert tv is None, f
            continue
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=tol, err_msg=f)


def test_beam_helpers_match_jax():
    d1, d2 = _rays(300, 1), _rays(200, 2)
    (j1, t1), (j2, t2) = _both(d1, 5.0), _both(d2, 7.0)
    _same(tb.concatenate(t1, t2), jb.concatenate(j1, j2))
    idx = np.random.RandomState(3).choice(300, 50, replace=False)
    mask = np.random.RandomState(4).uniform(size=300) < 0.4
    _same(tb.filter_by_index(t1, idx), jb.filter_by_index(j1, idx))
    _same(tb.filter_by_index(t1, mask), jb.filter_by_index(j1, mask))
    _same(tb.filter_good(t1), jb.filter_good(j1))
    (j3, t3) = _both(_rays(300, 5), 9.0)
    _same(tb.replace_by_index(t1, idx, t3), jb.replace_by_index(j1, idx, j3))
    _same(tb.replace_by_index(t1, mask, t3),
          jb.replace_by_index(j1, mask, j3))
    c = tb.copy_beam(t1)
    _same(c, jb.copy_beam(j1))
    c.x[0] = 99.0
    assert float(t1.x[0]) != 99.0           # independent tensors
    _same(tb.absorb_intensity(t3, t1, -1.0),
          jb.absorb_intensity(j3, j1, -1.0))
    _same(tb.project_energy_to_band(t1, 100.0, 200.0),
          jb.project_energy_to_band(j1, 100.0, 200.0), tol=1e-12)
    _same(tb.add_wave(t1, t3, -1.0), jb.add_wave(j1, j3, -1.0), tol=1e-14)
    key = jax.random.PRNGKey(6)
    jE = jb.make_uniform_energy_band(j1, key, 100.0, 200.0)
    u = (np.asarray(jE.E) - 100.0) / 100.0
    tE = tb.make_uniform_energy_band(t1, None, 100.0, 200.0,
                                     draws=torch.as_tensor(u))
    _same(tE, jE, tol=1e-12)
    tg = tb.make_uniform_energy_band(t1, torch.Generator().manual_seed(1),
                                     100.0, 200.0)
    assert float(tg.E.min()) >= 100.0 and float(tg.E.max()) < 200.0


def test_beam_properties_match_jax():
    j, t = _both(_rays(400, 7))
    assert t.nrays == j.nrays
    for p in ('good', 'alive', 'intensity', 'flux_good'):
        np.testing.assert_allclose(np.asarray(getattr(t, p)),
                                   np.asarray(getattr(j, p)), rtol=1e-15)
    jn, tn = _both(_rays(10, 8, amps=False))
    _same(tn.with_amplitudes(), jn.with_amplitudes())
    assert t.with_amplitudes() is t
    mask = np.arange(400) % 3 == 0
    _same(t.masked_replace(torch.as_tensor(mask), x=t.y, E=t.E * 2),
          j.masked_replace(jnp.asarray(mask), x=j.y, E=j.E * 2))


@pytest.mark.parametrize('seq', ['RzRyRx', 'RxRyRz', 'RyRzRx'])
def test_rotate_point_matches_jax(seq):
    pt = (1.5, -2.0, 0.7)
    ang = dict(pitch=0.3, roll=-0.2, yaw=0.1)
    np.testing.assert_allclose(
        [float(v) for v in tt.rotate_point(pt, seq, **ang)],
        [float(v) for v in jt.rotate_point(pt, seq, **ang)], rtol=1e-12)


@pytest.mark.parametrize('skip', [{}, dict(skip_xyz=True),
                                  dict(skip_abc=True)])
def test_azimuth_frames_match_jax(skip):
    j, t = _both(_rays(300, 9))
    center, az = (1.0, 2000.0, -3.0), 0.3
    kw = dict(sinAzimuth=math.sin(az), cosAzimuth=math.cos(az))
    jl = jt.global_to_virgin_local(j, center, **kw)
    tl = tt.global_to_virgin_local(t, center, **kw)
    _same(tl, jl, tol=1e-12)
    jg = jt.virgin_local_to_global(jl, center, **kw, **skip)
    tg = tt.virgin_local_to_global(tl, center, **kw, **skip)
    _same(tg, jg, tol=1e-12)
    if not skip:
        _same(tg, j, tol=1e-9)               # the round trip
    # azimuth 0 and no centre leave the beam as it is
    assert tt.global_to_virgin_local(t) is t
