"""The port's ray-surface intersection search against the JAX package's.

Identical rays (numpy, from a seed) in an element's local frame go through
``OE._bracket`` and ``find_intersection`` / ``find_intersection_dz`` of
both packages, for a flat, a spherical and a toroidal mirror.  The rays
come in at a grazing 4 mrad from ~10 m upstream; some start below the
surface (``lost``) and some leave the bracket before they cross it.

* float64 (JAX run eagerly under ``jax.disable_jit()``, so that XLA
  contracts nothing): the bracket to 1e-12 relative, ``t`` and the
  intersection points to 1e-9 mm, ``lost`` masks identical.  The sphere
  gets 1e-7 mm: z = R - sqrt(R^2 - x^2 - y^2) with R = 8.3e5 mm is known
  to one ulp of R, 1.2e-10 mm, which at 4 mrad is 2.9e-8 mm of t, and the
  two packages' Newton steps round it differently.
* float32 against the JAX float64 result on the same (float32-rounded)
  rays: ``t`` within 8 ulp of t (t ~ 1e4 mm has ulps of 9.8e-4 mm, and at
  4 mrad one ulp of the ray's height, 4e-6 mm, already moves the crossing
  by 1e-3 mm), ``lost`` identical.  The sphere is left out of the float32
  case: R - sqrt(R^2 - x^2 - y^2) in float32 is quantized to one ulp of R,
  0.06 mm at R = 8.3e5 mm, in both packages alike.
"""
import torch_harness  # noqa: F401

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from xrt_tpu.oes import (FlatMirror as JFlat, SphericalMirror as JSph,
                         ToroidMirror as JTor)
from xrt_tpu.oes import base as jbase
from xrt_tpu_torch.oes import FlatMirror, SphericalMirror, ToroidMirror
from xrt_tpu_torch.oes import base as tbase

P, Q, PITCH = 10000.0, 2000.0, 4e-3
LIM = dict(limPhysX=(-20, 20), limPhysY=(-300, 300))
R_MER = 2 * P * Q / (P + Q) / math.sin(PITCH)
R_SAG = 2 * P * Q / (P + Q) * math.sin(PITCH)
TOL_T = {'flat': 1e-9, 'spherical': 1e-7, 'toroid': 1e-9}     # mm
KINDS = {
    'flat': (JFlat, FlatMirror, {}),
    'spherical': (JSph, SphericalMirror, dict(R=R_MER)),
    'toroid': (JTor, ToroidMirror, dict(R=R_MER, r=R_SAG)),
}


def T(v):
    return torch.from_numpy(np.ascontiguousarray(v))


def local_rays(npdt, n=400, seed=0):
    """Rays in the mirror's local frame, aimed at its surface at a grazing
    angle of ~PITCH; the last tenth start below the surface."""
    rng = np.random.RandomState(seed)
    yhit = rng.uniform(-280, 280, n)
    xhit = rng.uniform(-3, 3, n)
    a = rng.normal(0, 3e-5, n)
    c = -math.sin(PITCH) + rng.normal(0, 3e-5, n)
    b = np.sqrt(1 - a ** 2 - c ** 2)
    L = P + rng.uniform(-1, 1, n)
    x, y, z = xhit - a * L, yhit - b * L, 0.5 - c * L
    z[-n // 10:] = -5.0 - c[-n // 10:] * L[-n // 10:] - 40.0
    return tuple(v.astype(npdt) for v in (x, y, z, a, b, c))


def make(kind):
    jcls, tcls, kw = KINDS[kind]
    return jcls.create(pitch=PITCH, **LIM, **kw), \
        tcls.create(pitch=PITCH, **LIM, **kw)


@pytest.mark.parametrize('kind', list(KINDS))
def test_bracket_matches_jax(kind):
    joe, toe = make(kind)
    rays = local_rays(np.float64)
    with jax.disable_jit():
        jt = joe._bracket(*(jnp.asarray(v) for v in rays), None)
    tt = toe._bracket(*(T(v) for v in rays))
    for g, r in zip(tt, jt):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)
    assert (tt[1] >= tt[0]).all()


@pytest.mark.parametrize('kind', list(KINDS))
def test_find_intersection_f64_matches_jax(kind):
    joe, toe = make(kind)
    rays = local_rays(np.float64)
    jr = tuple(jnp.asarray(v) for v in rays)
    tr = tuple(T(v) for v in rays)
    with jax.disable_jit():
        tMin, tMax = joe._bracket(*jr, None)
        ref = jbase.find_intersection(joe.local_z, tMin, tMax, *jr)
    got = tbase.find_intersection(toe.local_z, *toe._bracket(*tr), *tr)
    lost = np.asarray(ref[4])
    assert lost.sum() == rays[0].size // 10
    np.testing.assert_array_equal(got[4].numpy(), lost)
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL_T[kind])
    # the found points lie on the surface (rays that leave the bracket
    # above it come back at tMax)
    br = toe._bracket(*tr)
    hit = ~lost & (got[0] < br[1]).numpy()
    assert hit.sum() > rays[0].size // 2
    dz = (got[3] - toe.local_z(got[1], got[2])).numpy()[hit]
    assert np.abs(dz).max() < 1e-9


@pytest.mark.parametrize('kind', list(KINDS))
def test_find_intersection_dz_with_active_mask_matches_jax(kind):
    """The general form with a signed-distance function and an ``active``
    mask: inactive rays come back at tMax in both."""
    joe, toe = make(kind)
    rays = local_rays(np.float64, n=200, seed=1)
    active = np.arange(200) % 3 != 0
    jr = tuple(jnp.asarray(v) for v in rays)
    tr = tuple(T(v) for v in rays)
    with jax.disable_jit():
        tMin, tMax = joe._bracket(*jr, None)
        ref = jbase.find_intersection_dz(
            lambda x, y, z: z - joe.local_z(x, y), tMin, tMax, *jr,
            active=jnp.asarray(active))
    got = tbase.find_intersection_dz(
        lambda x, y, z: z - toe.local_z(x, y), *toe._bracket(*tr), *tr,
        active=T(active))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=TOL_T[kind])
    np.testing.assert_array_equal(got[0].numpy()[~active],
                                  np.asarray(tMax)[~active])


@pytest.mark.parametrize('kind', ['flat', 'toroid'])
def test_find_intersection_f32_within_ulps_of_t(kind):
    joe, toe = make(kind)
    rays = local_rays(np.float32)
    jr = tuple(jnp.asarray(v.astype(np.float64)) for v in rays)
    tr = tuple(T(v) for v in rays)
    with jax.disable_jit():
        tMin, tMax = joe._bracket(*jr, None)
        ref = jbase.find_intersection(joe.local_z, tMin, tMax, *jr)
    got = tbase.find_intersection(toe.local_z, *toe._bracket(*tr), *tr)
    assert got[0].dtype == torch.float32
    lost = np.asarray(ref[4])
    np.testing.assert_array_equal(got[4].numpy(), lost)
    t_ref = np.asarray(ref[0])[~lost]
    ulp = np.spacing(t_ref.astype(np.float32)).astype(np.float64)
    err = np.abs(got[0].numpy().astype(np.float64)[~lost] - t_ref) / ulp
    assert err.max() <= 8, err.max()


def test_search_converges_long_before_the_iteration_cap():
    """The relative bracket tolerance ends the float32 search: with the
    cap at 64 or at 20 the result is the same."""
    _, toe = make('toroid')
    tr = tuple(T(v) for v in local_rays(np.float32))
    br = toe._bracket(*tr)
    a = tbase.find_intersection(toe.local_z, *br, *tr)
    b = tbase.find_intersection(toe.local_z, *br, *tr, max_iterations=20)
    assert torch.equal(a[0], b[0])


def test_newton_polish_carries_the_gradient():
    """t is differentiable with respect to what the surface depends on:
    for a flat surface at height h, dt/dh = 1 / c."""
    rays = tuple(T(v) for v in local_rays(np.float64, n=50))
    x, y, z, a, b, c = rays
    h = torch.zeros((), dtype=torch.float64, requires_grad=True)
    _, toe = make('flat')
    tMin, tMax = toe._bracket(*rays)
    t, _, _, _, lost = tbase.find_intersection(lambda xx, yy: h + 0 * xx,
                                               tMin, tMax, *rays)
    hit = ~lost & (t < tMax)
    assert hit.sum() > 20
    g, = torch.autograd.grad(t[hit].sum(), h)
    np.testing.assert_allclose(float(g), float((1 / c[hit]).sum()),
                               rtol=1e-9)
