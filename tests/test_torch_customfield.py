"""The port's ``SourceFromField`` against the JAX package and xrt's golden
data.

* The four tests of ``tests/test_customfield.py`` on the port, at their
  tolerances (the golden maps at rtol 2e-4, the near field at R0 = 1e7 mm
  against the far-field golden at 2e-3, a shine of 2000 rays: the
  reference test's 5000 cut, since its checks do not depend on the
  count and the integral is 6016 nodes a candidate on the CPU).
* ``create`` on its own periodic test field (``customField=None``, 5
  periods, 200 nodes): the node arrays (the RK4 trajectory interpolated
  onto the Clenshaw-Curtis nodes), betam and the device length to 1e-12
  (host float64 numpy and scipy in both: they are equal bit for bit).
* On the 5-period field, ``build_I_map`` in the far field and at R0 =
  5000 mm against the JAX package run eagerly (``jax.disable_jit()``), to
  1e-9 of each output's largest magnitude: under ``jit`` XLA contracts the
  oscillatory sum otherwise (1.1e-7 on this field; the 41-period golden
  maps move by ~1e-5).  ``shine`` on the JAX package's draws (JAX under
  ``jit``): the rays' positions, directions and energies to 1e-9, their
  coherency matrix, a ratio of the map's amplitudes, to 1e-6.
* Float32 on example 22's infrared edge radiation (two dipoles, 0.124 eV,
  R0 = 2500 mm; 15 x 15 pixels, 600 nodes x 6 intervals): the port's
  float32 map within 5e-2 of the largest value of its float64 one (3.07e-2
  measured), and no farther from it than the JAX package's float32 map
  (run in a subprocess with x64 off) plus 1e-3.  At x-ray energies neither
  package's float32 keeps a digit (ROADMAP C22).
"""
import torch_harness  # noqa: F401

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import CLEAN_ENV
from xrt_tpu.physconsts import CH, K2B
from xrt_tpu.sources import SourceFromField as JSFF
from xrt_tpu_torch.sources import SourceFromField
from xrt_tpu_torch.sources import customfield as tcf
from test_torch_wave_hops import und_draws

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
CPU = dict(dtype=torch.float64, device='cpu')
K, L0, NP = 4.4, 53.96, 41
SFF = dict(nrays=100, eE=6.0, eI=0.1, eEpsilonX=0.0, eEpsilonZ=0.0,
           eMin=5000, eMax=6500, xPrimeMax=0.05, zPrimeMax=0.05,
           gNodes=3000, gIntervals=2)
#: create's periodic test field, 5 periods
SMALL = dict(SFF, customField=None, K=K, period=L0, n=5, gNodes=200)
#: examples/22_edge_radiation.py at its smoke sizes
IR_E0, IR_R0, IR_NPT = CH / 1e5, 2500.0, 15
IR = dict(nrays=100, eE=2.75, eI=0.5, eEpsilonX=0.0, eEpsilonZ=0.0,
          eMin=IR_E0 * 0.98, eMax=IR_E0 * 1.02, xPrimeMax=15.0,
          zPrimeMax=15.0, gNodes=600, gIntervals=6, R0=IR_R0)


def periodic_field():
    zg = np.linspace(-L0 * NP * 0.5, L0 * NP * 0.5, 1000 * NP)
    return np.vstack([zg, K2B * K / L0 * np.sin(2 * np.pi * zg / L0)]).T


def two_dipole_field():
    """examples/22_edge_radiation.py's field: four edges of two dipoles."""
    B0, LBM, LS, W = 1.4, 600.0, 300.0, 20.0
    y = np.linspace(-(LS / 2 + LBM + 150), LS / 2 + LBM + 150, 8000)

    def edge(y0):
        return 0.5 * (1 + np.tanh((y - y0) / W))
    By = B0 * (edge(-LS / 2 - LBM) - edge(-LS / 2) + edge(LS / 2) -
               edge(LS / 2 + LBM))
    return np.vstack([y, By]).T


def ir_angles():
    xs = np.linspace(-20.0, 20.0, IR_NPT)
    th, ps = np.meshgrid(np.arctan(xs / IR_R0), np.arctan(xs / IR_R0),
                         indexing='ij')
    return np.full(th.size, IR_E0), th.ravel(), ps.ravel()


@pytest.fixture(scope='module')
def sff():
    return SourceFromField.create(customField=periodic_field(), **SFF,
                                  **CPU)


@pytest.fixture(scope='module')
def small():
    return SourceFromField.create(**SMALL, **CPU), JSFF.create(**SMALL)


@pytest.fixture(scope='module')
def ref():
    return np.load(os.path.join(GOLDEN, 'ref_customfield.npz'))


def T(*arrays, dtype=torch.float64):
    return tuple(torch.as_tensor(a, dtype=dtype) for a in arrays)


def golden_args(g):
    return g['sff_E'], g['sff_theta'], g['sff_psi']


def test_customfield_intensity_map(sff, ref):
    assert 2100 < sff.deviceLength < 2250
    I, Es, Ep = (v.numpy() for v in sff.build_I_map(
        None, *T(*golden_args(ref))))
    np.testing.assert_allclose(I, ref['sff_I'], rtol=2e-4)
    np.testing.assert_allclose(Es, ref['sff_Es'], rtol=2e-4, atol=1e-8)
    np.testing.assert_allclose(Ep, ref['sff_Ep'], rtol=2e-4, atol=1e-8)


def test_customfield_shine(sff):
    beam = sff.replace(nrays=2000, oversample=2).shine(
        torch.Generator().manual_seed(1))
    assert int(beam.state.sum()) == 2000
    E = beam.E.numpy()
    assert (E >= 5000).all() and (E <= 6500).all()
    assert np.isfinite(beam.Jss.numpy()).all()
    assert float(beam.accepted) > 0


def test_customfield_near_field_far_limit(sff, ref):
    I_nf = sff.replace(R0=1e7).build_I_map(None,
                                           *T(*golden_args(ref)))[0]
    np.testing.assert_allclose(I_nf.numpy(), ref['sff_I'], rtol=2e-3)


def test_customfield_near_field_golden(sff):
    g = np.load(os.path.join(GOLDEN, 'ref_customfield_nf.npz'))
    I, Es, Ep = (v.numpy() for v in sff.replace(
        R0=float(g['R0'])).build_I_map(None, *T(*golden_args(g))))
    np.testing.assert_allclose(I, g['sff_I'], rtol=2e-4)
    np.testing.assert_allclose(Es, g['sff_Es'], rtol=2e-4, atol=1e-8)
    np.testing.assert_allclose(Ep, g['sff_Ep'], rtol=2e-4, atol=1e-8)


def test_create_matches_jax(small):
    t, j = small
    for name in tcf.NODE_ARRAYS:
        tv, jv = getattr(t, name), np.asarray(getattr(j, name))
        assert tv.shape == jv.shape and tv.shape[0] % 64 == 0, name
        np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=1e-300,
                                   err_msg=name)
    for name in ('betam', 'dstep', 'deviceLength', 'quadm', 'gIntervals',
                 'xPrimeMax', 'Theta_max', 'xzE'):
        assert getattr(t, name) == pytest.approx(
            float(getattr(j, name)), rel=1e-12), name


@pytest.mark.parametrize('R0', [None, 5000.0], ids=['far', 'near'])
def test_build_I_map_matches_jax(small, ref, R0):
    t, j = small
    got = t.replace(R0=R0).build_I_map(None, *T(*golden_args(ref)))
    with jax.disable_jit():
        want = j.replace(R0=R0).build_I_map(
            jax.random.PRNGKey(0),
            *(jnp.asarray(v) for v in golden_args(ref)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() / np.abs(w).max() < 1e-9


def test_shine_matches_jax(small):
    n, M = 300, 600
    t, j = (s.replace(nrays=n, oversample=2) for s in small)
    key = jax.random.PRNGKey(3)
    jb = jax.jit(j.shine)(key)
    tb = t.shine(None, draws=und_draws(key, n, M))
    np.testing.assert_array_equal(tb.state.numpy(), np.asarray(jb.state))
    for f, lim in (('x', 1e-9), ('z', 1e-9), ('a', 1e-9), ('b', 1e-9),
                   ('c', 1e-9), ('E', 1e-9), ('Jss', 1e-6), ('Jpp', 1e-6),
                   ('Jsp', 1e-6)):
        tv, jv = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        scale = max(float(np.abs(jv).max()), 1e-300)
        assert np.abs(tv - jv).max() / scale < lim, f
    assert float(tb.accepted) == pytest.approx(float(jb.accepted),
                                               rel=1e-6)


JAX_F32 = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
from xrt_tpu.sources import SourceFromField
a = np.load(IN)
src = SourceFromField.create(customField=a['field'], **ARGS)
I = src.build_I_map(jax.random.PRNGKey(0), jnp.asarray(a['E'], jnp.float32),
                    jnp.asarray(a['th'], jnp.float32),
                    jnp.asarray(a['ps'], jnp.float32))[0]
np.save(OUT, np.asarray(I))
print('OK')
'''


def test_ir_near_field_f32_beside_jax_f32(tmp_path):
    field = two_dipole_field()
    E, th, ps = ir_angles()
    np.savez(tmp_path / 'in.npz', field=field, E=E, th=th, ps=ps)
    code = (f'IN = {str(tmp_path / "in.npz")!r}\n'
            f'OUT = {str(tmp_path / "out.npy")!r}\nARGS = {IR!r}\n'
            + JAX_F32)
    # the JAX package's float32 map in a clean process, run beside the
    # port's maps
    proc = subprocess.Popen([sys.executable, '-c', code], env=CLEAN_ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    # the node arrays are host float64: one source serves both dtypes
    src = SourceFromField.create(customField=field, **IR, **CPU)
    I = {dt: src.build_I_map(None, *T(E, th, ps, dtype=dt))[0].double()
         for dt in (torch.float32, torch.float64)}
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and 'OK' in out, err
    jI = np.load(tmp_path / 'out.npy')
    ref = I[torch.float64].numpy()
    scale = np.abs(ref).max()
    port = np.abs(I[torch.float32].numpy() - ref).max() / scale
    jax32 = np.abs(jI - ref).max() / scale
    print(f'float32 against float64: port {port:.3e}, JAX {jax32:.3e}')
    assert port < 5e-2, (port, jax32)
    assert port <= jax32 + 1e-3, (port, jax32)
