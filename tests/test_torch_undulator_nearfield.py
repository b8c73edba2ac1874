"""The port's tapered and near-field undulator integrals and the quadrature
search against the JAX package, float64.

* ``build_I_map`` of a tapered (``taper=(1.09, 11.0)``) and a near-field
  (``R0=5000``) undulator on ``ref_undulator.npz``'s grid: against the JAX
  function under ``jit`` to 1e-9 of each output's largest magnitude; in
  the near field the amplitudes' common phase is left out (|Es|, |Ep| and
  Es Ep* are held): XLA rounds the per-ray carrier phase w / wu * R0n ~
  2e11 rad otherwise, and one ulp of it is 3e-5 rad (run eagerly, the JAX
  package agrees to 1e-15 there too); and against the golden's
  ``undt_*`` / ``undn_*`` maps at
  ``tests/test_undulator.py``'s limits (the near-field amplitudes up to
  the per-energy global phase that test removes).
* ``Undulator.create(gNodes=None)``: the quadrature search picks the same
  node count as ``with_converged_grid`` of the JAX package, at ``gp=1e-4``
  (``tests/test_undulator.py``'s source).
* BASELINE configuration 3 as named: the undulator of
  ``tests/test_baseline_configs.py`` in the near field at the DCM's 30 m,
  3000 rays (one candidate a ray: the integral runs 111 periods, and the
  JAX package's takes ~20 s for the default four), through the Si(111) DCM
  on the JAX package's draws (JAX under ``jit``, in a subprocess of one
  XLA thread): the exit beam to 1e-9, and the JAX test's limits (band < 10
  eV, the fixed exit parallel to 1e-9).
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
from xrt_tpu.sources import Undulator as JUndulator
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch.oes import DCM
from xrt_tpu_torch.sources import Undulator
from test_torch_wave_hops import UND, und_draws

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
CPU = dict(dtype=torch.float64, device='cpu')
E0 = 9000.0
#: the source of tests/test_undulator.py
GOLDEN_UND = dict(nrays=1000, eE=6.0, eI=0.1, eEpsilonX=0.0, eEpsilonZ=0.0,
                  period=33.0, n=50, K=1.5, eMin=9000, eMax=9600,
                  xPrimeMax=0.02, zPrimeMax=0.02, gNodes=400, gIntervals=2)
CASES = {'taper': dict(n=10, gNodes=120, taper=(1.09, 11.0)),
         'nearfield': dict(n=10, gNodes=120, R0=5000.0)}


@pytest.fixture(scope='module')
def ref():
    return np.load(os.path.join(GOLDEN, 'ref_undulator.npz'))


def rel(t, j):
    t, j = t.numpy(), np.asarray(j)
    return float(np.abs(t - j).max() / np.abs(j).max())


@pytest.mark.parametrize('case', sorted(CASES))
def test_map_matches_jax_and_golden(ref, case):
    args = dict(GOLDEN_UND, **CASES[case])
    t = Undulator.create(**args, **CPU)
    j = JUndulator.create(**args)
    if case == 'taper':
        assert t.taper_val == pytest.approx(float(ref['undt_taperVal']),
                                            rel=1e-15)
        assert t.taper_val == j.taper_val
    assert (t.xPrimeMax, t.zPrimeMax) == (j.xPrimeMax, j.zPrimeMax)
    E, th, ps = ref['und_E'], ref['und_theta'], ref['und_psi']
    got = t.build_I_map(None, *(torch.from_numpy(v) for v in (E, th, ps)))
    want = jax.jit(j.build_I_map)(jax.random.PRNGKey(0),
                                  *(jnp.asarray(v) for v in (E, th, ps)))
    if case == 'taper':
        for g, w in zip(got, want):
            assert rel(g, w) < 1e-9
    else:
        (gI, gs, gp), (wI, ws, wp) = got, want
        for g, w in ((gI, wI), (gs.abs(), jnp.abs(ws)),
                     (gp.abs(), jnp.abs(wp)),
                     (gs * gp.conj(), ws * jnp.conj(wp))):
            assert rel(g, w) < 1e-9
    I, Es, Ep = (v.numpy() for v in got)
    if case == 'taper':
        np.testing.assert_allclose(I, ref['undt_I'], rtol=1e-6, atol=1e-3)
        np.testing.assert_allclose(Es, ref['undt_Es'], rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(Ep, ref['undt_Ep'], rtol=1e-6,
                                   atol=1e-8)
        return
    np.testing.assert_allclose(I, ref['undn_I'], rtol=1e-5, atol=1e-3)
    # xrt's vector and scalar near-field paths differ by a per-energy
    # global phase, as tests/test_undulator.py notes
    phase = np.ones_like(Es)
    for e in np.unique(E):
        sel = E == e
        zr = ref['undn_Es'][sel][0] / Es[sel][0]
        phase[sel] = zr / np.abs(zr)
    np.testing.assert_allclose(Es * phase, ref['undn_Es'], rtol=1e-5,
                               atol=1e4)
    np.testing.assert_allclose(Ep * phase, ref['undn_Ep'], rtol=1e-5,
                               atol=1e4)


def test_search_picks_the_jax_quadm():
    args = dict(GOLDEN_UND, gNodes=None, gp=1e-4)
    t = Undulator.create(**args, **CPU)
    j = JUndulator.create(**args)
    assert t.quadm == j.quadm
    np.testing.assert_array_equal(t.tg, np.asarray(j.tg))
    np.testing.assert_array_equal(t.ag, np.asarray(j.ag))


JAX_CONFIG3 = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', True)
import xrt_tpu.materials as jm
from xrt_tpu.oes.dcm import DCM
from xrt_tpu.sources import Undulator
und = Undulator.create(**KW)
dcm = DCM.create(material=jm.CrystalSi.create(hkl=(1, 1, 1)), **DCM_KW)
mono = jax.jit(lambda k: dcm.double_reflect(und.shine(k))[0])(
    jax.random.PRNGKey(2))
np.savez(OUT, **{f: np.asarray(getattr(mono, f)) for f in FIELDS})
print('OK')
'''


def test_nearfield_config3_through_the_dcm_matches_jax(tmp_path):
    kw = dict(UND, nrays=3000, eMin=E0 - 40, eMax=E0 + 40, R0=30000.0,
              oversample=1)
    dcm_kw = dict(center=(0, 30000.0, 0), alignE=E0, fixedOffset=20.0,
                  limPhysX=(-50, 50), limPhysY=(-500, 500))
    fields = ('state', 'x', 'z', 'a', 'b', 'c', 'E', 'Jss', 'Jpp')
    # the JAX package's 111-period scan in a process of one XLA thread:
    # in the test run's own process it competes with the other workers'
    # thread pools (15 s alone, minutes among six workers)
    code = (f'KW = {kw!r}\nDCM_KW = {dcm_kw!r}\nFIELDS = {fields!r}\n'
            f'OUT = {str(tmp_path / "mono.npz")!r}\n' + JAX_CONFIG3)
    env = dict(CLEAN_ENV, XLA_FLAGS='--xla_cpu_multi_thread_eigen=false '
               'intra_op_parallelism_threads=1')
    proc = subprocess.Popen([sys.executable, '-c', code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    key = jax.random.PRNGKey(2)
    und = Undulator.create(**kw, **CPU)
    assert und.R0 == 30000.0
    dcm = DCM.create(material=tm.CrystalSi.create(hkl=(1, 1, 1), **CPU),
                     **dcm_kw)
    beam = und.shine(None, draws=und_draws(key, 3000, 3000))
    mono = dcm.double_reflect(beam)[0]
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and 'OK' in out, err
    jmono = np.load(tmp_path / 'mono.npz')
    np.testing.assert_array_equal(mono.state.numpy(), jmono['state'])
    for f in fields[1:]:
        t, j = getattr(mono, f).numpy(), jmono[f]
        scale = max(float(np.abs(j).max()), 1.0 if f in 'xz' else 1e-300)
        assert np.abs(t - j).max() / scale < 1e-9, f
    I = (mono.Jss + mono.Jpp).numpy()
    good = (mono.state.numpy() == 1) & (I > 1e-3 * I.max())
    assert good.sum() > 100
    E = mono.E.numpy()
    assert np.sqrt(np.cov(E[good], aweights=I[good])) < 10.0
    np.testing.assert_allclose(mono.b.numpy()[good], beam.b.numpy()[good],
                               atol=1e-9)
