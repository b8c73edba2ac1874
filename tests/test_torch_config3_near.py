"""The benchmark's cell ``config3.near`` (BASELINE configuration 3 in the
near field) on the CPU at a small size: the plain float64 reference of
``beambench/references/config3.py`` held to xrt's near-field maps
(``tests/golden/ref_undulator.npz``) and to the port's Si(111)
amplitudes; the DCM's span and the near-field node counter; tiny runs of
the cell through ``beambench/run.py`` and ``beambench/calibrate.py``
against the reference, and the float32 control that fails it.

The tiny runs cut the source to :data:`TINY_PERIODS` periods and
:data:`NRAYS` rays (the configuration's 111 periods cost ~5 s a thousand
rays on one CPU thread); everything else is the cell's.  The seed draws
the first pass of the window as the checked one, so a window of one pass
suffices on a slow host.  Imports nothing of the JAX package.
"""
import torch_harness  # noqa: F401

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from xrt_tpu_torch import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, 'beambench')
sys.path.insert(0, BENCH)
import harness  # noqa: E402

CELL = 'config3.near'
SEED = 3000000232
NRAYS = 1000
TINY_PERIODS = 5
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'ref_undulator.npz')
#: tests/test_undulator.py's near-field source: the golden maps' source
GOLDEN_UND = dict(eE=6.0, eI=0.1, period=33.0, n=10, K=1.5, R0=5000.0)


def _tiny():
    """The configuration's overrides of the tiny runs."""
    cfg = harness.load_json('configs', 'config3.json')
    return dict(nrays=NRAYS, undulator=dict(cfg['undulator'],
                                            n=TINY_PERIODS))


def _cfg(dtype='float64'):
    return dict(harness.load_json('configs', 'config3.json'), **_tiny(),
                dtype=dtype)


def _ref():
    return harness.load_module('references', 'config3')


def test_the_configuration_is_baseline_configuration_3():
    """The file states float64, R0 = 30 m, the 111 periods, the pinned
    grid with its converged count, nothing reduced; the port builds the
    source in the near field with the reference's K and acceptance."""
    cfg = harness.load_json('configs', 'config3.json')
    u = cfg['undulator']
    assert cfg['dtype'] == 'float64' and cfg['reduced'] == []
    assert (u['R0'], u['n'], u['gNodes'], u['gIntervals']) == \
        (30000.0, 111, 64, 2)
    assert 'gNodes_converged' in u
    drv = harness.load_module('configs', 'config3')
    src, dcm, scr = drv.build(dict(cfg, nrays=NRAYS), 'cpu')
    s = _ref().source(cfg)
    assert src.R0 == 30000.0 and src._node_copies() == 111
    assert float(src.Ky) == pytest.approx(s['K'], rel=1e-14)
    assert src.Theta_max == pytest.approx(s['theta'][1], rel=1e-14)
    assert src.Psi_max == pytest.approx(s['psi'][1], rel=1e-14)
    assert dcm.material.d.dtype == torch.float64


def test_reference_near_field_maps_against_xrts():
    """The reference's near-field integral at the golden maps' source and
    (E, theta, psi) against xrt's ``undn_*`` maps, at
    ``tests/test_undulator.py``'s limits (the amplitudes up to one phase
    an energy: xrt's vector and scalar paths differ by a constant carrier
    phase)."""
    ref = _ref()
    gold = np.load(GOLDEN)
    u = GOLDEN_UND
    gamma = u['eE'] * 1e9 * ref.EV2ERG / (ref.M0 * ref.C ** 2)
    g2 = gamma * gamma
    s = dict(gamma=gamma, K=u['K'], L0=u['period'], Np=u['n'], eI=u['eI'],
             R0=u['R0'], wu=math.pi / u['period'] / g2 *
             (2 * g2 - 1 - 0.5 * u['K'] ** 2) / ref.E2WC)
    E, th, ps = (torch.as_tensor(gold[k]) for k in ('und_E', 'und_theta',
                                                    'und_psi'))
    I, Es, Ep = (v.numpy() for v in ref.amplitudes(s, E, th, ps))
    np.testing.assert_allclose(I, gold['undn_I'], rtol=1e-5, atol=1e-3)
    phase = np.ones_like(Es)
    for e in np.unique(gold['und_E']):
        sel = gold['und_E'] == e
        zr = gold['undn_Es'][sel][0] / Es[sel][0]
        phase[sel] = zr / abs(zr)
    np.testing.assert_allclose(Es * phase, gold['undn_Es'], rtol=1e-5,
                               atol=1e4)
    np.testing.assert_allclose(Ep * phase, gold['undn_Ep'], rtol=1e-5,
                               atol=1e4)


def test_reference_si111_against_the_ports_materials():
    """The reference's Si(111): the DCM's Bragg angle at 9000 eV as the
    port aligns it, and the susceptibilities and thick-Bragg amplitudes
    of the port's ``CrystalSi`` over the cell's band, at 1e-12 in
    float64."""
    from xrt_tpu_torch.materials import CrystalSi
    ref = _ref()
    cfg = harness.load_json('configs', 'config3.json')
    drv = harness.load_module('configs', 'config3')
    _, dcm, _ = drv.build(dict(cfg, nrays=NRAYS), 'cpu')
    si = ref.SiCrystal((1, 1, 1))
    assert si.bragg(9000.0) == pytest.approx(float(dcm.braggAngle),
                                             abs=1e-15)
    cr = CrystalSi.create(hkl=(1, 1, 1), dtype=torch.float64, device='cpu')
    assert si.d == pytest.approx(float(cr.d), rel=1e-15)
    g = torch.Generator().manual_seed(5)
    E = 8960 + 80 * torch.rand(2000, generator=g, dtype=torch.float64)
    th = si.bragg(9000.0) + 1e-4 * (torch.rand(
        2000, generator=g, dtype=torch.float64) - 0.5)
    inSN = -torch.sin(th)
    got = si.chi(E)
    want = cr.get_F_chi(E, 0.5 / cr.d)[3:]
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-12
    got = si.amplitude(E, inSN, -inSN, inSN)
    want = cr.get_amplitude(E, inSN, -inSN, inSN)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) < 1e-12
        assert float(b.abs().max()) > 0.9     # the band holds the peak


def test_near_evals_counter_and_one_dcm_span_a_pass():
    """While tracing, a pass of the cell (shine, the DCM, expose) counts
    ``integral.near_evals`` = candidates x nodes of nonzero weight x Np
    beside ``integral.node_evals``, and is one ``oes.double_reflect`` span
    holding both crystals' ``oes.interact`` spans; a far-field source
    counts no near evaluation."""
    drv = harness.load_module('configs', 'config3')
    cfg = _cfg()
    src, dcm, scr = drv.build(cfg, 'cpu')
    nodes = int(np.count_nonzero(src.ag))
    assert nodes == 128
    profiler.reset()
    try:
        with profiler.tracing():
            for _ in range(2):
                profiler.next_pass()
                g = torch.Generator().manual_seed(1)
                scr.expose(dcm.double_reflect(src.shine(g), g)[0])
            profiler.next_pass()
            src.replace(R0=None).shine(torch.Generator().manual_seed(1))
        spans = profiler.spans()
        counters = profiler.counters()
    finally:
        profiler.reset()
    M = NRAYS * 4
    c1, c2, far = (counters[p] for p in sorted(counters))
    for c in (c1, c2):
        assert c['integral.near_evals'] == M * nodes * TINY_PERIODS
        assert c['integral.node_evals'] == c['integral.near_evals']
    assert 'integral.near_evals' not in far
    assert far['integral.node_evals'] == M * nodes
    dr = [s for s in spans if s.name == 'oes.double_reflect']
    assert len(dr) == 2 and len({s.pass_id for s in dr}) == 2
    assert all(s.ok and s.device_ns is not None for s in dr)
    inner = [s for s in spans if s.name == 'oes.interact']
    assert len(inner) == 4
    assert {s.parent for s in inner} == {s.id for s in dr}


def test_double_reflect_returns_as_before():
    """The DCM's span leaves its results as they were: needLocal gives the
    two local beams, without it the global beam alone."""
    drv = harness.load_module('configs', 'config3')
    src, dcm, _ = drv.build(_cfg(), 'cpu')
    beam = src.shine(torch.Generator().manual_seed(2))
    glo, lo1, lo2 = dcm.double_reflect(beam)
    alone = dcm.double_reflect(beam, needLocal=False)
    for k in ('x', 'y', 'z', 'a', 'b', 'c', 'Jss', 'Jpp', 'state'):
        assert torch.equal(getattr(glo, k), getattr(alone, k))
    assert lo1.x.shape == lo2.x.shape == beam.x.shape
    # fixed exit: the rays leave parallel to how they came, 20 mm higher
    good = glo.state == 1
    assert float((glo.b - beam.b)[good].abs().max()) < 1e-12


def _tiny_run(trace):
    """The result line of ``beambench/run.py`` on the cell at the tiny size
    on the CPU, in a process of its own."""
    out = subprocess.run(
        [sys.executable, '-c', _RUN, BENCH, CELL, str(SEED),
         json.dumps(_tiny()), str(trace)], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['code'] == 0 and res['loaded'] == []
    return res['out']


_RUN = '''
import json, sys
sys.path.insert(0, sys.argv[1])
import harness, run
code, out = run.run(['--workload', sys.argv[2], '--seed', sys.argv[3],
                     '--seconds', '1', '--trace', sys.argv[5]], device='cpu',
                    chip_check=False, overrides=json.loads(sys.argv[4]))
print(json.dumps(dict(code=code, out=out,
                      loaded=harness.forbidden_modules())))
'''


def test_a_tiny_run_of_the_cell_is_correct():
    """``beambench/run.py`` on the CPU: a result that is correct, with the
    cell's end-to-end metrics, and nothing of the JAX package loaded."""
    r = _tiny_run(trace=0)
    assert r['correct'], r['checks']
    assert r['attempted'] >= 1 and r['failed'] == 0
    assert {'rays_per_s', 'setup_s'} <= set(r['metrics'])
    assert set(r['checks']) == {'flux_err', 'index_off', 'pol_err',
                                'dcm_err', 'ray_err', 'hist_err'}


def test_a_traced_tiny_run_reads_the_near_field_metrics():
    """``beambench/run.py --trace 1`` on the CPU: the near field's
    roofline share within (0, 100], the DCM's and the integral's spans a
    positive number of ms, the runner's own time too (the device's shares
    need a card)."""
    r = _tiny_run(trace=1)
    assert r['correct'], r['checks']
    m = {k: v['value'] for k, v in r['metrics'].items()}
    names = ('nf.integral_roofline', 'nf.dcm_ms', 'und.integral_ms',
             'und.shine_ms', 'trace.runner_self_ms')
    assert set(names) <= set(m), m
    assert 0 < m['nf.integral_roofline'] <= 100
    assert all(m[k] > 0 for k in names)
    assert m['nf.dcm_ms'] < m['und.shine_ms']


def test_the_float32_control_is_not_correct():
    """The cell's set-up, window and check at the tiny size on the CPU:
    the program's readings within the limits, the reference in float32 in
    the program's place outside at least one of them."""
    import calibrate
    cell = harness.load_json('workloads', CELL + '.json')
    limits = cell['check']['limits']
    t = time.perf_counter()
    r = calibrate.readings(CELL, SEED, 0.5, True, device='cpu',
                           overrides=_tiny())
    assert time.perf_counter() - t < 300
    assert all(r['program'][k] <= v for k, v in limits.items()), r
    ctl = r['control']
    assert any(ctl[k] > v for k, v in limits.items()), ctl


def test_the_reference_imports_nothing_of_the_program():
    """``references/config3.py`` and the helpers it loads import neither
    the port nor the JAX package, and nothing else of the tree."""
    code = ('import sys; sys.path.insert(0, sys.argv[1]); import harness; '
            'harness.load_module("references", "config3"); '
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("xrt_tpu", "xrt_tpu_torch", "jax", "jaxlib")))')
    out = subprocess.run([sys.executable, '-c', code, BENCH],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == '[]'
