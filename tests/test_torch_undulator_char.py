"""The benchmark's undulator cell (xrt speed test 2) on the CPU at a small
size: the port's ray-mode ``Undulator.shine`` at the speed test's
parameters (2000 rays, 8000 candidates) with injected draws against the
plain float64 reference of ``beambench/references/undulator.py``; the
spans and counters of the shine and its radiation integral; and a tiny run
of the cell through ``beambench/run.py`` and its bfloat16 control.

The seed draws the first pass of the window as the checked one, so a
window of one pass suffices on a slow host.  Imports nothing of the JAX
package.
"""
import torch_harness  # noqa: F401

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from xrt_tpu_torch import profiler
from xrt_tpu_torch.sources import undulator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, 'beambench')
sys.path.insert(0, BENCH)
import harness  # noqa: E402

CELL = 'undulator.char'
SEED = 3000000232
NRAYS = 2000


def _cfg(dtype, gNodes=None):
    """The configuration at NRAYS rays, in *dtype*, at *gNodes* nodes (the
    pinned 402 if None)."""
    cfg = harness.load_json('configs', 'undulator.json')
    u = dict(cfg['undulator'])
    if gNodes:
        u['gNodes'] = gNodes
    return dict(cfg, nrays=NRAYS, dtype=dtype, undulator=u)


def _pass(cfg, seed=SEED):
    """One shine and expose of the configuration's source on injected
    draws: the source, the draws, the source beam and the screen beam."""
    drv = harness.load_module('configs', 'undulator')
    src, screen = drv.build(cfg, 'cpu')
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg['dtype'])
    draws = src._draws(gen, None, dt, torch.device('cpu'),
                       src.nrays * src.oversample, src.nrays)
    beam = src.shine(gen, draws=draws)
    return src, draws, beam, screen.expose(beam)


def test_shine_float64_matches_the_reference_ray_by_ray():
    """At the pinned 402 x 2 nodes the port's float64 shine is the float64
    reference's to ~1e-13: every ray takes the reference's candidate, and
    each field is within 1e-9 of its peak."""
    cfg = _cfg('float64')
    ref = harness.load_module('references', 'undulator')
    src, draws, beam, scr = _pass(cfg)
    want = ref.shine(cfg, draws)
    assert src.nrays * src.oversample == draws['E'].shape[0] == 4 * NRAYS
    got = dict(E=beam.E, a=beam.a, b=beam.b, c=beam.c, x=beam.x, z=beam.z,
               Jss=beam.Jss, Jpp=beam.Jpp, Jsp=torch.abs(beam.Jsp),
               sx=scr.x, sz=scr.z)
    for k, v in got.items():
        w = want[k]
        assert v.dtype == torch.float64
        peak = float(torch.max(torch.abs(w)))
        assert float(torch.max(torch.abs(v - w))) <= 1e-9 * peak, k
    assert float(beam.accepted) == pytest.approx(want['accepted'],
                                                 rel=1e-9)
    assert torch.all(beam.state == 1) and torch.all(beam.y == 0)


@pytest.mark.parametrize('gNodes', [64, 402])
def test_shine_float32_within_the_cells_limits(gNodes):
    """The float32 shine, exposed and histogrammed as the cell does,
    reads within every limit of the cell against the float64 reference,
    at 64 x 2 nodes too (converged there to ~1e-13 of the flux; at 32 x
    2 the quadrature alone is ~3e-5 off)."""
    from xrt_tpu_torch.runner import run_ray_tracing
    cell = harness.load_json('workloads', CELL + '.json')
    cfg = _cfg('float32', gNodes)
    drv = harness.load_module('configs', 'undulator')
    ref = harness.load_module('references', 'undulator')
    src, draws, beam, scr = _pass(cfg)
    assert beam.E.dtype == torch.float32
    plot = drv.make_plot(cfg)
    before = drv._totals(plot)
    run_ray_tracing([plot], repeats=1, run_process=lambda bl, g: {
        'screen': scr}, rng=torch.Generator().manual_seed(0))
    kept = dict(
        draws=draws, before=before, after=drv._totals(plot),
        limits=(tuple(plot.xaxis.limits), tuple(plot.yaxis.limits),
                tuple(plot.caxis.limits)),
        source={k: getattr(beam, k) for k in (
            'E', 'a', 'b', 'c', 'Jss', 'Jpp', 'Jsp', 'accepted')},
        screen={k: getattr(scr, k) for k in ('x', 'z', 'E', 'Jss',
                                             'state')})
    got = ref.compare(cfg, kept)
    assert float(np.sum(plot.total2D)) > 0
    for k, limit in cell['check']['limits'].items():
        assert got[k] <= limit, (k, got[k])


def test_spans_and_node_counter_of_a_shine(monkeypatch):
    """While tracing, a shine is one ``sources.shine`` span holding one
    ``sources.integrate`` span a ray block, and ``integral.node_evals``
    counts candidates x nodes of nonzero weight: 8000 candidates in
    blocks of 3000 (the last a partial one) at 32 x 2 nodes padded to
    64."""
    monkeypatch.setattr(undulator, 'RAY_BLOCK', 3000)
    cfg = _cfg('float32', 32)
    drv = harness.load_module('configs', 'undulator')
    src, _ = drv.build(cfg, 'cpu')
    assert len(src.ag) == 64 and np.count_nonzero(src.ag) == 64
    src = src.with_grid(30, 2)      # 60 nodes, padded with 4 zero weights
    assert len(src.ag) == 64 and np.count_nonzero(src.ag) == 60
    profiler.reset()
    try:
        src.shine(torch.Generator().manual_seed(1))
        assert profiler.spans() == [] and profiler.counters() == {}
        with profiler.tracing():
            profiler.next_pass()
            src.shine(torch.Generator().manual_seed(1))
        spans = profiler.spans()
        counters = profiler.counters()
    finally:
        profiler.reset()
    outer = [s for s in spans if s.name == 'sources.shine']
    inner = [s for s in spans if s.name == 'sources.integrate']
    assert len(outer) == 1 and len(inner) == 3
    assert all(s.parent == outer[0].id and s.ok for s in inner)
    assert all(s.device_ns is not None for s in outer + inner)
    (c,) = counters.values()
    assert c['integral.calls'] == 3
    assert c['integral.node_evals'] == 4 * NRAYS * 60


def test_the_published_candidates_are_one_ray_block(monkeypatch):
    """At the speed test's own size (1e5 rays, 4e5 candidates, 402 x 2
    nodes) a shine integrates its candidates in one block: one
    ``sources.integrate`` span of 4e5 x 804 node evaluations (the
    integral itself stubbed out, the blocking and the counting kept)."""
    def stub(self, ww1, w, wu, gamma, ddphi, ddpsi):
        one = torch.ones_like(w) * (1 + 1j)
        return one, 0.5 * one
    monkeypatch.setattr(undulator.Undulator, '_integrate', stub)
    cfg = dict(_cfg('float32'), nrays=100000)
    drv = harness.load_module('configs', 'undulator')
    src, _ = drv.build(cfg, 'cpu')
    profiler.reset()
    try:
        with profiler.tracing():
            profiler.next_pass()
            beam = src.shine(torch.Generator().manual_seed(2))
        spans = profiler.spans()
        (c,) = profiler.counters().values()
    finally:
        profiler.reset()
    assert beam.x.shape == (100000,)
    assert [s.name for s in spans] == ['sources.shine', 'sources.integrate']
    assert c['integral.calls'] == 1
    assert c['integral.node_evals'] == 400000 * 804


def test_node_counter_counts_every_period_in_the_near_field():
    """Tapered or in the near field the integral walks Np copies of the
    node grid: the counter counts each."""
    cfg = _cfg('float64', 16)
    drv = harness.load_module('configs', 'undulator')
    src, _ = drv.build(cfg, 'cpu')
    src = src.replace(R0=25000.0)
    n = 50
    one = torch.full((n,), 6900.0, dtype=torch.float64)
    ang = torch.full((n,), 1e-4, dtype=torch.float64)
    profiler.reset()
    try:
        with profiler.tracing():
            src.build_I_map(None, one, ang, ang)
        (c,) = profiler.counters().values()
    finally:
        profiler.reset()
    assert src._node_copies() == cfg['undulator']['n']
    assert c['integral.node_evals'] == n * 40 * 32


def _tiny_run(trace):
    """The result line of ``beambench/run.py`` on the cell at 2000 rays
    and 64 x 2 nodes on the CPU, in a process of its own."""
    cfg = _cfg('float32', 64)
    over = dict(nrays=cfg['nrays'], undulator=cfg['undulator'])
    out = subprocess.run(
        [sys.executable, '-c', _RUN, BENCH, CELL, str(SEED),
         json.dumps(over), str(trace)], capture_output=True, text=True,
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
    """``beambench/run.py`` at 2000 rays and 64 x 2 nodes on the CPU: a
    result that is correct, with the cell's end-to-end metrics, and
    nothing of the JAX package loaded."""
    r = _tiny_run(trace=0)
    assert r['correct'], r['checks']
    assert r['attempted'] >= 1 and r['failed'] == 0
    assert {'rays_per_s', 'setup_s'} <= set(r['metrics'])


def test_a_traced_tiny_run_reads_the_runner_and_source_metrics():
    """``beambench/run.py --trace 1`` on the CPU: the runner's metrics,
    which the cell shares with the analyzer's, and the source's read a
    positive number (the device's shares need a card)."""
    r = _tiny_run(trace=1)
    assert r['correct'], r['checks']
    names = ('trace.runner_ms', 'trace.runner_self_ms', 'und.shine_ms',
             'und.integral_ms', 'und.integral_roofline')
    assert set(names) <= set(r['metrics']), r['metrics']
    assert all(r['metrics'][k]['value'] > 0 for k in names)


def test_the_window_gives_a_process_span_and_a_plot_launch_a_pass():
    """The window's record, as the runner's and B4's readers take it:
    one ``run_process`` time and one ``hist_plot`` shape (the screen's
    rays, 256 x 256 bins, 256 energy bins) for each pass it counts."""
    cfg = _cfg('float32', 16)
    drv = harness.load_module('configs', 'undulator')
    traffic = harness.load_json('traffic', 'char_passes.json')
    cell = harness.load_json('workloads', CELL + '.json')
    st = drv.setup(cfg, traffic, cell, SEED, 'cpu')
    res = drv.window(st, 0.5, time.perf_counter, False)
    n = len(res['units'])
    assert n >= 1
    assert len(res['spans']['run_process']) == n
    assert all(0 < ms <= 1e3 * (u['t1'] - u['t0']) for ms, u in
               zip(res['spans']['run_process'], res['units']))
    assert res['hist_launches'] == [(NRAYS, 256, 256, 256)] * n
    assert res['kernel_names'] == ('plot_',)


def test_the_lowered_control_is_not_correct():
    """The cell's set-up, window and check at 2000 rays on the CPU: the
    program's readings within the limits, the reference with its
    radiation integral and rays in bfloat16 in the program's place
    outside every one of them."""
    import calibrate
    cell = harness.load_json('workloads', CELL + '.json')
    limits = cell['check']['limits']
    cfg = _cfg('float32', 64)
    t = time.perf_counter()
    r = calibrate.readings(CELL, SEED, 1.0, True, device='cpu',
                           overrides=dict(nrays=cfg['nrays'],
                                          undulator=cfg['undulator']))
    assert time.perf_counter() - t < 300
    assert all(r['program'][k] <= v for k, v in limits.items()), r
    ctl = r['control']
    for k, v in limits.items():
        assert ctl[k] > v, (k, ctl[k])
