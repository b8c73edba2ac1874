"""CPU tests of the wave chain's cell (``softimax_chain.wave``): its driver's
units and pass ids, the readers of the program's spans and counters
(``metrics/chain.*``), the program's wave spans on a tiny chain, and a
tiny run of the cell that loads nothing of the JAX package.

    python -m pytest beambench -q -p no:cacheprovider

The test marked ``cuda`` runs the tiny chain on the card and skips without
one.
"""
import json
import os
import subprocess
import sys
import time
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import harness  # noqa: E402
from xrt_tpu_torch import profiler  # noqa: E402

CELL = 'softimax_chain.wave'
READERS = ('chain.shine_ms', 'chain.diffract_ms', 'chain.prep_ms',
           'chain.kirchhoff_gpairs_s')
#: a tiny chain for the CPU
TINY = dict(nrays=256, n_scr=8)


@pytest.fixture(autouse=True)
def _fresh_profiler():
    profiler.reset()
    yield
    profiler.reset()


def _read(run):
    return {name: harness.load_module('metrics', name).read(run)
            for name in READERS}


def _span(id, name, parent, pass_id, ms, ok=True):
    return SimpleNamespace(id=id, name=name, parent=parent, pass_id=pass_id,
                           ok=ok, device_ns=None if ms is None else
                           round(ms * 1e6))


def test_readers_give_none_without_records(monkeypatch):
    run = dict(units=[], spans={}, counters={})
    assert set(_read(run).values()) == {None}
    # records of a program without the wave spans and counters (the
    # parent's), over a traced window of two runs
    run = dict(units=[dict(t0=0.0, t1=1.0), dict(t0=1.0, t1=2.0)],
               spans={}, counters={},
               trace=dict(kernel_us={'void xfwd::forward_kernel<A>()': 1.0}))
    assert profiler.spans() == []
    assert set(_read(run).values()) == {None}
    # a program whose profiler keeps no spans or counters
    monkeypatch.setitem(sys.modules, 'xrt_tpu_torch.profiler',
                        types.ModuleType('xrt_tpu_torch.profiler'))
    assert set(_read(run).values()) == {None}


def test_readers_give_per_run_means(monkeypatch):
    """Three runs: a shine of 2 ms, two diffracts of 10 ms each with two
    prep spans of 1 ms inside, one diffract nested in another (counted
    once), a span that raised (left out); 1e9 pairs a run over 3 s of
    B1/B2 kernels (PyTorch's own reductions left out)."""
    spans, ids = [], iter(range(1000))
    for p in (1, 2, 3):
        spans.append(_span(next(ids), 'sources.shine_wave', None, p, 2.0))
        for _ in range(2):
            d = next(ids)
            spans.append(_span(d, 'waves.diffract', None, p, 10.0))
            spans.append(_span(next(ids), 'waves.diffract', d, p, 9.0))
            for _ in range(2):
                spans.append(_span(next(ids), 'waves.prep', d, p, 1.0))
        spans.append(_span(next(ids), 'waves.prep', None, p, 50.0,
                           ok=False))
    counters = {p: {'kirchhoff.pairs': 10 ** 9, 'kirchhoff.launches': 5}
                for p in (1, 2, 3)}
    fake = types.ModuleType('xrt_tpu_torch.profiler')
    fake.spans = lambda: list(spans)
    fake.counters = lambda: counters
    monkeypatch.setitem(sys.modules, 'xrt_tpu_torch.profiler', fake)
    kernel_us = {'void xfwd::forward_kernel<(anonymous namespace)::M>()':
                 2e6, 'void xfwd::reduce_kernel(float const*)': 1e6,
                 'void at::native::reduce_kernel<512, 1>()': 5e6}
    run = dict(units=[dict(t0=i, t1=i + 1.0) for i in range(3)],
               trace=dict(kernel_us=kernel_us))
    got = _read(run)
    assert got['chain.shine_ms'] == pytest.approx(2.0)
    assert got['chain.diffract_ms'] == pytest.approx(20.0)
    assert got['chain.prep_ms'] == pytest.approx(4.0)
    assert got['chain.kirchhoff_gpairs_s'] == pytest.approx(1.0)


def _fake_state(nrays=123):
    """The state the frozen window reads, with a chain run that records the
    profiler's pass id it ran under."""
    calls = []

    def run_chain(generator, timings=None, outputs=None):
        calls.append(profiler.GLOBAL.pass_id)
        return np.zeros((3, 2, 2))
    return SimpleNamespace(
        cfg=dict(nrays=nrays), cell=dict(check=dict(runs=3)), seed=7,
        device='cpu', generator=None, run_chain=run_chain, pairs=999,
        launches=[('kirchhoff_recentred:mono', 2, 3)]), calls


def test_window_units_are_rays_each_run_its_own_pass():
    drv = harness.load_module('configs', 'softimax_chain')
    st, calls = _fake_state()
    chain = st.run_chain
    res = drv.window(st, 0.05, time.perf_counter, False)
    assert st.run_chain is chain
    assert len(res['units']) == len(calls) >= st.checked_run + 1
    assert all(u['kind'] == 'rays' and u['work'] == 123
               for u in res['units'])
    # a new pass id before every run, none shared
    assert len(set(calls)) == len(calls) and calls == sorted(calls)
    assert calls[0] > 0
    # the frozen window's launches and kernel names, passed through
    assert res['launches'] == st.launches * len(res['units'])
    assert res['kernel_names'] == ('forward_kernel', 'reduce_kernel')
    # rays_per_s and pass_p95_ms read these units
    rate = harness.load_module('metrics', 'rays_per_s').read(res)
    span = res['units'][-1]['t1'] - res['units'][0]['t0']
    assert rate == pytest.approx(123 * len(calls) / span)


@pytest.fixture(scope='module')
def tiny_chain():
    """The cell's driver set up at a tiny size on the CPU, float32."""
    cell, traffic, cfg, drv = harness.find_cell(CELL)
    st = drv.setup(dict(cfg, **TINY), traffic, cell, 3000000101, 'cpu')
    return drv, st


def test_tracing_off_adds_no_span_or_counter(tiny_chain):
    drv, st = tiny_chain
    assert not profiler.is_tracing()
    drv.window(st, 0.0, time.perf_counter, False)
    assert profiler.spans() == [] and profiler.counters() == {}
    assert profiler.as_dict()['waves.diffract']['calls'] >= 10


def test_traced_runs_carry_the_wave_spans(tiny_chain):
    drv, st = tiny_chain
    with profiler.tracing():
        res = drv.window(st, 0.0, time.perf_counter, True)
    spans = profiler.spans()
    by_id = {s.id: s for s in spans}
    nruns = len(res['units'])
    runs = {s.pass_id for s in spans}
    assert len(runs) == nruns
    names = [s.name for s in spans]
    assert names.count('sources.shine_wave') == nruns
    assert names.count('waves.diffract') == 10 * nruns
    for s in spans:
        assert s.ok
        if s.name == 'waves.prep':
            p = by_id[s.parent]
            while p.name != 'waves.diffract':
                p = by_id[p.parent]
            assert p.pass_id == s.pass_id
    got = _read(res)
    assert got['chain.kirchhoff_gpairs_s'] is None  # no kernel on the CPU
    assert 0 < got['chain.prep_ms'] < got['chain.diffract_ms']
    wall = sum(u['t1'] - u['t0'] for u in res['units']) * 1e3 / nruns
    assert got['chain.shine_ms'] + got['chain.diffract_ms'] <= wall


_GUARDED_RUN = '''
import json, sys
sys.path.insert(0, sys.argv[1])
import harness, run
code, out = run.run(['--workload', sys.argv[2], '--seed', '3000000007',
                     '--seconds', '1', '--trace', '0'], device='cpu',
                    chip_check=False, overrides=json.loads(sys.argv[3]))
print(json.dumps(dict(code=code, correct=out['correct'],
                      metrics=sorted(out['metrics']),
                      loaded=harness.forbidden_modules())))
'''


def test_a_tiny_run_of_the_cell_loads_nothing_of_the_jax_package():
    out = subprocess.run(
        [sys.executable, '-c', _GUARDED_RUN, HERE, CELL, json.dumps(TINY)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['code'] == 0 and res['loaded'] == [] and res['correct']
    assert {'rays_per_s', 'setup_s'} <= set(res['metrics'])


@pytest.mark.cuda
def test_pair_counter_on_the_card():
    """On the card each forward launch counts its pairs: a traced run
    counts the run's launches and the pairs of its shapes."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cell, traffic, cfg, drv = harness.find_cell(CELL)
    cfg = dict(cfg, **TINY)
    st = drv.setup(cfg, traffic, cell, 3000000101, 'cuda')
    with profiler.tracing():
        res = drv.window(st, 0.0, time.perf_counter, False)
    torch.cuda.synchronize()
    for counts in profiler.counters().values():
        assert counts['kirchhoff.launches'] == len(st.launches)
        assert counts['kirchhoff.pairs'] == \
            sum(nd * ns for _, nd, ns in st.launches)
    assert len(profiler.counters()) == len(res['units'])
    assert all(s.device_ns is not None for s in profiler.spans()
               if s.name in ('waves.diffract', 'waves.prep',
                             'sources.shine_wave'))
