"""The port's spans and counters (``xrt_tpu_torch.profiler`` while tracing)
and the benchmark's readers of them, on the CPU.

* Tracing off records the aggregates alone; under ``torch.profiler`` or
  ``profiler.tracing()`` (and ``run_ray_tracing(verbose=True)``) a tiny
  trace through the diced Johansson toroid records ``runner.step`` ⊃
  ``runner.process`` ⊃ ``oes.reflect`` ⊃ {``oes.search``,
  ``oes.interact``}, ``runner.histogram`` and ``runner.accumulate`` with
  their parent and pass ids, and the profiler's Chrome trace holds the same
  names as user annotations, nested the same way.
* The search's counters against counts worked out here: a plane that
  regula falsi solves in one step, and a curved surface searched ray by
  ray (the rays are independent, so each ray's iterations alone add up to
  the batch's active count).
* The search's results and a pass's histograms are bit-identical with
  tracing on and off; a span that exits on an exception is not ``ok``.
* Each of the benchmark's readers of these records
  (``beambench/metrics/trace.*.py``) reads a number from a tiny window of
  ``configs/analyzer.py`` under ``torch.profiler``, and None without records
  or with a program that keeps none.
"""
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xrt_tpu_torch import profiler, runner
from xrt_tpu_torch.oes.base import find_intersection_dz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, 'beambench')
READERS = ('trace.oes_reflect_ms', 'trace.search_ms', 'trace.search_iters',
           'trace.search_useful', 'trace.interact_ms',
           'trace.runner_self_ms', 'trace.alloc_per_pass')
NRAYS = 2000


@pytest.fixture(autouse=True)
def _fresh_profiler():
    profiler.reset()
    yield
    profiler.reset()


@pytest.fixture
def bench(monkeypatch):
    """The benchmark's harness module, with ``beambench/`` importable."""
    monkeypatch.syspath_prepend(BENCH)
    import harness
    return harness


def _trace(bench, repeats=2, seed=3, **kw):
    """``run_ray_tracing`` of the analyzer cell's first source at a few
    thousand rays a pass, float32 on the CPU; returns the plots."""
    drv = bench.load_module('configs', 'analyzer')
    cfg = bench.load_json('configs', 'analyzer.json')
    srcs, an, det, eLim = drv.build(cfg, NRAYS, device='cpu')

    def rp(bl, g):
        glo, loc = an.reflect(srcs[0].shine(g), g)
        return {'local': loc, 'detector': det.expose(glo)}
    plots = drv.make_plots(cfg, eLim)
    runner.run_ray_tracing(plots, repeats=repeats, run_process=rp,
                           rng=torch.Generator().manual_seed(seed), **kw)
    return plots


def test_tracing_off_records_only_the_aggregates(bench):
    assert not profiler.is_tracing()
    _trace(bench)
    assert profiler.spans() == [] and profiler.counters() == {}
    d = profiler.as_dict()
    assert d['runner.step']['calls'] == 2
    assert d['runner.step.runner.process.oes.reflect.oes.search'][
        'calls'] == 2
    assert d['runner.step.runner.histogram']['calls'] == 6


def _check_tree(spans, repeats):
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == 'runner.step']
    assert len(steps) == repeats
    passes = [s.pass_id for s in steps]
    assert len(set(passes)) == repeats
    for s in spans:
        assert s.ok and s.t1 >= s.t0 and s.pass_id in passes
        p = by_id.get(s.parent)
        parent = None if p is None else p.name
        assert parent == {
            'runner.step': None, 'runner.accumulate': None,
            'runner.process': 'runner.step',
            'runner.histogram': 'runner.step',
            'oes.reflect': 'runner.process', 'oes.search': 'oes.reflect',
            'oes.interact': 'oes.reflect'}[s.name], (s, p)
        if p is not None:
            assert p.pass_id == s.pass_id
            assert p.t0 <= s.t0 and s.t1 <= p.t1
        # the CPU's device time is the host time
        assert s.device_ns == s.t1 - s.t0
    names = [s.name for s in spans if s.pass_id == passes[0]]
    assert names == ['runner.step', 'runner.process', 'oes.reflect',
                     'oes.search', 'oes.interact'] + \
        ['runner.histogram'] * 3 + ['runner.accumulate']


@pytest.mark.parametrize('switch', ['torch_profiler', 'tracing', 'verbose'])
def test_spans_nest_with_parent_and_pass_ids(bench, switch, tmp_path,
                                             capsys):
    if switch == 'torch_profiler':
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _trace(bench)
    elif switch == 'tracing':
        with profiler.tracing():
            assert profiler.is_tracing()
            _trace(bench)
    else:
        _trace(bench, verbose=True)
        assert 'runner.step.runner.process' in capsys.readouterr().out
    assert not profiler.is_tracing()
    spans = profiler.spans()
    _check_tree(spans, 2)
    counters = profiler.counters()
    for p in {s.pass_id for s in spans}:
        assert counters[p]['search.calls'] == 1
        assert 'alloc.segments' not in counters[p]      # no card
    if switch != 'torch_profiler':
        return
    # the same names in the Chrome trace, nested the same way
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    ann = [(e['name'], e['ts'], e['ts'] + e['dur'])
           for e in json.load(open(path))['traceEvents']
           if e.get('cat') == 'user_annotation' and e.get('ph') == 'X']
    for name in {s.name for s in spans}:
        assert sum(n == name for n, _, _ in ann) == \
            sum(s.name == name for s in spans), name
    parent_of = {'runner.process': 'runner.step',
                 'runner.histogram': 'runner.step',
                 'oes.reflect': 'runner.process',
                 'oes.search': 'oes.reflect', 'oes.interact': 'oes.reflect'}
    for name, s, t in ann:
        if name in parent_of:
            assert any(n == parent_of[name] and s0 <= s and t <= t0
                       for n, s0, t0 in ann), name


def test_search_counters_on_a_plane():
    """dz = z: regula falsi lands on the root in one step.  Two of the four
    rays cross the plane inside the bracket; one starts below it (lost), one
    never reaches it (over)."""
    f = dict(dtype=torch.float64)
    z = torch.tensor([1.0, 2.0, -1.0, 0.5], **f)
    c = torch.tensor([-1.0, -1.0, -1.0, -0.1], **f)
    zero = torch.zeros(4, **f)
    tMax = torch.full((4,), 4.0, **f)
    with profiler.tracing():
        t, _, _, z2, lost = find_intersection_dz(
            lambda xx, yy, zz: zz, zero, tMax, zero, zero, z, zero, zero, c)
    assert t[:2].tolist() == [1.0, 2.0] and lost.tolist() == [
        False, False, True, False]
    assert profiler.counters() == {0: {
        'search.calls': 1, 'search.iterations': 1, 'search.ray_evals': 4,
        'search.active': 2}}


def _curved_rays(n=12):
    g = torch.Generator().manual_seed(5)
    f = dict(dtype=torch.float64)
    x = torch.rand(n, generator=g, **f) * 20 - 10
    z = torch.rand(n, generator=g, **f) * 5 + 1
    a = torch.rand(n, generator=g, **f) * 0.4 - 0.2
    zero = torch.zeros(n, **f)
    return (zero, torch.full((n,), 40.0, **f), x, zero, z, a, zero,
            -torch.ones(n, **f))


def _curve(xx, yy, zz):
    return zz - 0.05 * xx ** 2 * torch.sin(xx) - 0.3 * torch.cos(3 * xx)


def test_search_counters_equal_the_rays_searched_one_by_one():
    args = _curved_rays()
    n = args[0].numel()
    with profiler.tracing():
        batch = find_intersection_dz(_curve, *args)
    got = profiler.counters()[0]
    iters = []
    for i in range(n):
        profiler.reset()
        with profiler.tracing():
            one = find_intersection_dz(_curve, *(v[i:i + 1] for v in args))
        iters.append(profiler.counters()[0]['search.iterations'])
        assert torch.equal(one[0], batch[0][i:i + 1])
    assert len(set(iters)) > 1           # the rays converge apart
    assert got == {'search.calls': 1, 'search.iterations': max(iters),
                   'search.ray_evals': n * max(iters),
                   'search.active': sum(iters)}


def test_search_and_pass_are_bit_identical_with_tracing_on_and_off(bench):
    args = _curved_rays()
    off = find_intersection_dz(_curve, *args)
    with profiler.tracing():
        on = find_intersection_dz(_curve, *args)
    for u, v in zip(off, on):
        assert torch.equal(u, v)
    plots_off = _trace(bench, seed=11)
    with profiler.tracing():
        plots_on = _trace(bench, seed=11)
    assert profiler.spans()
    for p, q in zip(plots_off, plots_on):
        for k in ('total2D', 'total2D_RGB', 'total1D_x', 'total1D_y',
                  'total1D_c'):
            np.testing.assert_array_equal(getattr(p, k), getattr(q, k))
        assert (p.nRaysAll, p.nRaysGood, p.intensity) == \
            (q.nRaysAll, q.nRaysGood, q.intensity)


def test_a_span_that_raises_is_not_ok():
    with profiler.tracing():
        with pytest.raises(ValueError):
            with profiler.stage('outer', device='cpu'):
                with profiler.stage('inner'):
                    raise ValueError('stop')
        with profiler.stage('after'):
            profiler.count('n', 2)
    outer, inner, after = profiler.spans()
    assert (outer.ok, inner.ok, after.ok) == (False, False, True)
    assert inner.parent == outer.id and after.parent is None
    assert outer.device_ns == outer.t1 - outer.t0
    assert inner.device_ns is None
    assert profiler.counters() == {0: {'n': 2}}
    assert profiler.as_dict()['outer.inner']['calls'] == 1
    profiler.count('n')                  # tracing off: not counted
    assert profiler.counters() == {0: {'n': 2}}


def _window(bench, monkeypatch):
    """A tiny window of ``configs/analyzer.py`` under torch.profiler, with a
    stand-in caching allocator that makes five ``cudaMalloc`` calls a
    step."""
    cell, traffic, cfg, drv = bench.find_cell('analyzer.trace_10m')
    traffic = dict(traffic, nrays=NRAYS, repeats=2)
    st = drv.setup(cfg, traffic, cell, 3000000019, 'cpu')
    assert profiler.spans() == []
    calls = iter(range(0, 10 ** 6, 5))
    real = runner._alloc_stats
    monkeypatch.setattr(runner, '_alloc_stats', lambda dev: next(
        calls) if profiler.is_tracing() else real(dev))
    with profile(activities=[ProfilerActivity.CPU]):
        res = drv.window(st, 1.5, time.perf_counter, True)
    return res


def test_readers_read_the_programs_records(bench, monkeypatch):
    res = _window(bench, monkeypatch)
    got = {name: bench.load_module('metrics', name).read(res)
           for name in READERS}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    assert got['trace.alloc_per_pass'] == 5.0
    assert 1 <= got['trace.search_iters'] <= 64
    assert 0 < got['trace.search_useful'] <= 100
    assert got['trace.search_ms'] + got['trace.interact_ms'] <= \
        got['trace.oes_reflect_ms']
    # the pass that the window's close aborts is left out
    spans = profiler.spans()
    steps = [s for s in spans if s.name == 'runner.step']
    assert not steps[-1].ok and all(s.ok for s in steps[:-1])
    assert len(steps) - 1 == len(res['units'])
    # the outside metric of the same reflect, on the host clock here
    outside = bench.load_module('metrics', 'trace.reflect_ms').read(res)
    assert got['trace.oes_reflect_ms'] == pytest.approx(outside, rel=0.2)


def test_readers_give_none_without_records(bench, monkeypatch):
    run = dict(units=[], spans={}, counters={})
    for name in READERS:
        assert bench.load_module('metrics', name).read(run) is None
    # a program whose profiler keeps no spans or counters
    monkeypatch.setitem(sys.modules, 'xrt_tpu_torch.profiler',
                        types.ModuleType('xrt_tpu_torch.profiler'))
    for name in READERS:
        assert bench.load_module('metrics', name).read(run) is None


@pytest.mark.cuda
def test_spans_and_allocator_counters_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    src = GeometricSource.create(nrays=100000, device='cuda')
    scr = Screen.create(center=(0, 1000.0, 0))

    def rp(bl, g):
        return {'scr': scr.expose(src.shine(g))}
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    plot = XYCPlot(beam='scr', xaxis=XYCAxis('x', 'mm', limits=(-1, 1)),
                   yaxis=XYCAxis('z', 'mm', limits=(-1, 1)),
                   caxis=XYCAxis('energy', 'eV', limits=(5000, 5100)))
    with profiler.tracing():
        runner.run_ray_tracing(plot, repeats=3, run_process=rp,
                               rng=torch.Generator('cuda').manual_seed(1))
    torch.cuda.synchronize()
    spans = profiler.spans()
    for s in spans:
        assert s.device_ns >= 0 and s.ok
    counters = profiler.counters()
    steps = [s for s in spans if s.name == 'runner.step']
    assert len(steps) == 3
    for s in steps:
        assert counters[s.pass_id]['alloc.segments'] >= 0
        # the step's blocking synchronize settled the spans closed in it
        assert s._events is None and s.device_ns <= s.t1 - s.t0
