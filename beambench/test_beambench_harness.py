"""CPU tests of the benchmark's harness: finding cells, configurations and
metrics by name from their files, the contract's names and units, the work
and roofline arithmetic, the import guard, and each plain reference
against the program on a tiny instance of its beamline.

    python -m pytest beambench -q -p no:cacheprovider

The tests that need a CUDA card carry the ``cuda`` mark and skip inside a
fixture without one.
"""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import harness  # noqa: E402
import peaks  # noqa: E402

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
BENCH = harness.benchmark()
#: tiny sizes of each configuration for the CPU
TINY = {'softimax': dict(nrays=2000, n_scr=16), 'analyzer': dict(nrays=4000)}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


def _cells():
    return sorted(f[:-5] for f in os.listdir(os.path.join(HERE, 'workloads'))
                  if f.endswith('.json'))


@pytest.mark.parametrize('cell', _cells())
def test_every_cell_file_is_found_by_name(cell):
    c, traffic, cfg, driver = harness.find_cell(cell)
    assert c['name'] == cell and traffic['name'] == c['traffic']
    assert cfg['name'] == c['config']
    for fn in ('setup', 'window', 'free_program', 'check'):
        assert callable(getattr(driver, fn))
    assert os.path.exists(os.path.join(HERE, 'references',
                                       c['config'] + '.py'))
    assert set(c['check']['limits']) and c['chips'] in (1, 4)


def test_benchmark_cells_and_metrics_have_files():
    for w in BENCH['workloads']:
        c = harness.find_cell(w['name'])[0]
        assert (c['config'], c['traffic'], c['chips'], c['why']) == \
            (w['config'], w['traffic'], w['chips'], w['why'])
    for section in ('end_to_end', 'per_layer'):
        for m in BENCH[section]:
            assert callable(harness.load_module('metrics', m['name']).read)
    for c in BENCH['configs']:
        cfg = json.load(open(os.path.join(ROOT, c['file'])))
        assert cfg['name'] == c['name'] and cfg['reduced'] == c['reduced']
        assert cfg['source'] == c['source']


def test_a_new_cell_is_found_from_its_file_alone(tmp_path):
    """A later cell is a workload file (and a traffic file) and nothing
    else: a copy of the harness finds it."""
    copy = tmp_path / 'beambench'
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns(
        '__pycache__'))
    traffic = json.load(open(copy / 'traffic' / 'speed_test_passes.json'))
    traffic.update(name='speed_test_passes_1m', nrays=1000000, repeats=8)
    json.dump(traffic, open(copy / 'traffic' / 'speed_test_passes_1m.json',
                            'w'))
    cell = json.load(open(copy / 'workloads' / 'analyzer.trace.json'))
    cell.update(name='analyzer.trace_1m', traffic='speed_test_passes_1m')
    json.dump(cell, open(copy / 'workloads' / 'analyzer.trace_1m.json', 'w'))
    out = subprocess.run(
        [sys.executable, '-c',
         'import sys; sys.path.insert(0, sys.argv[1]); import harness; '
         'c, t, cfg, d = harness.find_cell("analyzer.trace_1m"); '
         'print(c["config"], t["nrays"], d.__name__)', str(copy)],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ['analyzer', '1000000',
                                  'beambench_configs_analyzer']


def test_benchmark_json_follows_the_contract():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['beambench'] and \
        BENCH['command'] == ['python3', 'beambench/run.py']
    assert 1 <= BENCH['run_seconds'] <= 51
    names = set()
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and c['file'].startswith('beambench/')
        names.add(c['name'])
    used = set()
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        for k in ('name', 'config', 'traffic'):
            assert NAME.match(w[k])
        assert w['config'] in names and len(w['why']) <= 200
        used.add(w['config'])
    assert used == names
    cells = {w['name'] for w in BENCH['workloads']}
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for section in ('end_to_end', 'per_layer'):
        for m in BENCH[section]:
            assert NAME.match(m['name']) and UNIT.match(m['unit'])
            assert m['better'] in ('lower', 'higher')
            assert set(m.get('workloads', cells)) <= cells
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e and m['moves'] != 'setup_s'
        mv = e2e[m['moves']]
        # every cell of the metric reports the metric it moves
        assert set(m['workloads']) <= set(mv.get('workloads', cells))
    for cell in cells:
        mine = [m['name'] for m in harness.cell_metrics(BENCH, cell,
                                                        'end_to_end')]
        assert 'setup_s' in mine and len(mine) >= 2
        assert harness.cell_metrics(BENCH, cell, 'per_layer')
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_files_are_named_from_names():
    for dirpath, _, files in os.walk(HERE):
        if '__pycache__' in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r'^[A-Za-z0-9_./\-]+$', rel), rel


def test_pairs_and_bounds_from_shapes():
    drv = harness.load_module('configs', 'softimax')
    cfg = harness.load_json('configs', 'softimax.json')
    assert drv.pairs_per_run(cfg) == 7 * 200000 ** 2 + 3 * 200000 * 64 ** 2
    assert drv.pairs_per_run(cfg) == 282457600000
    ms, kind = peaks.bound_ms('kirchhoff_recentred:mono', 200000, 200000)
    assert kind == 'operations' and ms == pytest.approx(
        116 * 4e10 / 67e12 * 1e3)
    assert ms == pytest.approx(69.25, abs=0.01)
    ms, _ = peaks.bound_ms('kirchhoff_ddphase:fast', 40000, 20000)
    assert ms == pytest.approx(160 * 8e8 / 67e12 * 1e3)
    # a plot of 1e5 rays into 400 x 400 x 128: 21 bytes a ray, 4-byte bins
    nb = 400 + 400 + 128 + 400 * 400
    assert peaks.hist_plot_bytes(100000, 400, 400, 128) == \
        100000 * 21 + (4 * nb + 1) * 4


def test_tiny_chain_launches_cover_its_pairs():
    import torch
    drv = harness.load_module('configs', 'softimax')
    cfg = dict(harness.load_json('configs', 'softimax.json'),
               **TINY['softimax'])
    rc = drv.build_chain(cfg, device='cpu',
                         generator=torch.Generator().manual_seed(3))
    launches = drv.launches(rc)
    assert sum(nd * ns for _, nd, ns in launches) == drv.pairs_per_run(cfg)
    assert {n for n, _, _ in launches} <= set(peaks.OPS_PER_PAIR)


def test_rate_percentile_and_idle_arithmetic():
    run = dict(units=[dict(t0=0.0, t1=1.0, work=10, kind='rays'),
                      dict(t0=1.0, t1=3.0, work=10, kind='rays')],
               trace=dict(busy_s=1.5, window_s=6.0))
    assert harness.rate(run, 'rays') == pytest.approx(20 / 3)
    assert harness.rate(run, 'pairs') is None
    assert harness.idle(run) == pytest.approx(75.0)
    assert harness.percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {'xrt_tpu_torch': 1, 'xrt_tpu_torch.ops': 1, 'jaxtyping': 1,
            'xrt_tpu_torchx': 1, 'numpy': 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({'xrt_tpu': 1, 'xrt_tpu.waves': 1, 'jax.numpy': 1,
                 'jaxlib': 1, 'flax.linen': 1})
    assert harness.forbidden_modules(mods) == [
        'flax.linen', 'jax.numpy', 'jaxlib', 'xrt_tpu', 'xrt_tpu.waves']


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


@pytest.mark.parametrize('cell', _cells())
def test_a_tiny_run_loads_nothing_of_the_jax_package(cell):
    c = harness.find_cell(cell)[0]
    out = subprocess.run(
        [sys.executable, '-c', _GUARDED_RUN, HERE, cell,
         json.dumps(TINY[c['config']])], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['code'] == 0 and res['loaded'] == []
    assert 'setup_s' in res['metrics']


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, 'run.py'), '--workload',
         'analyzer.trace', '--seed', '1', '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0 and out.stdout.strip() == ''


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    cell = BENCH['workloads'][0]['name']
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, 'run.py'), '--workload', cell,
         '--seed', '3000000009', '--seconds', '5', '--trace', '0'],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['correct'] and res['device']['platform'] == 'gpu'


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files (no
    program) exits with a code other than 0 and prints no result."""
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(HERE, tmp_path / 'beambench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    code = ('import sys; sys.path.insert(0, "beambench"); import run; '
            'c, out = run.run(["--workload", "analyzer.trace", "--seed", '
            '"1", "--seconds", "1", "--trace", "0"], device="cpu", '
            'chip_check=False); print(out)')
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=''))
    assert out.returncode != 0 and out.stdout.strip() == ''
    assert 'xrt_tpu_torch' in out.stderr
