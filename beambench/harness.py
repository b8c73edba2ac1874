"""The benchmark's machinery, shared by every cell: finding a cell's files by
name, the guard against the JAX package, the reading of the profiler's
trace, and the run itself.

Everything that belongs to one configuration, traffic mix or metric lives
in files of its own, found by name:

- ``workloads/<cell>.json``: the cell (configuration, traffic, chips,
  why, the check's limits);
- ``traffic/<traffic>.json``: the traffic mix's parameters;
- ``configs/<config>.json``: the configuration's sizes, and
  ``configs/<config>.py`` its driver (``setup``, ``window``,
  ``free_program``, ``check``);
- ``references/<config>.py``: its plain reference;
- ``metrics/<metric>.py``: a reader ``read(run) -> number or None``.

``BENCHMARK.json`` at the root of the checkout says which metrics a cell
reports.
"""
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that no run may load
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'xrt_tpu')


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind, name):
    """``beambench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + '.py')
    spec = importlib.util.spec_from_file_location(
        f'beambench_{kind}_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root=ROOT):
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def cell_metrics(bench, cell, section):
    """The metrics of *section* ('end_to_end' or 'per_layer') that *cell*
    reports: those whose ``workloads`` name it, or that have none."""
    return [m for m in bench[section]
            if cell in m.get('workloads', [cell])]


def find_cell(name):
    """(cell, traffic, configuration sizes, configuration driver) of the
    cell *name*, from its files alone."""
    cell = load_json('workloads', name + '.json')
    traffic = load_json('traffic', cell['traffic'] + '.json')
    cfg = load_json('configs', cell['config'] + '.json')
    driver = load_module('configs', cell['config'])
    return cell, traffic, cfg, driver


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is one of :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split('.')[0] in FORBIDDEN)


def percentile(values, q):
    """The *q*-th percentile of *values* by linear interpolation between
    order statistics (numpy's default)."""
    import numpy as np
    return float(np.percentile(np.asarray(values, float), q))


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

def _union(intervals):
    """Merged [(start, end)] of *intervals*."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


#: Chrome-trace categories of work on the device
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def summarize_trace(prof, window_name='beambench.window', top=10):
    """From a finished ``torch.profiler.profile``: the device time of each
    kernel by name (us), the device's busy seconds inside the window span
    (the union of its kernels, copies and sets), the window's length, the
    operations that took most device time, and the longest idle gaps,
    each named after the innermost host operation open across it (and
    the innermost span of the benchmark's or the program's own around
    it).  The trace goes through a Chrome-trace file under the temporary
    directory, deleted once read."""
    import tempfile
    fd, path = tempfile.mkstemp(suffix='.json', prefix='beambench-')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    dev, host, win = [], [], None
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        s, t = float(e['ts']), float(e['ts']) + float(e['dur'])
        cat = e.get('cat', '')
        if cat in DEVICE_CATS:
            dev.append((e['name'], s, t))
        elif e['name'] == window_name and cat == 'user_annotation':
            win = (s, t)
        elif cat in ('cpu_op', 'user_annotation', 'cuda_runtime',
                     'cuda_driver') and t > s:
            host.append((e['name'], s, t, cat))
    if win is None or not dev:
        return None
    w0, w1 = win
    kernel_us, intervals = {}, []
    for name, s, t in dev:
        kernel_us[name] = kernel_us.get(name, 0.0) + (t - s)
        s, t = max(s, w0), min(t, w1)
        if t > s:
            intervals.append((s, t))
    busy = _union(intervals)
    busy_us = sum(t - s for s, t in busy)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        inner = sorted((t - s, n, c) for n, s, t, c in host
                       if s <= mid <= t)
        if inner:
            label = inner[0][1]
        else:
            # host code between operations: after the last one that ended
            done = [(t, n) for n, s, t, c in host
                    if t <= g0 and c != 'user_annotation']
            label = f'after {max(done)[1]}' if done else 'none'
        spans = [n for _, n, c in inner if c == 'user_annotation']
        if spans and spans[0] != label:
            label = f'{label} in {spans[0]}'
        named.append([label, (g1 - g0) * 1e-6])
    ops = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:top]
    return dict(kernel_us=kernel_us, busy_s=busy_us * 1e-6,
                window_s=(w1 - w0) * 1e-6,
                device_ops=[[n, us * 1e-6] for n, us in ops],
                idle_gaps=named)


def kernel_ms(run, patterns):
    """Device ms of the traced kernels whose names contain any of
    *patterns*; None without a trace or with no such kernel."""
    tr = run.get('trace')
    if not tr:
        return None
    us = sum(v for k, v in tr['kernel_us'].items()
             if any(p in k for p in patterns))
    return us * 1e-3 if us > 0 else None


def rate(run, kind):
    """Units of *kind* completed in the window over its wall time: from
    the start of the first unit to the end of the last one that completed
    (a unit the window's end cut off counts for neither)."""
    units = [u for u in run['units'] if u.get('kind') == kind]
    if not units or len(units) != len(run['units']):
        return None
    span = units[-1]['t1'] - units[0]['t0']
    return sum(u['work'] for u in units) / span if span > 0 else None


def idle(run):
    """The device's idle share of the traced window, %."""
    tr = run.get('trace')
    if not tr or tr['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
