"""Run one cell of the benchmark of ``xrt_tpu_torch`` once.

    python3 beambench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Set-up builds the cell's beamline from the seed and warms up
every shape the window uses; the window runs the cell's traffic for
*seconds* (counting only units that completed); then the program's output
is held against the plain reference.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
from a ``torch.profiler`` trace of the window), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
its limit, also printed as the last lines of standard error.

Without CUDA, with fewer cards than the cell asks for, or with a module of
the JAX package loaded once the window has closed, it prints no result and
exits with a code other than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import harness  # noqa: E402

#: exit codes
NO_CHIP, FORBIDDEN_LOADED = 2, 3


def _caches():
    """Caches at fixed paths inside the checkout, so that only a checkout's
    first run fills them: the program's nvcc builds already go to
    ``build/kernels``; Triton's and PyTorch's extension caches, and the
    bytecode of every module imported from here on (a fresh process
    otherwise compiles the sources of what PyTorch imports lazily, ~4 s
    of the first pass on the card), go to ``build/beambench``."""
    cache = os.path.join(ROOT, 'build', 'beambench')
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ[var] = os.path.join(cache, sub)
    sys.pycache_prefix = os.path.join(cache, 'pycache')
    sys.dont_write_bytecode = False
    os.environ['USE_FLAX'] = '0'


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv, device='cuda', chip_check=True, overrides=None):
    """One run of a cell; returns (exit code, result dict or None).
    *device*, *chip_check* and *overrides* (configuration keys replaced)
    serve the CPU tests of the harness; a benchmark run takes the
    defaults."""
    args = parse(argv)
    _caches()
    import torch
    t_import = time.perf_counter() - T_START
    cell, traffic, cfg, driver = harness.find_cell(args.workload)
    if chip_check:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < int(cell['chips']):
            print(f"beambench: the cell needs {cell['chips']} CUDA "
                  f'card(s); found {found}', file=sys.stderr)
            return NO_CHIP, None
    cfg = dict(cfg, **(overrides or {}))
    bench = harness.benchmark()
    cuda = device == 'cuda'
    trace = bool(args.trace)

    st = driver.setup(cfg, traffic, cell, args.seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    counters0 = _counters()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    seconds = args.seconds
    if trace and traffic.get('trace_seconds'):
        seconds = min(seconds, float(traffic['trace_seconds']))
    from torch.profiler import record_function
    try:
        with record_function('beambench.window'):
            res = driver.window(st, seconds, time.perf_counter, trace)
        if cuda:
            torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    res['setup_s'] = setup_s
    res['counters'] = {k: v - counters0.get(k, 0)
                       for k, v in _counters().items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if prof is not None:
        res['trace'] = harness.summarize_trace(prof)
        del prof
    bad = harness.forbidden_modules()
    if bad:
        print(f'beambench: modules of the JAX package loaded: {bad}',
              file=sys.stderr)
        return FORBIDDEN_LOADED, None

    # the check: the program's state freed but for what it reads
    driver.free_program(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = driver.check(st, args.seed)
    win = res['units'][-1]['t1'] - res['units'][0]['t0'] \
        if res['units'] else 0.0
    parts = ', '.join(f'{k} {v:.3f} s'
                      for k, v in getattr(st, 'times', {}).items())
    print(f'beambench: window {win:.3f} s of {len(res["units"])} units; '
          f'set-up {setup_s:.3f} s (torch imported at {t_import:.3f} s; '
          f'{parts}); check {time.perf_counter() - t_check:.3f} s',
          file=sys.stderr)
    limits = cell['check']['limits']
    correct = all(readings[k] <= limits[k] for k in limits)
    # a reading that is not a finite number goes out as its name
    checks = {k: dict(value=readings[k] if math.isfinite(readings[k])
                      else str(readings[k]), limit=limits[k])
              for k in limits}

    section = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for m in harness.cell_metrics(bench, args.workload, section):
        v = harness.load_module('metrics', m['name']).read(res)
        if v is not None:
            metrics[m['name']] = dict(value=v, unit=m['unit'])
    dev = dict(platform='gpu' if cuda else 'cpu',
               kind=torch.cuda.get_device_name(0) if cuda else 'cpu',
               count=int(cell['chips']) if cuda else 0,
               memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=len(res['units']),
               failed=0, metrics=metrics, device=dev)
    if trace and res.get('trace'):
        tr = res['trace']
        dev.update(busy_s=tr['busy_s'], window_s=tr['window_s'])
        out['breakdown'] = dict(device_ops=tr['device_ops'],
                                idle_gaps=tr['idle_gaps'])
    out['checks'] = checks
    bad = harness.forbidden_modules()
    if bad:
        print(f'beambench: modules of the JAX package loaded: {bad}',
              file=sys.stderr)
        return FORBIDDEN_LOADED, None
    for k, v in readings.items():
        if k not in checks:
            print(f'reading {k}: {v}', file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0, out


def _counters():
    """The program's launch counters, by kernel and variant."""
    counts = {}
    for mod in ('xrt_tpu_torch.ops.kirchhoff', 'xrt_tpu_torch.histogram'):
        m = sys.modules.get(mod)
        if m is not None:
            counts.update(m.LAUNCHES)
    return counts


def main(argv=None):
    code, out = run(sys.argv[1:] if argv is None else argv)
    if out is not None:
        sys.stderr.flush()
        print(json.dumps(out), flush=True)
    return code


if __name__ == '__main__':
    sys.exit(main())
