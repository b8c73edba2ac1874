"""Readings for the limits of a cell's check: the program's on many seeds
and the control's (the plain reference in the precision below the
configuration's, put in the program's place) on a few, in one process.

    python3 beambench/calibrate.py --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2,3] [--seconds s]

Each seed builds the cell anew, runs a window of *seconds* (long enough to
reach the checked units), then prints one JSON line with the program's
readings and, for a control seed, the control's.  Nothing here runs in the
benchmark's own runs.
"""
import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import harness  # noqa: E402


def readings(name, seed, seconds, control, device='cuda', overrides=None):
    """{'seed', 'program': readings[, 'control': readings]} of one seed."""
    import torch
    cell, traffic, cfg, driver = harness.find_cell(name)
    cfg = dict(cfg, **(overrides or {}))
    st = driver.setup(cfg, traffic, cell, seed, device)
    driver.window(st, seconds, time.perf_counter, False)
    driver.free_program(st)
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    out = dict(seed=seed, program=driver.check(st, seed))
    if control:
        out['control'] = driver.check(st, seed, lowered=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--seconds', type=float, default=20.0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(',') if s]
    ctl = {int(s) for s in args.control_seeds.split(',') if s}
    for seed in seeds + sorted(ctl - set(seeds)):
        t = time.perf_counter()
        r = readings(args.workload, seed, args.seconds, seed in ctl)
        r['seconds'] = time.perf_counter() - t
        print(json.dumps(r, default=float), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
