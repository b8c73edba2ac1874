#!/usr/bin/env python3
"""``chip_smoke.py``'s phase-34 paths over every card of one host: one
process a card over NCCL, and ``python -m xrt_tpu_torch trace --multihost``
under ``torchrun``.

    python3 tools/torch_multicard.py

Builds the kernels, then spawns one rank a card (``torch.multiprocessing``,
a file store in a temporary directory, ``cuda:<rank>``); each rank runs
``chip_smoke.multicard_paths``: phase 3's 2e5-sample chain split over the
cards and with the ring, phase 4's B2 hop, phase 6's trace (1e7 rays a
card x 4 passes), phase 12's data-parallel pitch gradient and phase 9's
chain gradient through the sharded chain, each beside its unsharded run on
that rank's card, with the bytes the collectives moved.  Holds them to
phase 34b's limits (the chain and the hop to 2e-5 of the peak, the
gradient to 1e-5, the trace and the data-parallel gradient bit for bit
against the ordered sums of the ranks' unsharded ones).  Then traces
phase 6's beamline, written as a JSON layout, through ``torchrun
--standalone --nproc-per-node N -m xrt_tpu_torch trace --multihost`` with
N = 1 and N = all the cards, and prints both runs' wall time and flux
(their ratio: N).  Exits non-zero if a check fails.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600


def rank_main(rank, world, init, outdir):
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from xrt_tpu_torch import parallel as par
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    dist.init_process_group('nccl', init_method='file://' + init,
                            rank=rank, world_size=world,
                            device_id=torch.device('cuda', rank))
    try:
        res = cs.multicard_paths(par.make_mesh(device=f'cuda:{rank}'))
        with open(os.path.join(outdir, f'rank{rank}.json'), 'w') as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def torchrun_trace(layout, nproc):
    """(wall seconds, printed flux) of ``trace --multihost`` on *nproc*
    cards."""
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc-per-node', str(nproc), '-m', 'xrt_tpu_torch', 'trace',
           layout, '--multihost', '--repeats', '4', '--seed', '5']
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise SystemExit(f'torchrun {nproc}: {r.stdout[-3000:]} '
                         f'{r.stderr[-3000:]}')
    fluxes = {float(m) for m in re.findall(r'flux=([0-9.eE+-]+) over',
                                           r.stdout)}
    if len(fluxes) != 1:
        raise SystemExit(f'torchrun {nproc}: ranks disagree {r.stdout}')
    return wall, fluxes.pop()


def main():
    import torch
    import torch.multiprocessing as mp
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from xrt_tpu_torch.beamline import BeamLine
    if not torch.cuda.is_available():
        print('torch_multicard: no CUDA device', file=sys.stderr)
        return 1
    world = torch.cuda.device_count()
    print(cs.phase_card(), f'x {world}', flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(rank_main, args=(world, os.path.join(d, 'init'),
                                            d), nprocs=world,
                           start_method='spawn')
        ranks = []
        for r in range(world):
            with open(os.path.join(d, f'rank{r}.json')) as f:
                ranks.append(json.load(f))
    bad = []
    for res in ranks:
        cs.print_multicard(f'{world}-card', res)
        try:
            cs.check_multicard(f'{world}-card rank {res["rank"]}', res)
        except cs.PhaseError as e:
            bad.append(str(e))
    print(f'{world} ranks took {time.perf_counter() - t0:.1f} s', flush=True)

    src, tor, scr = cs.trace_beamline(cs.TRACE_NRAYS, torch.float32)
    bl = BeamLine(alignE=9000.0)
    for name, el in (('source', src), ('mirror', tor), ('screen', scr)):
        bl.add(name, el)
    with tempfile.TemporaryDirectory() as d:
        layout = os.path.join(d, 'trace.json')
        bl.export_to_json(layout)
        runs = {n: torchrun_trace(layout, n) for n in (1, world)}
    (w1, f1), (wn, fn) = runs[1], runs[world]
    print(f'trace --multihost under torchrun, phase 6\'s beamline, '
          f'{cs.TRACE_NRAYS} rays a card x 4 passes: 1 card {w1:.1f} s '
          f'(flux {f1:.6g}), {world} cards {wn:.1f} s (flux {fn:.6g}, '
          f'{fn / f1:.4f} x; wall times include each process\'s start-up '
          f'and the calibrating pass)', flush=True)
    if abs(fn / f1 - world) > 0.25 * world / 8:
        bad.append(f'flux ratio {fn / f1} for {world} cards')
    if bad:
        print('torch_multicard: FAILED: ' + '; '.join(bad), file=sys.stderr)
        return 1
    print('torch_multicard: ok')
    return 0


if __name__ == '__main__':
    sys.exit(main())
