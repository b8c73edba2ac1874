"""The benchmark's SoftiMAX cell on the CPU at a small size: the port's chain
(2048 samples a wave, 16 x 16 focal images, float32 and float64) run
through the driver of ``beambench/configs/softimax_chain.py`` (``setup``,
``window``, ``free_program``, ``check``) and held to the plain float64
reference of ``beambench/references/softimax.py`` under the cell's limits
(``beambench/workloads/softimax_chain.wave.json``).  Every Kirchhoff step
reads below 1e-2, the step from the blazed grating (PG -> M3) included:
with the grating's groove arithmetic in float32 it read 1.6e-2 here
(ROADMAP C8).

The seed draws the first run as the checked one, so the window runs one
chain run.  Imports nothing of the JAX package.
"""
import os
import sys
import time

import pytest
import torch

from xrt_tpu_torch import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'beambench'))
import harness  # noqa: E402

CELL = 'softimax_chain.wave'
SEED = 3000000101
SMALL = dict(nrays=2048, n_scr=16)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['f32', 'f64'])
def test_small_chain_through_the_cell_driver(dtype, monkeypatch):
    monkeypatch.setattr(config, 'DEFAULT_DTYPE', dtype)
    cell, traffic, cfg, drv = harness.find_cell(CELL)
    cfg = dict(cfg, **SMALL)
    st = drv.setup(cfg, traffic, cell, SEED, 'cpu')
    res = drv.window(st, 0.0, time.perf_counter, False)
    assert len(res['units']) == st.checked_run + 1 == 1
    assert all(u['kind'] == 'rays' and u['work'] == SMALL['nrays']
               for u in res['units'])
    assert st.run_chain.waves['m1'].xDiffr.dtype == dtype
    drv.free_program(st)
    readings = drv.check(st, SEED)
    for k, limit in cell['check']['limits'].items():
        assert readings[k] <= limit, (k, readings[k])
    assert max(readings['steps'].values()) < 1e-2, readings['steps']


def copies(v):
    """*v* (tensors in tuples and lists) with each tensor copied."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    return type(v)(copies(u) for u in v)


@pytest.mark.cuda
def test_tile_pairs_replayed_from_graphs_give_the_eager_bits():
    """On the card a tiled stage's pairs take their per-point preparation
    from a CUDA graph: every pair's sums equal the eager call's on the same
    values, bit for bit.  The eager call gets copies of the pair's slices:
    a slice that starts off a 16-byte boundary (tiles of 410 and 205
    samples here) sums the recentring means in another order."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from xrt_tpu_torch import waves
    from xrt_tpu_torch.ops import kirchhoff as tk
    cell, traffic, cfg, drv = harness.find_cell(CELL)
    st = drv.setup(dict(cfg, **SMALL), traffic, cell, SEED, 'cuda')
    outs = {}
    st.run_chain(st.generator, outputs=outs)
    assert st.run_chain.tilemaps and tk._PREP_GRAPHS
    for name, tm in st.run_chain.tilemaps.items():
        args = waves.kirchhoff_kernel_args(outs[name][0],
                                           st.run_chain.waves[name])
        for _, (pm, am), pair, _ in waves.tile_pair_args(args, tm):
            kw = dict(phase_mode=pm, monochromatic=True, accumulate=am,
                      narrowband=False, check_envelope=False)
            got = tk.kirchhoff_integral_kernel(*pair, graph=True, **kw)
            want = tk.kirchhoff_integral_kernel(*copies(pair), **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), name
