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
import torch_harness  # noqa: F401

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


def _requiring_grad(pair):
    """*pair* with a copy of its weights that requires grad: the call then
    takes the plain, differentiable preparation."""
    return (*pair[:-1], pair[-1].clone().requires_grad_(True))


@pytest.mark.cuda
def test_tile_pairs_take_the_prep_kernel():
    """On the card a tiled stage's pairs take their per-point preparation
    from ``csrc/kirchhoff_prep.cu``, one launch of it a call and no CUDA
    graph, and every pair's five sums agree with those of the plain
    preparation (a copy of the weights requiring grad) within 1e-6 of the
    pair's peak: both sum the recentring means in double."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from xrt_tpu_torch import waves
    from xrt_tpu_torch.ops import kirchhoff as tk
    assert not hasattr(tk, '_PREP_GRAPHS')
    cell, traffic, cfg, drv = harness.find_cell(CELL)
    st = drv.setup(dict(cfg, **SMALL), traffic, cell, SEED, 'cuda')
    outs = {}
    tk.LAUNCHES.clear()
    st.run_chain(st.generator, outputs=outs)
    preps = sum(v for kk, v in tk.LAUNCHES.items() if kk.startswith('prep:'))
    forwards = sum(v for kk, v in tk.LAUNCHES.items()
                   if kk.startswith('kirchhoff_'))
    assert st.run_chain.tilemaps and preps == forwards > 0, tk.LAUNCHES
    for name, tm in st.run_chain.tilemaps.items():
        args = waves.kirchhoff_kernel_args(outs[name][0],
                                           st.run_chain.waves[name])
        for ij, (pm, am), pair, _ in waves.tile_pair_args(args, tm):
            kw = dict(phase_mode=pm, monochromatic=True, accumulate=am,
                      narrowband=False, check_envelope=False)
            tk.LAUNCHES.clear()
            got = tk.kirchhoff_integral_kernel(*pair, **kw)
            assert dict(tk.LAUNCHES) == (
                {'prep:mono': 1, 'kirchhoff_recentred:mono': 1}
                if pm == 'recentred' else
                {f'prep:{pm}': 1, f'kirchhoff_ddphase:{pm}': 1}), tk.LAUNCHES
            want = tk.kirchhoff_integral_kernel(*_requiring_grad(pair), **kw)
            for a, b in zip(got, want):
                b = b.detach()
                assert float((a - b).abs().max()) <= \
                    1e-6 * float(b.abs().max()), (name, ij)
