"""Blockwise-tiled Kirchhoff stages: ``waves.choose_tile_modes``,
``diffract(tile_modes=...)`` and ``WaveChain.build(tiled=True)`` against
the JAX package's.

* ``choose_tile_modes`` gives the JAX function's nested list exactly on the
  SoftiMAX M1 -> M2 and M2 -> PG geometry (xrt's golden receiver samples,
  sorted along y as ``sort='y'`` sorts them).
* ``diffract(tile_modes=...)`` in float32 (the plain versions of B1 and B2
  on the CPU) against the JAX package's tiled diffract with its Pallas
  kernels in interpret mode, run in a subprocess at XLA O0 (conftest
  ``run_in_clean_env(f32=True)``), on a contact geometry whose tile pairs
  take both schemes: the five accumulators to 2e-5 of their largest
  magnitude, the limit ``tests/test_torch_kirchhoff.py`` holds the untiled
  kernels to.  Every 'mxu*' pair runs 'vpu' on the JAX side: the port's
  kernels run the exact per-pair f32 contraction for every ``accumulate``.
  The positions lie on binary grids (2^-7 mm along the strips, 2^-14 mm
  across, the receiving strip at a constant height), so each tile's
  recentring means are exact in any summation order.
* Tiled against untiled in the port, on the SoftiMAX M1 -> M2 stage:
  max|dEs| / max|Es| <= 0.02 (``tests/test_softimax_chain.py``'s bound).
* A float64 wave ignores ``tile_modes``: its result equals the untiled one
  exactly.
* ``WaveChain.build(tiled=True)`` on the SoftiMAX chain up to the grating:
  the OE receivers sorted along y, and every stage outside the recentred
  'mxu*' envelopes carrying the tile map the JAX functions give for its
  geometry; ``run(timings=[])`` reports the tile pairs per mode.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

from xrt_tpu.waves import (choose_kirchhoff_mode as j_choose_mode,
                           choose_tile_modes as j_choose_tiles)
from xrt_tpu_torch import interop
from xrt_tpu_torch import waves as tw
from xrt_tpu_torch.ops import dd as tdd
from xrt_tpu_torch.physconsts import CHBAR
from xrt_tpu_torch.wavechain import WaveChain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
import torch_bench_softimax as tbs  # noqa: E402

GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'ref_softimax.npz')
KV = 280.0 / CHBAR * 1e7
BUDGET = 3.0 / math.sqrt(2000)


@pytest.fixture(scope='module')
def ref():
    return np.load(GOLDEN)


@pytest.fixture(scope='module')
def els():
    return tbs.beamline(torch.float64, 'cpu')


def sorted_wave(el, prev, ref, wnm):
    """The golden receiver samples of *wnm* sorted along y, prepared on
    *el* (float64, CPU)."""
    x, y = ref[wnm + '_x'], ref[wnm + '_y']
    o = np.argsort(y, kind='stable')
    return tw.prepare_wave_on_oe(el, prev, 0, samples=(x[o], y[o]),
                                 dtype=torch.float64, device='cpu')


@pytest.mark.parametrize('stage', ['m2', 'pg'])
def test_choose_tile_modes_matches_jax(els, ref, stage):
    prev = {'m2': 'm1', 'pg': 'm2'}[stage]
    pprev = {'m2': 'slitFE', 'pg': 'm1'}[stage]
    src = sorted_wave(els[prev], els[pprev], ref, 'w' + prev)
    dst = sorted_wave(els[stage], els[prev], ref, 'w' + stage)
    d = tuple(v.numpy() for v in (dst.xDiffr, dst.yDiffr, dst.zDiffr))
    s = tuple(v.numpy() for v in (src.x, src.y, src.z))
    for kw in (dict(), dict(k=KV, error_budget=BUDGET)):
        got = tw.choose_tile_modes(d, s, 5, 10, **kw)
        exp = j_choose_tiles(d, s, 5, 10, **kw)
        assert got == [[tuple(m) for m in row] for row in exp]
    modes = {m for row in got for m in row}
    if stage == 'pg':       # a contact stage: both schemes
        assert ('fast', 'vpu') in modes and any(
            m[0] == 'recentred' for m in modes)
    # ragged tilings: the last tiles clipped, an empty tile when the
    # count exceeds the samples
    assert tw.choose_tile_modes(d, s, 3, 7) == [
        [tuple(m) for m in row] for row in j_choose_tiles(d, s, 3, 7)]
    tiny = tuple(v[:3] for v in d)
    assert tw.choose_tile_modes(tiny, s, 4, 2) == [
        [tuple(m) for m in row] for row in j_choose_tiles(tiny, s, 4, 2)]


def contact_arrays(seed=0, Ns=300, Nd=100):
    """A 300 mm flat source strip and a 12 mm receiving strip 30 mm above
    its middle, 280 eV, on binary grids; numpy arrays of the source beam
    and of the receiving wave (positions as f32 values).  Cut 1 x 8 (the
    last source tile edge-padded), the tile pairs near contact run 'fast',
    the others recentred."""
    rng = np.random.RandomState(seed)

    def grid(v, e):
        return np.round(v * 2.0 ** e) / 2.0 ** e
    ys = np.sort(grid(rng.uniform(-150, 150, Ns), 7))
    xs = grid(rng.uniform(-0.5, 0.5, Ns), 14)
    zs = np.zeros(Ns)
    yd = np.sort(grid(rng.uniform(-6, 6, Nd), 7))
    xd = grid(rng.uniform(-0.5, 0.5, Nd), 14)
    zd = np.full(Nd, 30.0)
    Es = np.exp(1j * rng.uniform(0, 2 * np.pi, Ns))
    rs = np.sqrt(xs ** 2 + (ys + 2000.0) ** 2 + 40.0 ** 2)
    src = dict(x=xs, y=ys, z=zs, a=xs / rs, b=(ys + 2000.0) / rs,
               c=-40.0 / rs, E=np.full(Ns, 280.0),
               state=np.ones(Ns, np.int32), path=np.zeros(Ns),
               Jss=np.abs(Es) ** 2, Jpp=np.full(Ns, 0.09), Jsp=0.3 * Es,
               Es=Es, Ep=0.3 * np.exp(1j * rng.uniform(0, 2 * np.pi, Ns)),
               area=np.asarray(1600.0))
    z0 = np.zeros(Nd)
    rd = np.sqrt(xd ** 2 + yd ** 2 + zd ** 2)
    wave = dict(x=xd, y=yd, z=z0, a=xd / rd, b=yd / rd, c=zd / rd,
                E=np.full(Nd, 280.0), state=np.ones(Nd, np.int32),
                path=z0, Jss=z0, Jpp=z0, Jsp=z0 + 0j, Es=z0 + 0j,
                Ep=z0 + 0j, xDiffr=xd, yDiffr=yd, zDiffr=zd, rDiffr=rd,
                dS=np.full(Nd, 0.4), area=np.asarray(240.0),
                EsAcc=z0 + 0j, EpAcc=z0 + 0j, aEacc=z0 + 0j,
                bEacc=z0 + 0j, cEacc=z0 + 0j, beamReflRays=np.asarray(0.0),
                beamReflSumJ=np.asarray(0.0),
                beamReflSumJnl=np.asarray(0.0),
                diffract_repeats=np.asarray(0.0))
    for k in ('xDiffr', 'yDiffr', 'zDiffr'):
        wave[k], wave[k + '_lo'] = tdd.from_f64(wave[k])
    return src, wave


JAX_TILED = r'''
import numpy as np
import jax
jax.config.update('jax_enable_x64', False)
import jax.numpy as jnp
from xrt_tpu.beam import Beam
from xrt_tpu.waves import Wave, diffract
d = np.load(IN, allow_pickle=True)
def arr(v):
    v = np.asarray(v)
    if np.iscomplexobj(v):
        return jnp.asarray(v, jnp.complex64)
    if v.dtype.kind in 'iu':
        return jnp.asarray(v, jnp.int32)
    return jnp.asarray(v, jnp.float32)
src = Beam(**{k[4:]: arr(d[k]) for k in d.files if k.startswith('src_')})
wave = Wave(**{k[5:]: arr(d[k]) for k in d.files if k.startswith('wave_')})
out = diffract(src, wave, use_pallas=True, monochromatic=True,
               tile_modes=TILES)
np.savez(OUT, **{k: np.asarray(getattr(out, k)) for k in
                 ('EsAcc', 'EpAcc', 'aEacc', 'bEacc', 'cEacc')})
print('OK')
'''


def test_tiled_diffract_f32_matches_jax(clean_env_runner, tmp_path):
    src, wave = contact_arrays()
    tsrc = interop.beam_from_numpy(src, device='cpu', dtype=torch.float32)
    twave = interop.wave_from_numpy(wave, device='cpu', dtype=torch.float32)
    tiles = tw.choose_tile_modes(
        (twave.xDiffr, twave.yDiffr, twave.zDiffr),
        (tsrc.x, tsrc.y, tsrc.z), 1, 8, k=KV)
    flat = [m for row in tiles for m in row]
    assert ('fast', 'vpu') in flat and any(m[0] == 'recentred'
                                           for m in flat)
    got = tw.diffract(tsrc, twave, monochromatic=True, tile_modes=tiles)
    vpu = [[(pm, 'vpu') for pm, _ in row] for row in tiles]
    np.savez(tmp_path / 'in.npz',
             **{'src_' + k: v for k, v in src.items()},
             **{'wave_' + k: v for k, v in wave.items()})
    code = (f'IN = {str(tmp_path / "in.npz")!r}\n'
            f'OUT = {str(tmp_path / "out.npz")!r}\nTILES = {vpu!r}\n'
            + JAX_TILED)
    stdout, _ = clean_env_runner(code, f32=True)
    assert 'OK' in stdout
    exp = np.load(tmp_path / 'out.npz')
    for k in ('EsAcc', 'EpAcc', 'aEacc', 'bEacc', 'cEacc'):
        g = getattr(got, k).numpy()
        err = float(np.abs(g - exp[k]).max() / np.abs(exp[k]).max())
        assert err < 2e-5, (k, err)


def test_tiled_against_untiled_on_the_m1_m2_stage():
    rc = tbs.build_chain(nrays=2000, n_scr=8, tiled=True,
                         dtype=torch.float32, device='cpu')
    inputs = {}
    rc(inputs=inputs)
    cur, w = inputs['m2'], rc.waves['m2']
    assert 'm2' in rc.tilemaps
    pm, acc = rc.modes['m2']
    un = tw.diffract(cur, w, phase_mode=pm, accumulate=acc,
                     monochromatic=True, narrowband=False).Es
    ti = tw.diffract(cur, w, monochromatic=True,
                     tile_modes=rc.tilemaps['m2'], narrowband=False).Es
    err = float((ti - un).abs().max() / un.abs().max())
    assert err <= 0.02, err


def test_float64_ignores_tile_modes():
    src, wave = contact_arrays(seed=1, Ns=400, Nd=300)
    tsrc = interop.beam_from_numpy(src, device='cpu', dtype=torch.float64)
    twave = interop.wave_from_numpy(wave, device='cpu', dtype=torch.float64)
    tiles = tw.choose_tile_modes(
        (twave.xDiffr, twave.yDiffr, twave.zDiffr),
        (tsrc.x, tsrc.y, tsrc.z), 2, 3, k=KV)
    a = tw.diffract(tsrc, twave, monochromatic=True, tile_modes=tiles)
    b = tw.diffract(tsrc, twave, monochromatic=True)
    for k in ('Es', 'Ep', 'a', 'b', 'c', 'Jss'):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_wavechain_tiled_build_matches_the_jax_functions(els):
    chain = (WaveChain(els['src'], nrays=1500, fixedEnergy=tbs.E0)
             .through_aperture(els['slitFE']).through_oe(els['m1'])
             .through_oe(els['m2']).through_oe(els['pg']))
    run = chain.build(torch.Generator().manual_seed(2), tiled=True,
                      dtype=torch.float64, device='cpu')
    budget = 3.0 / math.sqrt(1500)
    tiled = 0
    for i in range(1, len(run.waves)):
        w, p = run.waves[i], run.waves[i - 1]
        if i > 1:           # the OE receivers are sorted along y
            assert bool((w.y[1:] >= w.y[:-1]).all())
        d = tuple(v.numpy() for v in (w.xDiffr, w.yDiffr, w.zDiffr))
        s = tuple(v.numpy() for v in (p.x, p.y, p.z))
        mode = j_choose_mode(d, s, k=KV, error_budget=budget)
        assert run.modes[i] == mode
        if mode[0] == 'recentred' and mode[1].startswith('mxu'):
            assert run.tilemaps[i] is None
        else:
            tiled += 1
            assert run.tilemaps[i] == [
                [tuple(m) for m in row]
                for row in j_choose_tiles(d, s, 5, 10, k=KV,
                                          error_budget=budget)]
    assert tiled == 2
    timings = []
    wv, logs = run(timings=timings)
    assert np.all(np.isfinite(WaveChain.absolute_intensity(wv, logs)))
    recs = {r['hop']: r for r in timings}
    for i, tm in enumerate(run.tilemaps):
        if tm is not None:
            assert recs[i]['tiles'] == tw.tile_pairs_by_mode(tm)
            assert sum(recs[i]['tiles'].values()) == 50


def test_receiver_samples_rebuild_the_same_chain():
    """build_chain(samples=receiver_samples(rc)) prepares the same
    receiving samples in another dtype (what ``--f64`` compares); the focal
    screens are pixel grids of each dtype."""
    rc = tbs.build_chain(nrays=500, n_scr=4, dtype=torch.float32,
                         device='cpu')
    rc64 = tbs.build_chain(nrays=500, n_scr=4, dtype=torch.float64,
                           device='cpu', samples=tbs.receiver_samples(rc))
    for name in ['slit'] + [nm for nm, _ in tbs.STAGES]:
        w, w64 = rc.waves[name], rc64.waves[name]
        for k in ('x', 'y', 'z'):
            assert torch.equal(getattr(w, k).double(), getattr(w64, k)), \
                (name, k)
