"""The port's multi-card layer (``xrt_tpu_torch.parallel``) on gloo worlds
of CPU processes, against its unsharded results and the JAX package's.

One world of four ranks (``tests/torch_ranks.py``, spawned by
``torch.multiprocessing`` with a file store under a temporary directory,
one thread a rank) runs everything; the worlds of 2 and 3 are its
subgroups.  The JAX package's side runs in two concurrent subprocesses
with eight CPU devices each (``tests/jax_parallel_ref.py``: the chains;
the Kirchhoff integrals and the gradient), started first: the ranks wait
only for the receiver samples.  All are killed, with everything they
started, if they outlast their time limit.

* ``kirchhoff_sharded``, ``kirchhoff_ring`` and ``dst_sharded_call`` (both
  ways) in float64 on Nd = 333, Ns = 700 (no multiple of 2, 3 or 4): to
  1e-12 of the port's unsharded integral and of the JAX package's
  single-device one under ``jax.disable_jit()``, and to 1e-6 of its
  eight-device result (under ``jit`` XLA contracts FMAs, ROADMAP C6).
  The ring's gradient in the fields and the destinations, to 1e-12 of the
  unsharded gradient, the same on every rank.
* The Gaussian -> slit -> toroid -> screen chain of
  ``tests/test_wavechain_sharded.py``: ``WaveChain.build(mesh=)`` and
  ``ring=True`` against the port's unsharded chain, float64 to 1e-12 and
  float32 to 5e-3; and hop by hop on the JAX package's receiver samples
  against its sharded chains, float64 to 1e-6 and float32 to 5e-3 (the
  JAX test's own limit).
* The gradient of the diffracted intensity in the source's waist through
  ``diffract(mesh=)`` and ``ring=True``: float64 to 1e-12 of the unsharded
  port gradient and to 1e-9 of ``jax.grad`` of the JAX package's unsharded
  ``diffract`` under ``jax.disable_jit()``, the same on every rank (not
  the world size times it); float32 to 1e-4 of the unsharded float32
  gradient (each tile is recentred on its own points).
* ``run_ray_tracing(mesh=)`` on the world of 4: the flux four times one
  rank's, 4 +- 0.25 * 4 / 8 (the JAX package's ``test_sharded_runner.py``
  with 8 devices: 8 +- 0.25); the totals equal the ordered sum of four
  unsharded passes with the same generators, bit for bit, on every rank.
* ``sharded_trace``: the data-parallel loss, histogram and pitch gradient
  equal the ordered sums of the four ranks' unsharded ones, bit for bit,
  on every rank.
"""
import torch_harness  # noqa: F401

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import CLEAN_ENV

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD = 4
TIMEOUT = 240


def _kill(p):
    if p.poll() is None:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()


def _finish(p, what, deadline):
    try:
        out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        _kill(p)
        raise AssertionError(f'{what} did not finish in {TIMEOUT} s')
    assert p.returncode == 0, f'{what} failed:\n{out}\n{err}'


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp('parallel')
    samples = str(d / 'samples.npz')
    jres = {part: str(d / f'jax_{part}.npz') for part in ('chains', 'grad')}
    env = dict(CLEAN_ENV)
    env['XLA_FLAGS'] += ' --xla_backend_optimization_level=0'
    deadline = time.time() + TIMEOUT

    def start(args, env):
        return subprocess.Popen(
            [sys.executable] + args, env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
    ref = os.path.join(HERE, 'jax_parallel_ref.py')
    procs = {'the JAX chains': start([ref, 'chains', samples,
                                      jres['chains']], env),
             'the JAX integrals and gradient': start([ref, 'grad',
                                                      jres['grad']], env)}
    try:
        jchains = procs['the JAX chains']
        while not os.path.exists(samples):
            if jchains.poll() is not None or time.time() > deadline:
                _finish(jchains, 'the JAX chains', deadline)
                raise AssertionError('the JAX chains wrote no samples')
            time.sleep(0.2)
        tenv = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=ROOT)
        procs['the gloo world'] = start(
            [os.path.join(HERE, 'torch_ranks.py'), samples, str(d)], tenv)
        for what in ('the gloo world', 'the JAX chains',
                     'the JAX integrals and gradient'):
            _finish(procs[what], what, deadline)
    finally:
        for p in procs.values():
            _kill(p)
    ranks = [dict(np.load(str(d / f'rank{r}.npz'))) for r in range(WORLD)]
    return ranks, {k: v for path in jres.values()
                   for k, v in np.load(path).items()}


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


KIRCHHOFF = [(w, n) for w in (2, 3, 4)
             for n in ('sharded', 'ring', 'call', 'call_ring')]


@pytest.mark.parametrize('world,name', KIRCHHOFF,
                         ids=[f'{n}-w{w}' for w, n in KIRCHHOFF])
def test_sharded_kirchhoff_matches_unsharded(runs, world, name):
    ranks, jax_out = runs
    single = ranks[0]['kirchhoff_single']
    assert rel(single, jax_out['single']) < 1e-12
    for r in range(world):
        got = ranks[r][f'kirchhoff_{name}_w{world}']
        assert got.shape == single.shape
        assert rel(got, single) < 1e-12, (r, rel(got, single))
        assert rel(got, jax_out['single']) < 1e-12
        assert rel(got, jax_out[name]) < 1e-6
    for r in range(world, WORLD):
        assert f'kirchhoff_{name}_w{world}' not in ranks[r]


@pytest.mark.parametrize('world', (2, 3, 4))
def test_ring_gradient_matches_unsharded(runs, world):
    ranks, _ = runs
    for key in ('Es', 'xd'):
        ref = ranks[0][f'single_grad_{key}']
        for r in range(world):
            got = ranks[r][f'ring_grad_{key}_w{world}']
            assert rel(got, ref) < 1e-12, (key, r, rel(got, ref))
    assert ranks[0][f'bytes_w{world}'] > 0


@pytest.mark.parametrize('tag,limit', (('f64', 1e-12), ('f32', 5e-3)))
@pytest.mark.parametrize('how', ('mesh', 'ring'))
def test_wavechain_build_mesh_matches_unsharded(runs, tag, limit, how):
    ranks, _ = runs
    ref = ranks[0][f'chain_{tag}_single']
    assert np.all(np.isfinite(ref)) and ref.max() > 0
    for r in range(WORLD):
        assert rel(ranks[r][f'chain_{tag}_{how}'], ref) < limit
        assert rel(ranks[r][f'hops_{tag}_{how}'],
                   ranks[0][f'hops_{tag}_single']) < limit


@pytest.mark.parametrize('tag,limit', (('f64', 1e-6), ('f32', 5e-3)))
@pytest.mark.parametrize('how', ('mesh', 'ring'))
def test_sharded_chain_matches_jax_sharded_chain(runs, tag, limit, how):
    ranks, jax_out = runs
    got = ranks[0][f'hops_{tag}_{how}']
    assert rel(got, jax_out[f'chain_{tag}_{how}']) < limit


@pytest.mark.parametrize('how', ('mesh', 'ring'))
def test_sharded_diffract_gradient_f64(runs, how):
    ranks, jax_out = runs
    loss, grad = ranks[0]['grad_f64_single']
    jloss, jgrad = jax_out['grad_f64']
    assert abs(loss - jloss) <= 1e-9 * abs(jloss)
    assert abs(grad - jgrad) <= 1e-9 * abs(jgrad)
    for r in range(WORLD):
        l_, g_ = ranks[r][f'grad_f64_{how}']
        assert abs(l_ - loss) <= 1e-12 * abs(loss)
        assert abs(g_ - grad) <= 1e-12 * abs(grad), (r, g_, grad)
        assert abs(g_ - jgrad) <= 1e-9 * abs(jgrad)


@pytest.mark.parametrize('how', ('mesh', 'ring'))
def test_sharded_diffract_gradient_f32(runs, how):
    ranks, _ = runs
    loss, grad = ranks[0]['grad_f32_single']
    for r in range(WORLD):
        l_, g_ = ranks[r][f'grad_f32_{how}']
        assert abs(l_ - loss) <= 1e-4 * abs(loss)
        assert abs(g_ - grad) <= 1e-4 * abs(grad), (r, g_, grad)
        assert np.array_equal(ranks[r][f'grad_f32_{how}'],
                              ranks[0][f'grad_f32_{how}'])


def test_sharded_run_ray_tracing_flux(runs):
    ranks, _ = runs
    ratio = float(ranks[0]['mesh_intensity'] / ranks[0]['single_intensity'])
    assert abs(ratio - WORLD) < 0.25 * WORLD / 8, ratio
    tot = ranks[0]['mesh_total2D'].sum() / ranks[0]['single_total2D'].sum()
    assert abs(tot - WORLD) < 0.25 * WORLD / 8
    assert int(ranks[0]['mesh_nRaysAll']) == \
        WORLD * int(ranks[0]['single_nRaysAll'])


def test_sharded_run_ray_tracing_is_the_ordered_sum(runs):
    ranks, _ = runs
    keys = [k[len('ordered_'):] for k in ranks[0]
            if k.startswith('ordered_')]
    assert 'total2D' in keys and 'intensity' in keys
    for r in range(WORLD):
        for k in keys:
            assert np.array_equal(ranks[r][f'mesh_{k}'],
                                  ranks[0][f'ordered_{k}']), (r, k)


def test_data_parallel_gradient_is_the_ordered_sum(runs):
    ranks, _ = runs
    r0 = ranks[0]
    assert r0['dp_ref_grad'] != 0 and np.isfinite(r0['dp_ref_grad'])
    for r in range(WORLD):
        for k in ('loss', 'hist', 'grad'):
            assert np.array_equal(ranks[r][f'dp_{k}'], r0[f'dp_ref_{k}']), \
                (r, k)


def test_make_mesh_needs_an_initialized_group():
    from xrt_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match='init_process_group'):
        make_mesh(device='cpu')


def test_mesh_does_not_combine_with_tiles():
    from xrt_tpu_torch import waves as tw
    from xrt_tpu_torch.wavechain import WaveChain
    with pytest.raises(ValueError, match='tile_modes'):
        tw.diffract(None, None, tile_modes=[[('fast', 'vpu')]],
                    mesh=object())
    with pytest.raises(ValueError, match='tiled'):
        WaveChain(None).build(tiled=True, mesh=object(), device='cpu')


def test_split_generator_is_a_function_of_the_state():
    from xrt_tpu_torch.parallel import split_generator
    a = split_generator(torch.Generator().manual_seed(7), 3)
    b = split_generator(torch.Generator().manual_seed(7), 3)
    da = [torch.rand(4, generator=g) for g in a]
    db = [torch.rand(4, generator=g) for g in b]
    assert all(torch.equal(x, y) for x, y in zip(da, db))
    assert not torch.equal(da[0], da[1])
