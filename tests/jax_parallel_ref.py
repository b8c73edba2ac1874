"""The JAX package's side of ``tests/test_torch_parallel.py``, run in two
concurrent subprocesses with eight CPU devices each:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/jax_parallel_ref.py chains SAMPLES.npz RESULTS.npz
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/jax_parallel_ref.py grad RESULTS.npz

``chains`` first writes *SAMPLES.npz*: the receiver samples and kernel
modes of the Gaussian -> slit -> toroid -> screen chain of
``tests/test_wavechain_sharded.py`` (nrays 601, key 5) in float32 and
float64, which the port's ranks then use; then *RESULTS.npz*: the chain's
intensity sharded and with the ring, in float64 and float32.  ``grad``
writes *RESULTS.npz*: the Kirchhoff integral of
``tests/test_parallel_kirchhoff.py``'s inputs on one device under
``jax.disable_jit()`` and sharded over the eight devices
(``kirchhoff_sharded``, ``kirchhoff_ring``, ``dst_sharded_call`` with and
without the ring), and ``jax.grad`` of the summed intensity of the source
field diffracted onto the toroid's samples (the same chain, built again
with the same key) with respect to the Gaussian waist, unsharded, under
``jax.disable_jit()``, float64.  The float32 chain needs XLA:CPU at O0
(``conftest.run_in_clean_env``).
"""
import math
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

import xrt_tpu.materials as xm
from xrt_tpu import waves as jw
from xrt_tpu.apertures import RectangularAperture
from xrt_tpu.oes import ToroidMirror
from xrt_tpu.parallel import (dst_sharded_call, kirchhoff_ring,
                              kirchhoff_sharded, make_mesh)
from xrt_tpu.screens import Screen
from xrt_tpu.sources import GaussianBeam
from xrt_tpu.wavechain import WaveChain

E0 = 500.0
P, Q, PITCH = 5000.0, 1000.0, 6e-3


def chain_elements():
    mat = xm.Material.create('Au', rho=19.3, kind='mirror')
    R = 2 * P * Q / (P + Q) / math.sin(PITCH)
    r = 2 * P * Q / (P + Q) * math.sin(PITCH)
    src = GaussianBeam.create(w0=0.05, distE='lines', energies=(E0,),
                              polarization='horizontal')
    slit = RectangularAperture.create(center=(0, 0, 0),
                                      opening=(-0.3, 0.3, -0.15, 0.15))
    tor = ToroidMirror.create(center=(0, P, 0), pitch=PITCH, R=R, r=r,
                              material=mat, limPhysX=(-3, 3),
                              limPhysY=(-40, 40))
    scr = Screen.create(
        center=(0, P + Q * math.cos(2 * PITCH), Q * math.sin(2 * PITCH)),
        z=(0, -math.sin(2 * PITCH), math.cos(2 * PITCH)))
    return src, slit, tor, scr


def build(els, **kw):
    src, slit, tor, scr = els
    return (WaveChain(src, nrays=601, fixedEnergy=E0)
            .through_aperture(slit).through_oe(tor)
            .to_screen(scr, np.asarray([0.0]), np.linspace(-0.02, 0.02, 41))
            ).build(jax.random.PRNGKey(5), **kw)


def samples(run, tag):
    w0, w1, _ = run.waves
    return {f'{tag}_w0x': np.asarray(w0.x, np.float64),
            f'{tag}_w0z': np.asarray(w0.z, np.float64),
            f'{tag}_w1x': np.asarray(w1.x, np.float64),
            f'{tag}_w1y': np.asarray(w1.y, np.float64),
            f'{tag}_w1z': np.asarray(w1.z, np.float64),
            f'{tag}_mode1': np.asarray(run.modes[1]),
            f'{tag}_mode2': np.asarray(run.modes[2])}


def intensity(run):
    wave, logs = run()
    return WaveChain.absolute_intensity(wave, logs)


def kirchhoff(out, mesh):
    rng = np.random.default_rng(0)
    Ns, Nd = 700, 333
    xs = jnp.asarray(rng.uniform(-1, 1, Ns))
    ys = jnp.asarray(rng.uniform(-1, 1, Ns))
    zs = jnp.asarray(rng.uniform(-0.01, 0.01, Ns))
    xd = jnp.asarray(rng.uniform(-0.5, 0.5, Nd))
    yd = jnp.asarray(rng.uniform(-0.5, 0.5, Nd)) + 100.0
    zd = jnp.asarray(rng.uniform(-0.5, 0.5, Nd))
    Es = jnp.asarray(rng.normal(size=Ns) + 1j * rng.normal(size=Ns))
    Ep = jnp.asarray(rng.normal(size=Ns) + 1j * rng.normal(size=Ns))
    k = jnp.full((Ns,), 2 * np.pi / 1.5e-7)
    n = [jnp.zeros(()), jnp.zeros(()), jnp.ones(())]
    nl = jnp.asarray(rng.uniform(0.7, 1.0, Ns))
    w = jnp.asarray((rng.uniform(size=Ns) > 0.1).astype(float))
    nb = [jnp.broadcast_to(v, (Ns,)) for v in n]
    args = (xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, w)
    with jax.disable_jit():
        out['single'] = np.stack(jw.kirchhoff_integral_xla(
            xd, yd, zd, xs, ys, zs, Es, Ep, k, nb, nl, w))
    out['sharded'] = np.stack(kirchhoff_sharded(mesh, *args))
    out['ring'] = np.stack(kirchhoff_ring(mesh, *args))

    def flat(xd_, yd_, zd_, xs_, ys_, zs_, Es_, Ep_, k_, n0, n1, n2, nl_,
             w_):
        return jw.kirchhoff_integral_xla(xd_, yd_, zd_, xs_, ys_, zs_, Es_,
                                         Ep_, k_, [n0, n1, n2], nl_, w_)
    pad = ['edge'] * 3 + ['zero', 'zero', 'edge'] + ['edge'] * 3 + \
        ['edge', 'zero']
    srcs = [xs, ys, zs, Es, Ep, k, *nb, nl, w]
    out['call'] = np.stack(jax.jit(lambda: dst_sharded_call(
        mesh, flat, [xd, yd, zd], srcs))())
    out['call_ring'] = np.stack(jax.jit(lambda: dst_sharded_call(
        mesh, flat, [xd, yd, zd], srcs, ring=True, src_pad=pad))())


def wave_grad(els, run):
    """d sum(Jss + Jpp) / d w0 through the unsharded diffract onto the
    toroid's samples, eagerly."""
    gsrc = els[0]
    wvs = run.waves

    def loss(w0):
        srcw = gsrc.replace(w0=w0).shine(jax.random.PRNGKey(3), wvs[0],
                                         toGlobal=False)
        out = jw.diffract(srcw, wvs[1])
        return jnp.sum(out.Jss + out.Jpp)
    with jax.disable_jit():
        v, g = jax.value_and_grad(loss)(jnp.asarray(0.05, jnp.float64))
    return np.asarray([float(v), float(g)])


def chains(samples_path, results_path):
    mesh = make_mesh()
    jax.config.update('jax_enable_x64', False)
    els32 = chain_elements()
    runs32 = {m: build(els32, mesh=mesh, ring=m == 'ring')
              for m in ('mesh', 'ring')}
    jax.config.update('jax_enable_x64', True)
    els64 = chain_elements()
    runs64 = {m: build(els64, mesh=mesh, ring=m == 'ring')
              for m in ('mesh', 'ring')}
    tmp = samples_path + '.tmp.npz'
    np.savez(tmp, **samples(runs32['mesh'], 'f32'),
             **samples(runs64['mesh'], 'f64'))
    os.replace(tmp, samples_path)
    out = {}
    for m, run in runs64.items():
        out[f'chain_f64_{m}'] = intensity(run)
    jax.config.update('jax_enable_x64', False)
    for m, run in runs32.items():
        out[f'chain_f32_{m}'] = intensity(run)
    np.savez(results_path, **out)


def grad(results_path):
    mesh = make_mesh()
    jax.config.update('jax_enable_x64', True)
    out = {}
    kirchhoff(out, mesh)
    els64 = chain_elements()
    out['grad_f64'] = wave_grad(els64, build(els64, mesh=mesh))
    np.savez(results_path, **out)


if __name__ == '__main__':
    assert jax.device_count() == 8, jax.devices()
    {'chains': chains, 'grad': grad}[sys.argv[1]](*sys.argv[2:])
