"""The Gaussian -> slit -> toroid -> screen chain: the port against the
JAX package's WaveChain.

The chain of the JAX package's ``test_wavechain_sharded.py`` (nrays 601,
41 screen points), on one device.  JAX's own receiver samples
(``run.waves``) are carried into the port through
``prepare_wave_on_*(samples=...)``, the elements are rebuilt from the same
``create(...)`` arguments, and the port drives the chain hop by hop.

* float64: the JAX chain runs with jit disabled, so both sides execute the
  same IEEE operations one by one; tolerance max|dI| / max I < 1e-9
  (measured ~1e-15).  Under jit XLA contracts a*a + b*b into FMAs and
  the JAX chain itself moves by ~5e-7 (one ulp of r is ~1e-6 rad here).
* float32 (the plain versions of the double-float kernels, on the CPU)
  against the JAX float64 result: < 5e-3, the float32 tolerance of the
  JAX package's chain tests.
* The port's ``WaveChain.build/run`` gives the hop-by-hop result for one
  generator seed.
"""
import math

import numpy as np
import pytest
import torch
import jax

import xrt_tpu.materials as jm
from xrt_tpu.apertures import RectangularAperture as JSlit
from xrt_tpu.oes import ToroidMirror as JToroid
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu.sources import GaussianBeam as JGauss
from xrt_tpu.wavechain import WaveChain as JChain
from xrt_tpu_torch import waves as tw
from xrt_tpu_torch.apertures import RectangularAperture
from xrt_tpu_torch.materials import Material
from xrt_tpu_torch.oes import ToroidMirror
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import GaussianBeam
from xrt_tpu_torch.wavechain import WaveChain

E0 = 500.0
P, Q, PITCH = 5000.0, 1000.0, 6e-3
R = 2 * P * Q / (P + Q) / math.sin(PITCH)
r = 2 * P * Q / (P + Q) * math.sin(PITCH)
SCR = dict(center=(0, P + Q * math.cos(2 * PITCH), Q * math.sin(2 * PITCH)),
           z=(0, -math.sin(2 * PITCH), math.cos(2 * PITCH)))
SRC = dict(w0=0.05, distE='lines', energies=(E0,), polarization='horizontal')
SLIT = dict(center=(0, 0, 0), opening=(-0.3, 0.3, -0.15, 0.15))
TOR = dict(center=(0, P, 0), pitch=PITCH, R=R, r=r, limPhysX=(-3, 3),
           limPhysY=(-40, 40))
XS = np.asarray([0.0])
ZS = np.linspace(-0.02, 0.02, 41)


def elements(dtype):
    mat = Material.create('Au', rho=19.3, kind='mirror', dtype=dtype,
                          device='cpu')
    return (GaussianBeam.create(**SRC), RectangularAperture.create(**SLIT),
            ToroidMirror.create(material=mat, **TOR), Screen.create(**SCR))


@pytest.fixture(scope='module')
def jax_chain():
    mat = jm.Material.create('Au', rho=19.3, kind='mirror')
    chain = (JChain(JGauss.create(**SRC), nrays=601, fixedEnergy=E0)
             .through_aperture(JSlit.create(**SLIT))
             .through_oe(JToroid.create(material=mat, **TOR))
             .to_screen(JScreen.create(**SCR), XS, ZS))
    with jax.disable_jit():
        run = chain.build(jax.random.PRNGKey(5))
        wave, logs = run()
    I = JChain.absolute_intensity(wave, logs)
    assert I.max() > 0
    return run, I


def drive_hops(dtype, waves_np, modes):
    """The port's chain hop by hop on the given receiver samples."""
    src, slit, tor, scr = elements(dtype)
    w0, w1 = waves_np
    a = tw.prepare_wave_on_aperture(slit, src, 0, samples=w0, dtype=dtype,
                                    device='cpu')
    b = tw.prepare_wave_on_oe(tor, slit, 0, samples=w1, dtype=dtype,
                              device='cpu')
    c = tw.prepare_wave_on_screen(scr, tor, XS, ZS, dtype=dtype,
                                  device='cpu')
    f32 = dtype == torch.float32
    logs = torch.zeros((), dtype=dtype)     # the chain's log-scale sum
    cur = src.shine(torch.Generator().manual_seed(0), a)
    if f32:
        cur, ls = tw.rescale_field(cur)
        logs = logs + ls
    hop = tw.diffract(cur, b, phase_mode=modes[1][0], monochromatic=True,
                      accumulate=modes[1][1], narrowband=False)
    _, cur = tw.reflect_wave(tor, hop)
    if f32:
        cur, ls = tw.rescale_field(cur)
        logs = logs + ls
    out = tw.diffract(cur, c, phase_mode=modes[2][0], monochromatic=True,
                      accumulate=modes[2][1], narrowband=False)
    return WaveChain.absolute_intensity(out, logs)


def jax_samples(run):
    w0, w1, _ = run.waves
    return ((np.asarray(w0.x), np.asarray(w0.z)),
            (np.asarray(w1.x), np.asarray(w1.y), np.asarray(w1.z)))


def test_chain_f64_matches_jax(jax_chain):
    run, I_ref = jax_chain
    I = drive_hops(torch.float64, jax_samples(run), run.modes)
    err = float(np.max(np.abs(I - I_ref)) / np.max(I_ref))
    assert err < 1e-9, err


def test_chain_f32_plain_matches_jax_f64(jax_chain):
    run, I_ref = jax_chain
    I = drive_hops(torch.float32, jax_samples(run), run.modes)
    assert np.all(np.isfinite(I))
    err = float(np.max(np.abs(I - I_ref)) / np.max(I_ref))
    assert err < 5e-3, err


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_wavechain_build_run_matches_hop_by_hop(jax_chain, dtype):
    """WaveChain.build/run against the hop-by-hop drive on the chain's own
    samples (one generator seed); the same operations, so equal to
    rounding.  The modes match the JAX chain's on its geometry."""
    run_j, _ = jax_chain
    src, slit, tor, scr = elements(dtype)
    chain = (WaveChain(src, nrays=601, fixedEnergy=E0)
             .through_aperture(slit).through_oe(tor)
             .to_screen(scr, XS, ZS))
    run = chain.build(torch.Generator().manual_seed(11), dtype=dtype,
                      device='cpu')
    assert run.modes == run_j.modes
    timings = []
    wave, logs = run(torch.Generator().manual_seed(0), timings=timings)
    I = WaveChain.absolute_intensity(wave, logs)
    assert [t['hop'] for t in timings] == [1, 2]
    w0, w1, _ = run.waves
    ref = drive_hops(dtype, ((w0.x.numpy(), w0.z.numpy()),
                             (w1.x.numpy(), w1.y.numpy(), w1.z.numpy())),
                     run.modes)
    err = float(np.max(np.abs(I - ref)) / np.max(ref))
    assert err < 1e-12, err
    # one seed, one set of receiver samples
    run2 = chain.build(torch.Generator().manual_seed(11), dtype=dtype,
                       device='cpu')
    assert torch.equal(run2.waves[1].x, w1.x)
