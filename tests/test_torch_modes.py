"""The port's coherent-mode pipeline against the JAX package.

* ``solve_modes`` on the same numpy filament fields as the JAX package:
  the eigenvalues to 1e-12, the total flux to 1e-13, and each mode above
  1e-8 of the largest weight collinear with the JAX package's and of the
  same norm to 1e-9 (eigenvectors are defined up to a phase).
* Fields and modes carried across: the JAX package's
  ``make_and_save_modes`` writes its pickle, the port's ``use_saved``
  reads it, and one Kirchhoff hop of every mode and saved field from the
  slit onto a screen in both packages (float64, the JAX package eagerly)
  agrees to 1e-9 of the largest field.
* The port's own ``make_and_save_modes`` on ``tests/test_modes.py``'s
  beamline: the weights sum to 1 and come in order, each mode's squared
  norm is its weight, and the pickle goes round through the port's and
  the JAX package's ``use_saved``.  (``tests/test_modes.py``'s w0 > 0.25
  and w0 > 1.2 w1 depend on the draws at 12 electrons: the JAX package
  gives w0 = 0.23 to 0.55 over keys 0 to 5, the port 0.23 to 0.79 over
  seeds 0 to 5, so they are not held here; phase 18 of ``chip_smoke.py``
  holds them at 256 electrons.)
"""
import torch_harness  # noqa: F401

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from xrt_tpu import modes as jmodes
from xrt_tpu import waves as jw
from xrt_tpu.apertures import RectangularAperture as JSlit
from xrt_tpu.beamline import BeamLine as JBeamLine
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu.sources import Undulator as JUndulator
from xrt_tpu_torch import modes as tmodes
from xrt_tpu_torch import waves as tw
from xrt_tpu_torch.apertures import RectangularAperture
from xrt_tpu_torch.beamline import BeamLine
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import Undulator

F64 = torch.float64
CPU = dict(dtype=F64, device='cpu')
E0 = 9300.0
#: tests/test_modes.py's source and front-end slit
UND = dict(nrays=1000, eE=6.0, eI=0.1, eEpsilonX=0.3, eEpsilonZ=0.01,
           betaX=9., betaZ=2., period=33.0, n=50, K=1.5, eMin=9290,
           eMax=9310, xPrimeMax=0.02, zPrimeMax=0.02, gNodes=200,
           gIntervals=2)
SLIT = dict(center=(0, 20000.0, 0), opening=(-0.2, 0.2, -0.2, 0.2))


def _collinear(a, b, rtol):
    ip = np.vdot(b, a)
    na, nb = np.vdot(a, a).real, np.vdot(b, b).real
    np.testing.assert_allclose(abs(ip) ** 2, na * nb, rtol=rtol)
    np.testing.assert_allclose(na, nb, rtol=rtol)


@pytest.mark.parametrize('phase', [0.0, 0.7])
def test_solve_modes_matches_jax(phase):
    rng = np.random.default_rng(11)
    ns, ne = 300, 9
    base = np.exp(1j * rng.uniform(0, 6, ns))
    fields = [(base * (1 + 0.3 * rng.normal()) +
               0.2 * (rng.normal(size=ns) + 1j * rng.normal(size=ns)),
               0.1 * (rng.normal(size=ns) + 1j * rng.normal(size=ns)))
              for _ in range(ne)]
    modes, w, flux = tmodes.solve_modes(
        [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in fields], 4,
        phase)
    jm, jwv, jflux = jmodes.solve_modes(
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in fields], 4, phase)
    np.testing.assert_allclose(w.numpy(), np.asarray(jwv), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(float(flux), float(jflux), rtol=1e-13)
    np.testing.assert_allclose(float(w.sum()), 1.0, rtol=1e-12)
    assert len(modes) == 4
    wmax = float(w.max())
    for i, ((ms, mp), (js, jp)) in enumerate(zip(modes, jm)):
        if float(w[-1 - i]) < 1e-8 * wmax:
            continue
        both_t = np.concatenate([ms.numpy(), mp.numpy()])
        both_j = np.concatenate([np.asarray(js), np.asarray(jp)])
        _collinear(both_t, both_j, 1e-9)
    assert len(tmodes.solve_modes(
        [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in fields],
        20)[0]) == ne


def _jax_line(nsamples, nElectrons, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bl = JBeamLine(alignE=E0)
    bl.add('source', JUndulator.create(**UND))
    bl.add('slitFE', JSlit.create(**SLIT))
    out = jmodes.make_and_save_modes(
        bl, nsamples, nElectrons, nElectronsSave=2, nModes=3,
        fixedEnergy=E0, key=jax.random.PRNGKey(0))
    return bl, out


def _port_line():
    bl = BeamLine(alignE=E0)
    bl.add('source', Undulator.create(**UND, **CPU))
    bl.add('slitFE', RectangularAperture.create(**SLIT))
    return bl


def test_saved_modes_carried_across_and_propagated(tmp_path, monkeypatch):
    jbl, (jm, jwAll, jflux, _) = _jax_line(200, 5, tmp_path, monkeypatch)
    bl = _port_line()
    scr_kw = dict(center=(0, 21000.0, 0))
    dim = np.linspace(-0.3, 0.3, 9)
    for what, n in (('wave-modes', 3), ('wave-fields', 2)):
        tws, twAll, tflux = tmodes.use_saved(
            what, 'local', slit=bl.slits[0], source=bl.sources[0],
            outdir=str(tmp_path), **CPU)
        jws, jwAll2, jflux2 = jmodes.use_saved(
            what, 'local', slit=jbl.slits[0], source=jbl.sources[0])
        assert len(tws) == len(jws) == n
        np.testing.assert_array_equal(twAll, np.asarray(jwAll))
        assert tflux == pytest.approx(float(jflux), rel=1e-15)
        for t, j in zip(tws, jws):
            np.testing.assert_array_equal(t.Es.numpy(), np.asarray(j.Es))
            tscr = tw.prepare_wave_on_screen(Screen.create(**scr_kw),
                                             bl.slits[0], dim, dim, **CPU)
            with jax.disable_jit():
                jscr = jw.prepare_wave_on_screen(JScreen.create(**scr_kw),
                                                 jbl.slits[0], dim, dim)
                jout = jw.diffract(j, jscr)
            tout = tw.diffract(t, tscr)
            for f in ('Es', 'Ep'):
                ref = np.asarray(getattr(jout, f))
                got = getattr(tout, f).numpy()
                assert np.abs(got - ref).max() <= \
                    1e-9 * np.abs(jout.Es).max(), f


def test_port_make_and_save_modes_round_trip(tmp_path, monkeypatch):
    bl = _port_line()
    modes, wAll, flux, wave = tmodes.make_and_save_modes(
        bl, 400, 12, nElectronsSave=3, nModes=4, fixedEnergy=E0,
        generator=torch.Generator().manual_seed(0), outdir=str(tmp_path),
        **CPU)
    w = wAll.numpy()
    assert len(modes) == 4 and (w >= -1e-9).all()
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-6)
    assert w[-1] == w.max()
    # the modes are those of solve_modes on the filament fields: the
    # squared norm of Es + Ep of a mode is its weight times the trace of
    # the Gram matrix
    norms = np.array([float(torch.linalg.vector_norm(m[0] + m[1])) ** 2
                      for m in modes])
    np.testing.assert_allclose(norms / norms.sum(),
                               w[::-1][:4] / w[::-1][:4].sum(), rtol=1e-9)
    assert np.isfinite(float(flux)) and float(flux) > 0
    saved, wAll2, flux2 = tmodes.use_saved('wave-modes', 'local',
                                           slit=bl.slits[0],
                                           source=bl.sources[0],
                                           outdir=str(tmp_path), **CPU)
    np.testing.assert_array_equal(wAll2, w)
    assert flux2 == float(flux)
    for m, s in zip(modes, saved):
        assert torch.equal(m[0], s.Es) and torch.equal(m[1], s.Ep)
        assert torch.equal(s.x, wave.x) and torch.equal(s.dS, wave.dS)
        assert s.toOE is bl.slits[0] and s.fromOE is bl.sources[0]
    fields, _, _ = tmodes.use_saved('wave-fields', 'local',
                                    outdir=str(tmp_path), **CPU)
    assert len(fields) == 3
    # the JAX package reads the port's pickle
    monkeypatch.chdir(tmp_path)
    jsaved, jw_, _ = jmodes.use_saved('wave-modes', 'local')
    np.testing.assert_array_equal(np.asarray(jsaved[0].Es),
                                  saved[0].Es.numpy())
    # float32 waves from the same pickle
    s32, _, _ = tmodes.use_saved('wave-modes', 'local',
                                 outdir=str(tmp_path), dtype=torch.float32,
                                 device='cpu')
    assert s32[0].Es.dtype == torch.complex64 and s32[0].x.dtype == \
        torch.float32
