"""The ray-trace slice as a whole against the JAX package.

A ``GeometricSource.shine`` of the JAX package is dumped to numpy and
carried across by ``interop.beam_from_numpy``; then ``toroid.reflect``
(with the intersection search) -> ``screen.expose`` -> ``histogram_plot``
run in both packages, JAX eagerly in float64 under ``jax.disable_jit()``.

* float64: every beam field to 1e-9 relative to the field's largest value
  (the coherency elements Jss, Jpp, Jsp relative to the largest of the
  three: Jpp of a horizontally polarized beam is rounding leakage of
  ~1e-13), ``state`` identical, every histogram to 1e-9 of its largest
  bin, counters equal.
* float32 against the JAX float64 trace, at the tolerances of the JAX
  package's own float32 trace check (``tests/test_tpu_f32_accuracy.py``):
  flux to 1e-2, centroids to 1e-2 of the image size, sizes to 2e-2, with
  the Rh coating of the golden configuration.  With the Si coating, whose
  critical angle (3.5 mrad at 9 keV) lies just below the 4 mrad of
  incidence, the float32 flux is held to 3e-2 only: both packages take
  cos(beta)^2 = 1 - sin^2(alpha) / n^2 as a difference of numbers near 1,
  which float32 knows to 6e-8 where the result is 4e-6 (measured 2.1e-2).
* ``run_ray_tracing``: accumulation over 3 repeats and over a 2-point
  scan, auto limits from the calibration pass, persistence and the run
  history.
* the port with its own random numbers against the golden image moments
  of the reference ray tracer (``tests/golden/ref_trace_config1.npz``), at
  the tolerances of ``tests/test_trace_parity.py``.
"""
import torch_harness  # noqa: F401

import math
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import xrt_tpu.materials as jm
from xrt_tpu import plotspec as jps, runner as jrunner
from xrt_tpu.oes import ToroidMirror as JToroid
from xrt_tpu.screens import Screen as JScreen
from xrt_tpu.sources import GeometricSource as JSource
from xrt_tpu_torch import interop, plotspec as tps, runner as trunner
from xrt_tpu_torch.materials import Material
from xrt_tpu_torch.oes import ToroidMirror
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import GeometricSource

E0, P, Q, PITCH = 9000.0, 10000.0, 2000.0, 4e-3
SRC = dict(dx=0.1, dz=0.05, dxprime=3e-5, dzprime=3e-5, distE='flat',
           energies=(E0 - 100, E0 + 100), polarization='horizontal')
TOR = dict(center=(0, P, 0), pitch=PITCH,
           R=2 * P * Q / (P + Q) / math.sin(PITCH),
           r=2 * P * Q / (P + Q) * math.sin(PITCH),
           limPhysX=(-20, 20), limPhysY=(-300, 300))
SCR = dict(center=(0, P + Q, 2 * PITCH * Q))
BEAM_FIELDS = ('x', 'y', 'z', 'a', 'b', 'c', 'E', 'path', 'Jss', 'Jpp',
               'Jsp')
HISTS = ('xh', 'xhRGB', 'yh', 'yhRGB', 'eh', 'ehRGB', 'xyh', 'xyhRGB')


def make_plot(mod):
    return mod.XYCPlot(
        beam='screen',
        xaxis=mod.XYCAxis('x', 'mm', bins=32, limits=[-0.5, 0.5]),
        yaxis=mod.XYCAxis('z', 'mm', bins=24, limits=[-0.6, 0.4]),
        caxis=mod.XYCAxis('energy', 'eV', bins=16,
                          limits=[E0 - 110, E0 + 110]))


COATINGS = {'Si': 2.33, 'Rh': 12.41}


def _jax_trace(coating):
    mat = jm.Material.create(coating, rho=COATINGS[coating], kind='mirror')
    src = JSource.create(nrays=4000, **SRC)
    tor = JToroid.create(material=mat, **TOR)
    scr = JScreen.create(**SCR)
    with jax.disable_jit():
        beam = src.shine(jax.random.PRNGKey(7))
        glo, loc = tor.reflect(beam)
        img = scr.expose(glo)
        hists = jrunner.histogram_plot(make_plot(jps), {'screen': img})
    dump = {f: np.asarray(getattr(beam, f)) for f in BEAM_FIELDS + ('state',)}
    return dump, glo, loc, img, hists


@pytest.fixture(scope='module')
def jax_trace():
    """The JAX trace of 4000 rays in float64, eager: source beam as numpy,
    the beams after each element, the histograms of one plot."""
    return _jax_trace('Si')


def torch_trace(dump, dtype, coating='Si'):
    mat = Material.create(coating, rho=COATINGS[coating], kind='mirror',
                          dtype=dtype, device='cpu')
    tor = ToroidMirror.create(material=mat, **TOR)
    scr = Screen.create(**SCR)
    beam = interop.beam_from_numpy(dump, device='cpu', dtype=dtype)
    glo, loc = tor.reflect(beam)
    img = scr.expose(glo)
    return glo, loc, img


def close(t, j, tol):
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-300)
    assert float(np.abs(t - j).max()) / scale < tol


def test_carried_beam_has_int32_state(jax_trace):
    dump = jax_trace[0]
    beam = interop.beam_from_numpy(dict(dump, state=dump['state'].astype(
        np.int64)), device='cpu', dtype=torch.float64)
    assert beam.state.dtype == torch.int32
    assert beam.x.dtype == torch.float64 and beam.Jsp.dtype == \
        torch.complex128
    back = interop.to_numpy(beam)
    np.testing.assert_array_equal(back['x'], dump['x'])


@pytest.mark.parametrize('which', ['global', 'local', 'image'])
def test_trace_f64_beams_match_jax(jax_trace, which):
    dump, jglo, jloc, jimg, _ = jax_trace
    tglo, tloc, timg = torch_trace(dump, torch.float64)
    t, j = {'global': (tglo, jglo), 'local': (tloc, jloc),
            'image': (timg, jimg)}[which]
    np.testing.assert_array_equal(t.state.numpy(), np.asarray(j.state))
    assert 0.9 < float((t.state == 1).double().mean()) < 1.0
    jmax = max(float(np.abs(np.asarray(getattr(j, f))).max())
               for f in ('Jss', 'Jpp', 'Jsp'))
    for f in BEAM_FIELDS:
        if f.startswith('J'):
            d = np.abs(getattr(t, f).numpy() - np.asarray(getattr(j, f)))
            assert d.max() < 1e-9 * jmax, f
        else:
            close(getattr(t, f), getattr(j, f), 1e-9)
    if which == 'local':
        close(t.theta, j.theta, 1e-9)


def test_histogram_plot_f64_matches_jax(jax_trace):
    dump, _, _, _, jh = jax_trace
    _, _, timg = torch_trace(dump, torch.float64)
    th = interop.hists_to_numpy(
        trunner.histogram_plot(make_plot(tps), {'screen': timg}))
    for k in HISTS:
        ref = np.asarray(jh[k])
        assert th[k].shape == ref.shape and ref.max() > 0
        assert np.abs(th[k] - ref).max() < 1e-9 * ref.max(), k
    assert abs(th['intensity'] - float(jh['intensity'])) < \
        1e-9 * float(jh['intensity'])
    for k, v in jh['counters'].items():
        assert th['counters'][k] == float(v), k
    assert th['counters']['nRaysAll'] == 4000


def _moments(x, z, w):
    cx, cz = np.average(x, weights=w), np.average(z, weights=w)
    return (w.sum(), cx, cz, np.sqrt(np.average((x - cx) ** 2, weights=w)),
            np.sqrt(np.average((z - cz) ** 2, weights=w)))


@pytest.mark.parametrize('coating,flux_tol', [('Rh', 1e-2), ('Si', 3e-2)])
def test_trace_f32_against_jax_f64(jax_trace, coating, flux_tol):
    dump, _, _, jimg, _ = jax_trace if coating == 'Si' else \
        _jax_trace(coating)
    _, _, timg = torch_trace(dump, torch.float32, coating)
    assert timg.x.dtype == torch.float32
    good_j = np.asarray(jimg.state) == 1
    good_t = timg.state.numpy() == 1
    assert (good_j != good_t).mean() < 1e-3
    ft, cxt, czt, sxt, szt = _moments(
        np.asarray(jimg.x)[good_j], np.asarray(jimg.z)[good_j],
        np.asarray(jimg.Jss + jimg.Jpp)[good_j])
    fd, cxd, czd, sxd, szd = _moments(
        timg.x.double().numpy()[good_t], timg.z.double().numpy()[good_t],
        (timg.Jss + timg.Jpp).double().numpy()[good_t])
    assert abs(fd / ft - 1) < flux_tol
    assert abs(cxd - cxt) < 1e-2 * sxt and abs(czd - czt) < 1e-2 * szt
    assert abs(sxd / sxt - 1) < 2e-2 and abs(szd / szt - 1) < 2e-2


def _port_beamline(nrays, dtype, material='Si', rho=2.33):
    mat = Material.create(material, rho=rho, kind='mirror', dtype=dtype,
                          device='cpu')
    src = GeometricSource.create(nrays=nrays, dtype=dtype, device='cpu',
                                 **SRC)
    tor = ToroidMirror.create(material=mat, **TOR)
    scr = Screen.create(**SCR)

    def run_process(beamLine, rng):
        glo, _ = tor.reflect(src.shine(rng))
        return {'screen': scr.expose(glo)}
    return run_process, tor


def _auto_plot():
    return tps.XYCPlot(beam='screen', xaxis=tps.XYCAxis('x', 'mm', bins=32),
                       yaxis=tps.XYCAxis('z', 'mm', bins=32),
                       caxis=tps.XYCAxis('energy', 'eV', bins=16))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_run_ray_tracing_accumulates_repeats(dtype):
    run_process, _ = _port_beamline(3000, dtype)
    plot = _auto_plot()
    out = trunner.run_ray_tracing(plot, repeats=3, run_process=run_process,
                                  rng=17, device='cpu')
    assert out == [plot]
    assert plot.repeats == 3 and plot.nRaysAll == 9000
    assert plot.nRaysGood + plot.nRaysOut + plot.nRaysOver + \
        plot.nRaysDead == 9000
    assert plot.nRaysGood > 0.9 * 9000 and plot.nRaysAlive >= plot.nRaysGood
    assert plot.intensity > 0 and np.isfinite(plot.intensity)
    # the limits are those of the calibration pass, so a few rays of the
    # later passes fall outside them
    for tot in (plot.total1D_x, plot.total1D_y, plot.total1D_c,
                plot.total2D):
        assert 0.995 * plot.intensity < tot.sum() <= \
            plot.intensity * (1 + 1e-5)
    assert plot.total2D_RGB.shape == (32, 32, 3)
    # limits came from the calibration pass and cover the image; the
    # equalized aspect makes both spans equal
    xl, yl = plot.xaxis.limits, plot.yaxis.limits
    assert xl[0] < plot.cx < xl[1] and yl[0] < plot.cy < yl[1]
    np.testing.assert_allclose(xl[1] - xl[0], yl[1] - yl[0], rtol=1e-12)
    assert 8880 < plot.caxis.limits[0] < 8900 < 9100 < \
        plot.caxis.limits[1] < 9120
    assert plot.dx > 0 and plot.dy > 0 and 150 < plot.dE < 220


def test_run_ray_tracing_scan_and_seed():
    """A 2-point generator scan accumulates 2 x repeats passes; the same
    seed gives the same plot, another seed another."""
    run_process, tor = _port_beamline(2000, torch.float64)
    pitches = []

    def scan(dp):
        for k in range(2):
            tor.pitch = PITCH + k * dp
            pitches.append(tor.pitch)
            yield

    plots = []
    done = []
    for seed in (5, 5, 6):
        plot = make_plot(tps)
        trunner.run_ray_tracing(
            plot, repeats=2, run_process=run_process, rng=seed,
            generator=scan, generatorArgs=(1e-6,), device='cpu',
            afterScript=done.append, afterScriptArgs=(seed,))
        plots.append(plot)
    tor.pitch = PITCH
    assert pitches[:2] == [PITCH, PITCH + 1e-6] and done == [5, 5, 6]
    assert plots[0].repeats == 4 and plots[0].nRaysAll == 8000
    # fixed limits that hold every ray: all totals are the intensity
    p0 = plots[0]
    for tot in (p0.total1D_x, p0.total1D_y, p0.total1D_c, p0.total2D):
        np.testing.assert_allclose(tot.sum(), p0.intensity, rtol=1e-12)
    np.testing.assert_allclose(p0.total2D.sum(axis=0), p0.total1D_x,
                               rtol=0, atol=1e-12 * p0.total1D_x.max())
    np.testing.assert_allclose(p0.total2D_RGB.sum(axis=1),
                               p0.total1D_y_RGB, rtol=0,
                               atol=1e-12 * p0.total1D_y_RGB.max())
    np.testing.assert_array_equal(plots[0].total2D, plots[1].total2D)
    assert plots[0].intensity == plots[1].intensity
    assert np.abs(plots[0].total2D - plots[2].total2D).max() > 0
    g = torch.Generator().manual_seed(5)        # an explicit generator
    plot = make_plot(tps)
    trunner.run_ray_tracing(plot, repeats=2, run_process=run_process, rng=g,
                            generator=scan, generatorArgs=(1e-6,))
    np.testing.assert_array_equal(plot.total2D, plots[0].total2D)


def test_run_ray_tracing_persistence_and_history(tmp_path):
    run_process, _ = _port_beamline(1000, torch.float64)
    plot = make_plot(tps)
    plot.persistentName = str(tmp_path / 'plot.pickle')
    hist = str(tmp_path / 'runs.pickle')
    trunner.run_ray_tracing(plot, repeats=2, run_process=run_process, rng=1,
                            device='cpu', pickleEvery=1, historyFile=hist,
                            historyTag='first')
    again = make_plot(tps)
    again.persistentName = plot.persistentName
    trunner.run_ray_tracing(again, repeats=1, run_process=run_process,
                            rng=2, device='cpu', historyFile=hist)
    assert again.repeats == 3 and again.nRaysAll == 3000
    runs = trunner.load_run_history(hist)
    assert len(runs) == 2 and runs[0][3] == 'first' and runs[0][2] >= 0
    assert trunner.load_run_history(str(tmp_path / 'none')) == []


@pytest.mark.parametrize('what', ['mesh', 'saveName', 'updateEvery',
                                  'generator'])
def test_run_ray_tracing_refuses_what_is_not_ported(what, tmp_path):
    """Sharding (``mesh=``) and rendering (``saveName``, ``updateEvery``)
    are ported now: they run (``tests/test_torch_parallel.py`` and
    ``tests/test_torch_host_modules.py`` hold their results).  What is
    still refused: a ``torch.Generator`` as ``generator=``, which is the
    scan generator function (the RNG goes in as ``rng=``)."""
    run_process, _ = _port_beamline(100, torch.float64)
    plot = make_plot(tps)
    if what == 'generator':
        with pytest.raises(TypeError):
            trunner.run_ray_tracing(plot, run_process=run_process,
                                    device='cpu',
                                    generator=torch.Generator())
        assert plot.repeats == 0
        return
    import torch.distributed as dist
    from xrt_tpu_torch.parallel import make_mesh
    kw = {}
    png = str(tmp_path / 'plot.png')
    if what == 'mesh':
        dist.init_process_group(
            'gloo', store=dist.FileStore(str(tmp_path / 'store'), 1),
            rank=0, world_size=1)
        kw['mesh'] = make_mesh(device='cpu')
    elif what == 'saveName':
        plot.saveName = png
    else:
        plot.saveName = png
        kw['updateEvery'] = 1
    try:
        trunner.run_ray_tracing(plot, repeats=2, run_process=run_process,
                                device='cpu', **kw)
    finally:
        if what == 'mesh':
            dist.destroy_process_group()
    assert plot.repeats == 2 and plot.nRaysAll == 200
    assert plot.intensity > 0
    assert os.path.exists(png) == (what != 'mesh')


def test_field_flux_kinds_give_mutual_intensity():
    """The 'E*' flux kinds: J2D / J4D are outer products of the
    histogrammed complex field, and accumulate over passes."""
    src = GeometricSource.create(nrays=500, dtype=torch.float64,
                                 device='cpu', **SRC)
    scr = Screen.create(center=(0, P, 0))

    def run_process(beamLine, rng):
        return {'screen': scr.expose(src.shine(rng, withAmplitudes=True))}
    for kind, attr, n in (('EsXX', 'totalJ2D', 8), ('Es4D', 'totalJ4D', 48),
                          ('EsPCA', 'fieldsPCA', 48)):
        plot = tps.XYCPlot(
            beam='screen', fluxKind=kind,
            xaxis=tps.XYCAxis('x', 'mm', bins=8, limits=[-1, 1]),
            yaxis=tps.XYCAxis('z', 'mm', bins=6, limits=[-1, 1]),
            caxis=tps.XYCAxis('energy', 'eV', bins=4, limits=[8800, 9200]))
        trunner.run_ray_tracing(plot, repeats=2, run_process=run_process,
                                rng=3, device='cpu')
        got = getattr(plot, attr)
        if attr == 'fieldsPCA':
            assert len(got) == 2 and got[0].shape == (n,)
        else:
            assert got.shape == (n, n) and np.iscomplexobj(got)
            np.testing.assert_allclose(got, got.conj().T, atol=1e-12)
            assert got.real.trace() > 0
        assert plot.total2D.sum() > 0


def test_port_trace_against_the_reference_golden():
    """The port with its own random numbers against the image moments of
    the reference ray tracer on the same beamline (Rh toroid), at the
    tolerances of tests/test_trace_parity.py."""
    g = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'golden', 'ref_trace_config1.npz'))
    nrays = int(g['nrays'])
    mat = Material.create('Rh', rho=12.41, dtype=torch.float64,
                          device='cpu')
    src = GeometricSource.create(nrays=nrays, dtype=torch.float64,
                                 device='cpu', **SRC)
    tor = ToroidMirror.create(material=mat, **TOR)
    glo, _ = tor.reflect(src.shine(torch.Generator().manual_seed(3)))
    img = Screen.create(**SCR).expose(glo)
    good = glo.state.numpy() == 1
    I = (img.Jss + img.Jpp).numpy()[good]
    x, z = img.x.numpy()[good], img.z.numpy()[good]
    assert abs(good.mean() - float(g['ngood_frac'])) < 2e-3
    assert abs(I.sum() / float(g['flux']) - 1) < 0.005
    _, xm, zm, xs, zs = _moments(x, z, I)
    assert abs(xm - float(g['x_mean'])) < 5 * xs / math.sqrt(len(x))
    assert abs(zm - float(g['z_mean'])) < 5e-4
    assert abs(xs / float(g['x_std']) - 1) < 0.03
    assert abs(zs / float(g['z_std']) - 1) < 0.03
    h = np.histogram2d(x, z, bins=32, range=[[-1, 1], [-1, 1]],
                       weights=I)[0]
    ref = np.asarray(g['hist'])
    hn, rn = h / h.sum(), ref / ref.sum()
    big = rn > 1e-4
    rel = np.abs(hn[big] - rn[big]) / rn[big]
    assert np.median(rel) < 0.1 and rel.max() < 0.6
