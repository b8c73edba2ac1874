"""The port's host modules against the JAX package's: ``profiler``,
``singletons``, ``units``, ``plotting``, ``dummy``, ``beamio`` and
``codegen``.

* The JAX package's own tests of these modules (``test_profiler.py``,
  ``test_units.py``, ``test_beamio.py``, ``test_codegen.py``), on the
  port, on the CPU: stages, nesting, the decorator, the runner's stages
  ``runner.step`` / ``runner.accumulate`` and its ``updateEvery`` renders;
  the unit tables and named arrays; beam files in the three formats and
  ``BeamFromFile``; a generated script that rebuilds and traces a layout.
* Parity: the unit tables are equal to the JAX package's; ``save_plot``
  renders the same totals to the same pixels in both packages (Agg, read
  back as arrays), with a 'kde' profile too, and ``save_modes_plot`` the
  same modes; beam files written by either package read in the other to
  the same arrays; a JAX-written layout generates a script that runs on
  the port.
"""
import torch_harness  # noqa: F401

import contextlib
import dataclasses
import io
import math
import os
import time

import numpy as np
import pytest
import torch
import jax

from xrt_tpu import beamio as jbeamio, plotspec as jps, plotting as jplot
from xrt_tpu import units as junits
from xrt_tpu_torch import beamio, dummy, plotspec as tps, plotting, profiler
from xrt_tpu_torch import singletons as sg, units
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.sources import GeometricSource

CPU = dict(dtype=torch.float64, device='cpu')


@pytest.fixture(autouse=True)
def _fresh_profiler():
    profiler.reset()
    yield
    profiler.reset()


# ------------------------------------------------------------- profiler
def test_stage_accumulation_and_nesting():
    with profiler.stage('outer'):
        time.sleep(0.01)
        with profiler.stage('inner'):
            time.sleep(0.01)
        with profiler.stage('inner'):
            time.sleep(0.005)
    d = profiler.as_dict()
    assert d['outer']['calls'] == 1
    assert d['outer.inner']['calls'] == 2
    assert d['outer']['total'] >= d['outer.inner']['total']
    assert d['outer.inner']['best'] <= d['outer.inner']['worst']
    assert d['outer']['device_total'] is None     # nothing on a card
    rep = profiler.report()
    assert 'outer.inner' in rep and 'calls' in rep


def test_decorator_and_block_argument():
    @profiler.stage('mm')
    def matmul(a):
        return a @ a

    a = torch.ones((64, 64))
    for _ in range(2):
        matmul(a)
    with profiler.stage('blocked', block=[a, {'b': a}]):
        pass
    d = profiler.as_dict()
    assert d['mm']['calls'] == 2 and d['mm']['total'] > 0
    assert d['blocked']['calls'] == 1


def _screen_process(nrays):
    src = GeometricSource.create(
        nrays=nrays, dx=0.1, dz=0.05, dxprime=1e-5, dzprime=1e-5,
        distE='flat', energies=(8990.0, 9010.0), polarization='horizontal',
        **CPU)
    screen = Screen.create(center=(0, 1000.0, 0))

    def rp(bl, g):
        return {'scr': screen.expose(src.shine(g))}
    return rp


def _plot(mod, **kw):
    return mod.XYCPlot(beam='scr',
                       xaxis=mod.XYCAxis('x', 'mm', limits=(-1, 1)),
                       yaxis=mod.XYCAxis('z', 'mm', limits=(-1, 1)),
                       caxis=mod.XYCAxis('energy', 'eV',
                                         limits=(8990, 9010)), **kw)


def test_runner_records_stages_and_reports():
    from xrt_tpu_torch.runner import run_ray_tracing
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_ray_tracing([_plot(tps)], repeats=3,
                        run_process=_screen_process(500), rng=0,
                        device='cpu', verbose=True)
    d = profiler.as_dict()
    assert d['runner.step']['calls'] == 3
    assert d['runner.accumulate']['calls'] == 3
    out = buf.getvalue()
    assert 'iteration 3/3' in out and 'runner.step' in out


def test_update_every_saves_intermediate(tmp_path, monkeypatch):
    from xrt_tpu_torch.runner import run_ray_tracing
    fn = str(tmp_path / 'live.png')
    saves = []
    orig = plotting.save_plot
    monkeypatch.setattr(plotting, 'save_plot',
                        lambda *a, **k: saves.append(a[1]) or orig(*a, **k))
    plot = _plot(tps, saveName=fn)
    run_ray_tracing([plot], repeats=4, run_process=_screen_process(200),
                    updateEvery=2, rng=0, device='cpu')
    # one mid-run refresh (it=2) + the final save
    assert saves.count(fn) == 2
    assert os.path.getsize(fn) > 10000


def test_normalize_sibling_plots_renders(tmp_path):
    from xrt_tpu_torch.runner import normalize_sibling_plots, run_ray_tracing
    plots = [_plot(tps, saveName=str(tmp_path / f'p{i}.png'))
             for i in range(2)]
    run_ray_tracing(plots, repeats=1, run_process=_screen_process(300),
                    rng=1, device='cpu')
    normalize_sibling_plots(plots)
    for i in range(2):
        assert os.path.exists(tmp_path / f'p{i}_norm.png')
    assert plots[0].globalMax2D_RGB == plots[1].globalMax2D_RGB > 0


def test_color_print_and_verbosity(capsys):
    sg.colorPrint('hello', 'RED')
    sg.colorPrint('hidden', 'RED', verbosity=sg._VERBOSITY_ + 1)
    out = capsys.readouterr().out
    assert 'hello' in out and 'hidden' not in out
    assert sg.is_sequence([1, 2]) and sg.is_sequence((1,))
    assert sg.is_sequence(torch.zeros(2))
    assert not sg.is_sequence('abc') and not sg.is_sequence(3.0)


# ---------------------------------------------------------------- units
def test_convert_and_unit_of():
    assert units.convert(1.0, 'mrad', 'angle') == 1e-3
    assert units.convert(2.0, 'deg', 'angle') == pytest.approx(
        np.radians(2.0))
    assert units.convert(1.0, 'm', 'length') == 1e3
    assert units.convert(9.0, 'keV', 'energy') == 9000.0
    with pytest.raises(KeyError):
        units.convert(1.0, 'furlong', 'length')
    assert units.unit_of('pitch') == 'rad'
    assert units.unit_of('center') == 'mm'
    assert units.unit_of('eE') == 'GeV'
    assert units.unit_of('nosuchfield') == ''


def test_unit_tables_equal_the_jax_packages():
    for name in ('ANGLE_UNITS', 'ANGLE_STR', 'LENGTH_UNITS', 'LENGTH_STR',
                 'ENERGY_UNITS', 'EMITTANCE_UNITS', 'CURRENT_UNITS',
                 'FIELD_UNITS'):
        assert getattr(units, name) == getattr(junits, name), name


def test_named_arrays_behave_like_tuples_and_reach_elements():
    from xrt_tpu_torch.oes import FlatMirror
    c = units.Center(1.0, 2.0, 3.0)
    assert c.x == 1.0 and c.z == 3.0
    assert tuple(c) == (1.0, 2.0, 3.0)
    assert len(c) == 3 and c[1] == 2.0
    assert np.asarray(c).dtype == np.float64
    assert c == (1.0, 2.0, 3.0)
    lim = units.Limits(-5.0, 5.0)
    assert lim.lmin == -5.0 and np.asarray(lim)[1] == 5.0
    op = units.Opening(-1, 1, -2, 2)
    assert (op.left, op.right, op.bottom, op.top) == (-1, 1, -2, 2)
    im = units.Image2D(640, 480)
    assert np.asarray(im).dtype.kind == 'i' and im.width == 640
    s = Screen.create(center=units.Center(0.0, 100.0, 0.0))
    assert float(s.center[1]) == 100.0
    m = FlatMirror.create(center=units.Center(0, 50, 0), pitch=4e-3,
                          limPhysX=units.Limits(-10, 10),
                          limPhysY=units.Limits(-100, 100))
    assert float(m.limPhysX[0]) == -10.0


# ------------------------------------------------------------- plotting
def _totals(seed, bins=(32, 24, 16)):
    """A plot's accumulated totals, made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    bx, by, bc = bins
    xs, ys = np.meshgrid(np.linspace(-2, 2, bx), np.linspace(-2, 2, by))
    blob = np.exp(-(xs ** 2 + 0.5 * ys ** 2))
    d = {'total2D': blob * 100 + rng.uniform(0, 1, (by, bx)),
         'total2D_RGB': np.stack([blob, blob ** 2, rng.uniform(
             0, 0.2, (by, bx))], -1) * 50,
         'total1D_x': blob.sum(0), 'total1D_y': blob.sum(1),
         'total1D_c': np.exp(-np.linspace(-2, 2, bc) ** 2) * 10}
    for k, n in (('total1D_x_RGB', bx), ('total1D_y_RGB', by),
                 ('total1D_c_RGB', bc)):
        d[k] = rng.uniform(0, 1, (n, 3))
    return d


def _filled_plot(mod, density='histogram'):
    plot = mod.XYCPlot(
        beam='screen',
        xaxis=mod.XYCAxis('x', 'mm', bins=32, limits=(-1, 1),
                          density=density),
        yaxis=mod.XYCAxis('z', 'mm', bins=24, limits=(-0.5, 0.5)),
        caxis=mod.XYCAxis('energy', 'eV', bins=16, limits=(8990, 9010)),
        title='parity')
    for k, v in _totals(3).items():
        setattr(plot, k, v.copy())
    plot.intensity = 12.5
    plot.nRaysGood, plot.nRaysAll = 900, 1000
    return plot


def _pixels(path):
    import matplotlib.image
    return matplotlib.image.imread(path)


@pytest.mark.parametrize('density', ('histogram', 'kde'))
def test_save_plot_pixels_equal_the_jax_packages(tmp_path, density):
    a, b = str(tmp_path / 'port.png'), str(tmp_path / 'jax.png')
    tp = _filled_plot(tps, density)
    jp = _filled_plot(jps, density)
    np.testing.assert_array_equal(plotting.rgb_image(tp),
                                  jplot.rgb_image(jp))
    plotting.save_plot(tp, a)
    jplot.save_plot(jp, b)
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape and pa.shape[0] > 100
    np.testing.assert_array_equal(pa, pb)


def test_save_modes_plot_pixels_equal_the_jax_packages(tmp_path):
    rng = np.random.default_rng(1)
    w = np.sort(rng.uniform(0, 1, 5))
    modes = rng.normal(size=(12 * 10, 5)) + 1j * rng.normal(size=(120, 5))
    a, b = str(tmp_path / 'port.png'), str(tmp_path / 'jax.png')
    plotting.save_modes_plot(w, modes, (12, 10), a, nmax=3)
    jplot.save_modes_plot(w, modes, (12, 10), b, nmax=3)
    np.testing.assert_array_equal(_pixels(a), _pixels(b))


# ---------------------------------------------------------------- dummy
def test_dummy_run_process():
    x, y, intensity, energy, n = dummy.run_process(1000, seed=2,
                                                   device='cpu')
    assert n == 1000 and x.shape == (1000,) and x.device.type == 'cpu'
    assert torch.equal(intensity, torch.ones_like(x))
    assert torch.allclose(energy, x + 2 * y + 5000)
    x2 = dummy.run_process(1000, seed=2, device='cpu')[0]
    assert torch.equal(x, x2)
    assert abs(float(x.std()) - 1) < 0.1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            dummy.run_process(10)


# --------------------------------------------------------------- beamio
def _port_beam(nrays=500):
    src = GeometricSource.create(
        nrays=nrays, dx=0.1, dz=0.05, dxprime=1e-4, dzprime=5e-5,
        energies=(9000.0, 100.0), distE='normal', **CPU)
    return src.shine(torch.Generator().manual_seed(0))


def _jax_beam(nrays=500):
    from xrt_tpu.sources.geometric import GeometricSource as JSource
    src = JSource.create(nrays=nrays, dx=0.1, dz=0.05, dxprime=1e-4,
                         dzprime=5e-5, energies=(9000.0, 100.0),
                         distE='normal')
    return src.shine(jax.random.PRNGKey(0))


def _assert_same(a, b):
    """Every field that either beam has, with equal values."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name, None)
        if va is None:
            assert vb is None, f.name
            continue
        na = va.detach().cpu().numpy() if isinstance(va, torch.Tensor) \
            else np.asarray(va)
        nb = vb.detach().cpu().numpy() if isinstance(vb, torch.Tensor) \
            else np.asarray(vb)
        np.testing.assert_array_equal(na, nb, err_msg=f.name)


@pytest.mark.parametrize('fmt', ('npy', 'pickle', 'mat'))
def test_beam_roundtrip(tmp_path, fmt):
    beam = _port_beam()
    path = beamio.export_beam(beam, str(tmp_path / 'beam'), fmt)
    assert path.endswith(fmt)
    _assert_same(beam, beamio.load_beam(path, device='cpu'))


def test_beam_from_file_source(tmp_path):
    beam = _port_beam(200)
    path = beamio.export_beam(beam, str(tmp_path / 'saved'), 'npy')
    src = beamio.BeamFromFile.create(path, name='replay', device='cpu')
    replay = src.shine()
    assert replay.nrays == 200 and src.name == 'replay'
    _assert_same(beam, replay)


@pytest.mark.parametrize('fmt', ('npy', 'pickle', 'mat'))
def test_beam_files_cross_packages(tmp_path, fmt):
    jbeam = _jax_beam()
    path = jbeamio.export_beam(jbeam, str(tmp_path / 'jax'), fmt)
    _assert_same(jbeam, beamio.load_beam(path, device='cpu'))
    tbeam = _port_beam()
    path = beamio.export_beam(tbeam, str(tmp_path / 'port'), fmt)
    _assert_same(tbeam, jbeamio.load_beam(path))


def test_filter_and_replace_by_index():
    from xrt_tpu_torch.beam import (copy_beam, filter_by_index, filter_good,
                                    new_beam, replace_by_index)
    b = new_beam(10, energy=9000.0, **CPU)
    b = b.replace(state=torch.tensor([1, 2, 1, 3, 1, 1, 2, 1, 1, 1],
                                     dtype=torch.int32))
    g = filter_good(b)
    assert g.nrays == 7 and bool(torch.all(g.state == 1))
    assert filter_by_index(b, np.asarray([0, 2, 4])).nrays == 3
    other = b.replace(x=b.x + 5.0)
    mask = np.zeros(10, bool)
    mask[3] = True
    rep = replace_by_index(b, mask, other)
    assert float(rep.x[3]) == float(b.x[3]) + 5.0
    assert float(rep.x[0]) == float(b.x[0])
    assert torch.equal(copy_beam(b).E, b.E)


# -------------------------------------------------------------- codegen
def _beamline(pkg):
    if pkg == 'port':
        import xrt_tpu_torch.materials as xm
        from xrt_tpu_torch.beamline import BeamLine
        from xrt_tpu_torch.oes import ToroidMirror
        from xrt_tpu_torch.oes.dcm import DCM
        from xrt_tpu_torch.screens import Screen as S
        from xrt_tpu_torch.sources import GeometricSource as G
        F = CPU
    else:
        import xrt_tpu.materials as xm
        from xrt_tpu.beamline import BeamLine
        from xrt_tpu.oes import ToroidMirror
        from xrt_tpu.oes.dcm import DCM
        from xrt_tpu.screens import Screen as S
        from xrt_tpu.sources import GeometricSource as G
        F = {}
    cr = xm.CrystalSi.create(hkl=(1, 1, 1), tK=300.0, **F)
    mat = xm.Material.create('Rh', rho=12.41, kind='mirror', **F)
    bl = BeamLine(name='codegen_bl', alignE=9000.0)
    bl.add('source', G.create(
        nrays=200, dx=0.1, dz=0.05, dxprime=2e-5, dzprime=2e-5,
        distE='flat', energies=(8995.0, 9005.0), **F))
    bl.add('dcm', DCM.create(center=(0, 10000, 0), material=cr,
                             alignE=9000.0, fixedOffset=20.0))
    bl.add('mirror', ToroidMirror.create(
        center=(0, 20000, 20), pitch=4e-3, R=1.2e6, r=60.0, material=mat,
        limPhysX=(-20, 20), limPhysY=(-300, 300)))
    bl.add('screen', S.create(center=(0, 30000, 20 + 4e-3 * 2e4)))
    return bl


@pytest.mark.parametrize('pkg', ('port', 'jax'))
def test_generated_script_runs(pkg, capsys):
    from xrt_tpu_torch.codegen import generate_script
    text = generate_script(_beamline(pkg).export_to_json(), repeats=1)
    assert 'import xrt_tpu_torch' in text
    assert 'from xrt_tpu.' not in text and 'import xrt_tpu.' not in text
    ns = {'__name__': 'generated_script'}
    exec(compile(text, 'generated_script.py', 'exec'), ns)
    plot = ns['main'](repeats=1, save=None, device='cpu')
    assert plot.nRaysGood > 0 and plot.intensity > 0
    bl = ns['build_beamline']('cpu')
    assert bl['dcm'].material.hkl == (1, 1, 1)
    assert math.isclose(float(bl['mirror'].material.rho), 12.41,
                        rel_tol=1e-6)
    assert 'flux=' in capsys.readouterr().out
