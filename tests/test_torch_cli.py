"""The port's command line, ``python -m xrt_tpu_torch``, on the CPU
(``--device cpu``), against the JAX package's ``python -m xrt_tpu``.

* ``calc``: the JAX package's ``tests/test_cli_calc.py`` on the port at
  its limits (critical angle, Beer-Lambert, delta / beta / mu, the Darwin
  plateau, a bent-crystal scan whose FWHM grows as the radius falls), and
  each curve's CSV against the JAX CLI's on the same arguments (the
  printed six digits, rtol 2e-5).
* ``info``, ``trace`` (the printed flux and centroids equal those of the
  same seed through the API), ``codegen`` (the written script runs),
  ``qook`` on ``BioXAS_Main.xml``; ``glow`` writes the HTML view, ``bob``
  the Phoebus screens, and ``serve --ui`` (a subprocess) answers
  ``/api/elements``.
* ``serve`` (``main()`` in a thread) answers list / get / set / acquire /
  shutdown from a ``BeamLineClient`` and returns 0.
* ``trace --multihost`` in two processes over gloo (``--coordinator`` on
  localhost): both print the flux of the two ranks' histograms summed,
  which equals the ordered sum of two unsharded passes with the same
  generators to the printed digits.
"""
import torch_harness  # noqa: F401

import contextlib
import io
import math
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from xrt_tpu.__main__ import main as jmain
from xrt_tpu_torch.__main__ import main

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CPU = dict(dtype=torch.float64, device='cpu')
ENV = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=ROOT)


def run(fn, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(args)
    assert rc == 0
    return buf.getvalue()


def csv(out):
    lines = [ln for ln in out.splitlines() if ln]
    rows = [ln for ln in lines if not ln.startswith('#')]
    return [ln for ln in lines if ln.startswith('#')], \
        np.asarray([[float(v) for v in r.split(',')] for r in rows])


def both(args):
    """(port's headers, CSV), the JAX CLI's CSV, for one calc call."""
    mine = csv(run(main, ['calc'] + args + ['--device', 'cpu']))
    theirs = csv(run(jmain, ['calc'] + args))
    np.testing.assert_allclose(mine[1], theirs[1], rtol=2e-5, atol=1e-12)
    return mine


def test_reflectivity_critical_angle():
    _, d = both(['reflectivity', '--material', 'Rh', '--rho', '12.41',
                 '--E', '9000', '--theta', '1:10:40'])
    theta, Rs, Rp = d[:, 0], d[:, 1], d[:, 2]
    assert Rs[theta < 3].min() > 0.9
    assert Rs[theta > 9].max() < 0.1
    assert (np.abs(Rs - Rp) < 0.01).all()


def test_reflectivity_against_energy():
    _, d = both(['reflectivity', '--material', 'Pt', '--rho', '21.45',
                 '--E', '5000:20000:16', '--theta', '4'])
    assert d.shape == (16, 3) and d[0, 1] > d[-1, 1]


def test_transmission_beer_lambert():
    _, d = both(['transmission', '--material', 'C', '--rho', '3.52',
                 '--t', '0.1', '--E', '5000:20000:4'])
    T = d[:, 1]
    assert (np.diff(T) > 0).all()
    assert 0.4 < T[0] < 0.6 and T[-1] > 0.97


def test_index_delta_beta():
    _, d = both(['index', '--material', 'Be', '--rho', '1.848',
                 '--E', '9000'])
    E, delta, beta, mu = d[0]
    np.testing.assert_allclose(delta, 4.2e-6, rtol=0.05)
    assert 0 < beta < 1e-8
    np.testing.assert_allclose(mu, 1.45, rtol=0.05)


def test_rocking_curve_darwin_plateau():
    _, d = both(['rocking', '--material', 'Si', '--hkl', '111', '--E',
                 '9000', '--dtheta=-20:60:81'])
    dth, Rs = d[:, 0], d[:, 1]
    assert Rs.max() > 0.9
    assert 10 < dth[np.argmax(Rs)] < 50
    width = (Rs > 0.5).sum() * (dth[1] - dth[0])
    assert 15 < width < 60


def test_rocking_scan_sweep(tmp_path):
    """The bent-crystal (Takagi-Taupin) sweep with a PNG, against the JAX
    CLI's curves."""
    png = str(tmp_path / 'sweep.png')
    args = ['rocking', '--material', 'Si', '--hkl', '111', '--E', '9000',
            '--tc', '0.1', '--scan', 'R=inf,2000,500',
            '--dtheta=-50:150:120']
    headers, d = both(args + ['--save', png])
    fwhms = [float(re.search(r'FWHM=([0-9.e+-]+)', h).group(1))
             for h in headers if 'FWHM' in h]
    assert len(fwhms) == 3 and fwhms[0] < fwhms[1] < fwhms[2]
    assert os.path.getsize(png) > 10000


@pytest.fixture(scope='module')
def layout(tmp_path_factory):
    """``tests/test_multihost.py``'s beamline, written by the port."""
    from xrt_tpu_torch.beamline import BeamLine
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import ToroidMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    bl = BeamLine(alignE=9000.0)
    bl.add('source', GeometricSource.create(
        nrays=2048, dx=0.1, dz=0.05, dxprime=3e-5, dzprime=3e-5,
        distE='flat', energies=(8900.0, 9100.0), polarization='horizontal',
        **CPU))
    p, q, pitch = 10000.0, 2000.0, 4e-3
    mat = Material.create('Si', rho=2.33, kind='mirror', **CPU)
    bl.add('mirror', ToroidMirror.create(
        center=(0, p, 0), pitch=pitch, R=2 * p * q / (p + q) /
        math.sin(pitch), r=2 * p * q / (p + q) * math.sin(pitch),
        material=mat, limPhysX=(-20, 20), limPhysY=(-300, 300)))
    bl.add('screen', Screen.create(center=(0, p + q, 2 * pitch * q)))
    path = str(tmp_path_factory.mktemp('cli') / 'bl.json')
    bl.export_to_json(path)
    return path


def test_info(layout):
    out = run(main, ['info', layout, '--device', 'cpu'])
    assert re.search(r'mirror\s+ToroidMirror\s+\.reflect\(\)', out), out
    assert len(out.strip().splitlines()) == 3


def test_trace_prints_the_apis_numbers(layout, tmp_path):
    from xrt_tpu_torch.beamline import BeamLine
    png = str(tmp_path / 'img.png')
    out = run(main, ['--device', 'cpu', 'trace', layout, '--repeats', '3',
                     '--seed', '5', '--save', png])
    bl = BeamLine.load_from_json(layout, device='cpu')
    g = torch.Generator().manual_seed(5)
    for _ in range(3):
        beams = bl.propagate_flow(g)
    img = beams['screen']
    good = (img.state == 1).numpy()
    flux = (img.Jss + img.Jpp).double().numpy()[good].sum()
    x = img.x.double().numpy()[good]
    assert f'{good.sum()} good rays, flux={flux:.5g}' in out, out
    assert f'x: {x.mean():.4g} +- {x.std():.4g} mm' in out
    assert os.path.getsize(png) > 10000


def test_codegen_script_runs(layout, tmp_path):
    import runpy
    script = str(tmp_path / 'gen.py')
    out = run(main, ['codegen', layout, '-o', script, '--repeats', '1'])
    assert f'wrote {script}' in out
    ns = runpy.run_path(script, run_name='generated')
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        plot = ns['main'](repeats=1, device='cpu')
    flux = float(re.search(r'flux=([0-9.eE+-]+)', buf.getvalue()).group(1))
    assert flux > 0 and plot.nRaysGood > 0


def test_qook_project(tmp_path):
    png = str(tmp_path / 'q.png')
    out = run(main, ['qook', os.path.join(HERE, 'data', 'qook',
                                          'BioXAS_Main.xml'),
                     '--nrays', '2000', '--repeats', '1', '--save', png,
                     '--device', 'cpu'])
    plots = re.findall(r"plot '(\w+)': flux=([0-9.eE+-]+) nGood=(\d+)", out)
    assert plots and all(float(f) >= 0 for _, f, _ in plots)
    assert any(int(n) > 0 for *_, n in plots)
    assert os.path.getsize(png) > 10000


@pytest.mark.parametrize('argv', (['glow', 'bl.json'], ['bob', 'bl.json'],
                                  ['serve', '--ui']))
def test_views_write_and_serve(argv, layout, tmp_path):
    """``glow`` writes the standalone HTML view of the layout, ``bob`` one
    Phoebus screen per element and the workflow screen, and ``serve --ui``
    (a subprocess on a free port, killed afterwards) answers
    ``/api/elements`` with the layout's elements."""
    import json
    import urllib.request
    argv = [layout if a == 'bl.json' else a for a in argv]
    if argv[0] == 'glow':
        out = str(tmp_path / 'glow.html')
        assert f'wrote {out}' in run(main, argv + ['--save', out,
                                                   '--device', 'cpu'])
        html = open(out).read()
        scene = json.loads(re.search(r'const SCENE = (\{.*?\});\n', html,
                                     re.S).group(1))
        assert {e['name'] for e in scene['elements']} == \
            {'source', 'mirror', 'screen'}
        return
    if argv[0] == 'bob':
        out = str(tmp_path / 'bob')
        printed = run(main, argv + ['--out', out, '--device', 'cpu'])
        files = sorted(os.path.relpath(os.path.join(d, f), out)
                       for d, _, fs in os.walk(out) for f in fs)
        assert files == ['oes/mirror.bob', 'screens/screen.bob',
                         'sources/source.bob', 'workflow.bob']
        assert printed.count('wrote ') == 4
        return
    proc = subprocess.Popen(
        [sys.executable, '-m', 'xrt_tpu_torch'] + argv +
        ['--device', 'cpu', '--port', '0'], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=ENV, cwd=ROOT,
        start_new_session=True)
    # a server that never prints its address is killed (its output then
    # ends)
    import threading
    timer = threading.Timer(120, os.killpg, (proc.pid, 9))
    timer.start()
    try:
        out, m = [], None
        for line in proc.stdout:
            out.append(line)
            m = re.search(r'http://([\d.]+):(\d+)/', line)
            if m:
                break
        assert m, ''.join(out)
        url = f'http://{m.group(1)}:{m.group(2)}/api/elements'
        with urllib.request.urlopen(url, timeout=60) as r:
            assert json.loads(r.read()) == {}
    finally:
        timer.cancel()
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
        proc.wait(timeout=60)


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_serve(layout):
    """``serve`` through ``main()`` in a thread: its printed address, the
    five commands from a client, and ``main`` returning 0 after the
    shutdown."""
    import threading
    from xrt_tpu_torch.server import BeamLineClient
    buf, rc = io.StringIO(), []

    def serve():
        rc.append(main(['serve', layout, '--device', 'cpu', '--port', '0']))
    with contextlib.redirect_stdout(buf):
        th = threading.Thread(target=serve, daemon=True)
        th.start()
        m, deadline = None, time.time() + 120
        while m is None and th.is_alive() and time.time() < deadline:
            time.sleep(0.05)
            m = re.search(r'serving beamline on ([\d.]+):(\d+)',
                          buf.getvalue())
        assert m, buf.getvalue()
        cli = BeamLineClient(m.group(1), int(m.group(2)))
        try:
            assert 'pitch' in cli.list()['mirror']
            assert cli.get('mirror:pitch') == pytest.approx(4e-3)
            r0 = cli.acquire()
            assert r0['beam'] == 'screen' and r0['ngood'] > 1000
            r1 = cli.set('mirror:pitch', 4.1e-3)['result']
            assert r1['ngood'] > 0 and r1['flux'] != r0['flux']
            assert cli.request(cmd='shutdown') == {'ok': True}
        finally:
            cli.close()
        th.join(timeout=60)
    assert not th.is_alive() and rc == [0]


def test_trace_multihost_two_processes(layout):
    from xrt_tpu_torch.beamline import BeamLine
    from xrt_tpu_torch.parallel import split_generator
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    from xrt_tpu_torch.runner import (_accumulate, calibrate_limits,
                                      histogram_plot)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'xrt_tpu_torch', 'trace', layout,
         '--multihost', '--repeats', '2', '--seed', '5', '--device', 'cpu',
         '--coordinator', f'127.0.0.1:{port}', '--num-processes', '2',
         '--process-id', str(pid)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=ENV, cwd=ROOT)
        for pid in (0, 1)]
    outs = []
    try:
        deadline = time.time() + 240
        for p in procs:
            out, err = p.communicate(timeout=max(1, deadline - time.time()))
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, out + err
    assert 'process 0 of 2' in outs[0][1]
    fluxes = [float(re.search(r'flux=([0-9.eE+-]+)', o).group(1))
              for _, o, _ in outs]
    # the ordered sum of two unsharded passes with the same generators
    bl = BeamLine.load_from_json(layout, device='cpu')
    rng = torch.Generator().manual_seed(5)
    beams0 = bl.propagate_flow(rng)
    plot = XYCPlot(beam='screen', xaxis=XYCAxis('x', 'mm'),
                   yaxis=XYCAxis('z', 'mm'), caxis=XYCAxis('energy', 'eV'))
    calibrate_limits([plot], beams0)
    for _ in range(2):
        hs = [histogram_plot(plot, bl.propagate_flow(g))
              for g in split_generator(rng, 2)]
        _accumulate(plot, {k: (hs[0][k] + hs[1][k]) if k != 'counters'
                           else {c: hs[0][k][c] + hs[1][k][c]
                                 for c in hs[0][k]} for k in hs[0]})
    for f in fluxes:
        assert f == pytest.approx(plot.intensity, rel=1e-5)
