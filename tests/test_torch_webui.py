"""The port's browser control surface (``xrt_tpu_torch.webui``) against the
JAX package's ``xrt_tpu/webui.py``, float64, CPU.

* Every scenario of ``tests/test_webui.py`` on the port, over loopback
  (``port=0``, ``urlopen(timeout=...)``, each server stopped in its
  fixture's teardown or ``finally``): the page and the element tree, the
  histogram and the scene, a pitch set over the API that moves the focus,
  the inspector, a material from a catalog, the flagship undulator -> DCM
  -> toroid -> screen assembly (with the probe screen, the layout round
  trip and the undo of a remove) and the branched (DAG) assembly.
* The readouts against the JAX functions on the same beams (the JAX
  package's trace of that beamline, carried across by
  ``interop.beam_from_numpy``): ``_hist_payload`` and ``_beam_stats``
  (every scalar to 1e-12 relative; the tables identical unless a good
  ray lies within 4 ulp of a bin edge, which the test counts), and
  ``_material_info``, ``_full_params`` and ``/api/registry``.
* The closed last bin: a beam whose largest ray lies on ``_fwhm``'s
  right edge (where the half-open bins of ``histogram.hist1d`` would drop
  it) gives ``np.histogram``'s width.
"""
import torch_harness  # noqa: F401

import dataclasses
import json
import math
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import xrt_tpu.materials as jm
import xrt_tpu_torch.materials as tm
from xrt_tpu import oes as joes, screens as jscr, sources as jsrc, \
    webui as jw
from xrt_tpu.beamline import BeamLine as JBeamLine
from xrt_tpu.materials import catalogs as jcat
from xrt_tpu_torch import interop, oes as toes, screens as tscr, \
    sources as tsrc, webui as tw
from xrt_tpu_torch.beamline import BeamLine
from xrt_tpu_torch.flow import record_flow
from xrt_tpu_torch.materials import catalogs as tcat

CPU = dict(dtype=torch.float64, device='cpu')
P, Q, PITCH = 10000.0, 2000.0, 4e-3
R = 2 * P * Q / (P + Q) / math.sin(PITCH)
r = 2 * P * Q / (P + Q) * math.sin(PITCH)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def _post(url, body):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 method='POST')
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def webui_beamline(port, nrays=4000):
    """``tests/test_webui.py``'s beamline in either package."""
    kw = CPU if port else {}
    BL, mats, src, oes, scr = (
        (BeamLine, tm, tsrc, toes, tscr) if port else
        (JBeamLine, jm, jsrc, joes, jscr))
    bl = BL(alignE=9000.0)
    bl.add('source', src.GeometricSource.create(
        nrays=nrays, dx=0.1, dz=0.05, dxprime=3e-5, dzprime=3e-5,
        distE='flat', energies=(8900.0, 9100.0),
        polarization='horizontal', **kw))
    mat = mats.Material.create('Si', rho=2.33, kind='mirror', **kw)
    bl.add('mirror', oes.ToroidMirror.create(
        center=(0, P, 0), pitch=PITCH, R=R, r=r, material=mat,
        limPhysX=(-20, 20), limPhysY=(-300, 300)))
    bl.add('screen', scr.Screen.create(center=(0, P + Q, 2 * PITCH * Q)))
    return bl


@pytest.fixture(scope='module')
def ui():
    bl = webui_beamline(True)
    with record_flow(bl) as flow:
        bl.propagate_flow(torch.Generator().manual_seed(0))
    srv = tw.WebUI(bl, flow, port=0, **CPU).start()
    yield srv
    srv.stop()


def test_page_and_elements(ui):
    base = f'http://{ui.host}:{ui.port}'
    with urllib.request.urlopen(base + '/', timeout=60) as resp:
        html = resp.read().decode()
    assert '/api/elements' in html and 'canvas' in html
    els = _get(base + '/api/elements')
    assert set(els) == {'source', 'mirror', 'screen'}
    assert np.isclose(els['mirror']['pitch'], PITCH)
    assert 'R' in els['mirror'] and 'r' in els['mirror']


def test_hist_and_scene(ui):
    base = f'http://{ui.host}:{ui.port}'
    beams = _get(base + '/api/beams')
    assert any('screen' in b for b in beams)
    d = _get(base + '/api/hist')
    assert d['nGood'] > 1000 and d['flux'] > 0
    assert len(d['h']) == ui.bins
    scene = _get(base + '/api/scene')
    names = [e['name'] for e in scene['elements']]
    assert 'mirror' in names and 'screen' in names
    assert scene['segments'], 'ray polylines missing'


def test_set_pitch_moves_focus(ui):
    base = f'http://{ui.host}:{ui.port}'
    d0 = _get(base + '/api/hist')
    dpitch = 2e-4
    resp = _post(base + '/api/set', {'element': 'mirror', 'param': 'pitch',
                                     'value': PITCH + dpitch})
    assert resp.get('ok'), resp
    d1 = _get(base + '/api/hist')
    moved = d1['cz'] - d0['cz']
    assert np.isclose(moved, 2 * dpitch * Q, rtol=0.15), (d0['cz'],
                                                          d1['cz'])
    _post(base + '/api/set', {'element': 'mirror', 'param': 'pitch',
                              'value': PITCH})
    assert _get(base + '/api/hist') == d0


def test_inspect(ui):
    base = f'http://{ui.host}:{ui.port}'
    d = _get(base + '/api/inspect?element=mirror')
    assert d['class'] == 'ToroidMirror'
    assert d['params']['pitch'] == pytest.approx(PITCH)
    assert d['params']['material'] == 'Material'
    assert d['material']['kind'] == 'mirror'
    assert 0 < d['material']['delta'] < 1e-4
    assert d['material']['beta'] > 0
    fp = d['footprint']
    assert fp['nGood'] > 1000 and fp['flux'] > 0
    assert fp['fwhm_y'] > fp['fwhm_x'] > 0   # grazing-incidence stretch
    assert d['beamOut']['nGood'] == fp['nGood']
    assert d['fluxIn'] >= d['beamOut']['flux'] > 0
    assert 0 < d['transmission'] <= 1.0
    n = sum(fp[k] for k in ('nGood', 'nOut', 'nOver', 'nDead'))
    assert n == 4000
    s = _get(base + '/api/inspect?element=source')
    assert s['class'] == 'GeometricSource'
    assert 'transmission' not in s
    assert s['beamOut']['flux'] > 0
    try:
        e = _get(base + '/api/inspect?element=nope')
    except urllib.error.HTTPError as exc:
        assert exc.code == 500
        e = json.loads(exc.read())
    assert 'error' in e and 'nope' in e['error']


def test_set_material_from_catalog(ui):
    base = f'http://{ui.host}:{ui.port}'
    f_si = _get(base + '/api/hist')['flux']
    resp = _post(base + '/api/set', {'element': 'mirror',
                                     'param': 'material',
                                     'value': {'catalog': 'elemental',
                                               'name': 'Au',
                                               'kind': 'mirror'}})
    assert resp.get('ok'), resp
    d = _get(base + '/api/inspect?element=mirror')
    assert d['material']['name'] == 'Au'
    f_au = _get(base + '/api/hist')['flux']
    assert f_au > 2 * f_si, (f_si, f_au)
    _post(base + '/api/set', {'element': 'mirror', 'param': 'material',
                              'value': {'catalog': 'elemental',
                                        'name': 'Si', 'kind': 'mirror'}})


@pytest.fixture(scope='module')
def asmui():
    """An EMPTY beamline served in assembly mode (flow=None)."""
    srv = tw.WebUI(BeamLine(alignE=9000.0, name='assembled'), port=0,
                   **CPU).start()
    yield srv
    srv.stop()


def test_assemble_flagship_beamline(asmui):
    """``tests/test_webui.py``'s flagship assembly on the port: the
    undulator -> DCM -> toroid -> screen beamline from an empty page over
    the HTTP API (class registry + catalog materials + auto-alignment),
    traced live, its layout saved and reloaded."""
    base = f'http://{asmui.host}:{asmui.port}'
    reg = _get(base + '/api/registry')
    assert 'Undulator' in reg['classes'] and 'DCM' in reg['classes']
    assert len(reg['classes']) >= 50
    for cls in ('BentLaue2D', 'SiemensStar', 'VLSLaminarGrating',
                'EllipsoidCapillaryMirror', 'HemisphericScreen'):
        assert cls in reg['classes'], cls
    assert 'Si' in reg['materials']['crystals']
    assert 'Rh' in reg['materials']['elemental']
    assert 'period' in reg['classes']['Undulator']

    resp = _post(base + '/api/add', {
        'name': 'src', 'class': 'Undulator',
        'params': {'nrays': 2000, 'eE': 3.0, 'eI': 0.5, 'period': 18.0,
                   'n': 111, 'targetE': [9000.0, 7],
                   'eMin': 8996.0, 'eMax': 9004.0,
                   'xPrimeMax': 0.02, 'zPrimeMax': 0.02,
                   'eEpsilonX': 0.263, 'eEpsilonZ': 0.008,
                   'betaX': 9.0, 'betaZ': 2.0, 'gNodes': 32}})
    assert resp.get('ok'), resp
    resp = _post(base + '/api/add', {
        'name': 'dcm', 'class': 'DCM', 'distance': 30000.0,
        'autoBragg': True,
        'material': {'catalog': 'crystals', 'name': 'Si',
                     'hkl': [1, 1, 1]},
        'params': {'fixedOffset': 20.0, 'limPhysX': [-50, 50],
                   'limPhysY': [-500, 500], 'alignE': 9000.0}})
    assert resp.get('ok'), resp
    p_t, q_t, pitch_t = 36000.0, 12000.0, 4e-3
    R_t = 2 * p_t * q_t / (p_t + q_t) / math.sin(pitch_t)
    r_t = 2 * p_t * q_t / (p_t + q_t) * math.sin(pitch_t)
    resp = _post(base + '/api/add', {
        'name': 'toroid', 'class': 'ToroidMirror', 'distance': 6000.0,
        'pitch': pitch_t,
        'material': {'catalog': 'elemental', 'name': 'Rh'},
        'params': {'R': R_t, 'r': r_t, 'limPhysX': [-20, 20],
                   'limPhysY': [-400, 400]}})
    assert resp.get('ok'), resp
    resp = _post(base + '/api/add', {
        'name': 'det', 'class': 'Screen', 'distance': 12000.0})
    assert resp.get('ok'), resp
    assert resp['elements'] == ['src', 'dcm', 'toroid', 'det']

    d = _get(base + '/api/hist?beam=det')
    assert d['nGood'] > 100 and d['flux'] > 0
    scene = _get(base + '/api/scene')
    assert {'src', 'dcm', 'toroid', 'det'} <= {
        e['name'] for e in scene['elements']}

    ins = _get(base + '/api/inspect?element=dcm')
    assert ins['material']['braggAngle_deg'] == pytest.approx(12.69,
                                                              abs=0.05)
    assert ins['material']['darwinWidth_urad'] > 0
    assert ins['footprint']['nGood'] > 0
    assert ins['footprint2']['nGood'] > 0

    d_far = _get(base + '/api/probe?beam=toroid&d=11500')
    d_near = _get(base + '/api/probe?beam=toroid&d=3000')
    assert d_far['fwhm_z'] < d_near['fwhm_z']

    with urllib.request.urlopen(base + '/api/layout', timeout=60) as resp_:
        layout = resp_.read().decode()
    assert '"Undulator"' in layout and '"DCM"' in layout
    with urllib.request.urlopen(base + '/api/codegen', timeout=60) as rc:
        script = rc.read().decode()
    assert 'Undulator' in script and 'run_process' in script
    resp = _post(base + '/api/load', {'json': layout})
    assert resp.get('ok'), resp
    assert set(resp['elements']) == {'src', 'dcm', 'toroid', 'det'}
    d2 = _get(base + '/api/hist?beam=det')
    assert d2['nGood'] > 100 and d2['flux'] > 0

    # remove + re-add is an undo: the placement axis rewinds
    det_center = _get(base + '/api/elements')['det']['center']
    resp = _post(base + '/api/remove', {'name': 'det'})
    assert resp.get('ok') and 'det' not in resp['elements']
    resp = _post(base + '/api/add', {
        'name': 'det', 'class': 'Screen', 'distance': 12000.0})
    assert resp.get('ok'), resp
    det_center2 = _get(base + '/api/elements')['det']['center']
    assert np.allclose(det_center, det_center2), (det_center, det_center2)
    resp = _post(base + '/api/reorder',
                 {'order': ['src', 'dcm', 'toroid', 'det']})
    assert resp.get('ok'), resp


def test_failed_add_rolls_back(asmui):
    """An add whose trace fails leaves the beamline as it was: a 500 with
    the error, the element list and the placement axis unchanged."""
    base = f'http://{asmui.host}:{asmui.port}'
    before = _get(base + '/api/elements')
    axis = (asmui.bl.axis_point, asmui.bl.axis_dir)
    # a limit pair of one number: placed, then its trace fails
    try:
        _post(base + '/api/add', {'name': 'bad', 'class': 'FlatMirror',
                                  'distance': 100.0,
                                  'params': {'limPhysX': [-1]}})
        raise AssertionError('the add of a broken element succeeded')
    except urllib.error.HTTPError as exc:
        assert exc.code == 500
        assert 'error' in json.loads(exc.read())
    assert 'bad' not in asmui.bl._elements
    assert _get(base + '/api/elements') == before
    assert np.array_equal(asmui.bl.axis_point, axis[0])
    assert np.array_equal(asmui.bl.axis_dir, axis[1])


def test_assemble_dag_beamline():
    """Branched (DAG) beamlines from the browser: one mirror feeds two
    screens; both histograms update and the layout keeps the wiring."""
    srv = tw.WebUI(BeamLine(alignE=9000.0, name='dag'), port=0,
                   **CPU).start()
    try:
        base = f'http://{srv.host}:{srv.port}'
        resp = _post(base + '/api/add', {
            'name': 'src', 'class': 'GeometricSource',
            'params': {'nrays': 3000, 'dx': 0.1, 'dz': 0.05,
                       'dxprime': 3e-5, 'dzprime': 3e-5,
                       'energies': [9000.0], 'distE': 'lines'}})
        assert resp.get('ok'), resp
        resp = _post(base + '/api/add', {
            'name': 'm1', 'class': 'ToroidMirror', 'distance': 10000.0,
            'pitch': PITCH,
            'material': {'catalog': 'elemental', 'name': 'Rh'},
            'params': {'R': R, 'r': r, 'limPhysX': [-20, 20],
                       'limPhysY': [-300, 300]}})
        assert resp.get('ok'), resp
        resp = _post(base + '/api/add', {
            'name': 'near', 'class': 'Screen', 'distance': 1000.0})
        assert resp.get('ok'), resp
        resp = _post(base + '/api/add', {
            'name': 'focus', 'class': 'Screen', 'distance': 2000.0,
            'input': 'm1'})
        assert resp.get('ok'), resp
        els = _get(base + '/api/elements')
        assert els['focus'].get('_input') == 'm1'
        assert np.isclose(els['focus']['center'][1],
                          P + 2000.0 * math.cos(2 * PITCH), rtol=1e-6)
        d_near = _get(base + '/api/hist?beam=near')
        d_focus = _get(base + '/api/hist?beam=focus')
        assert d_near['nGood'] > 100 and d_focus['nGood'] > 100
        assert d_focus['fwhm_z'] < d_near['fwhm_z']
        ins = _get(base + '/api/inspect?element=focus')
        assert 'fluxIn' in ins and ins['fluxIn'] > 0
        with urllib.request.urlopen(base + '/api/layout',
                                    timeout=60) as resp_:
            layout = resp_.read().decode()
        assert '"_input": "m1"' in layout
        resp = _post(base + '/api/load', {'json': layout})
        assert resp.get('ok'), resp
        els2 = _get(base + '/api/elements')
        assert els2['focus'].get('_input') == 'm1'
        d2 = _get(base + '/api/hist?beam=focus')
        assert d2['nGood'] > 100
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the readouts against the JAX functions on the same beams
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def beams():
    """{name: (JAX beam, the port's beam of the same numbers)} of the JAX
    package's trace of the beamline: the source, the mirror's global and
    local beams and the screen's image."""
    jbl = webui_beamline(False)
    jbeams = jax.jit(lambda k: jbl.propagate_flow(k))(jax.random.PRNGKey(0))
    out = {}
    for name, b in jbeams.items():
        arrays = {f.name: np.asarray(getattr(b, f.name))
                  for f in dataclasses.fields(b)
                  if getattr(b, f.name) is not None}
        out[name] = b, interop.beam_from_numpy(arrays, **CPU)
    return out


def near_edge_rays(v, lo, hi, bins, ulps=4):
    """The count of values *v* within *ulps* ulp of an edge of
    ``np.linspace(lo, hi, bins + 1)``, the ulp at the scale of the value
    or of the limits, whichever is larger (the bin index subtracts the
    lower limit)."""
    edges = np.linspace(lo, hi, bins + 1)
    d = np.abs(v[:, None] - edges[None, :]).min(axis=1)
    scale = np.maximum(np.abs(v), max(abs(lo), abs(hi)))
    return int((d <= ulps * np.spacing(scale)).sum())


def assert_scalars(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, (int, str)) or v is None:
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-300), k


def _shell(cls, bins=80):
    """A WebUI of either package with only its bins set (no server)."""
    obj = object.__new__(cls)
    obj.bins = bins
    return obj


def test_hist_payload_against_jax(beams):
    for name in ('source', 'mirror', 'mirror_local', 'screen'):
        jb, tb = beams[name]
        want = jw.WebUI._hist_payload(_shell(jw.WebUI), jb)
        got = tw.WebUI._hist_payload(_shell(tw.WebUI), tb)
        assert set(got) == set(want)
        for k in ('flux', 'cx', 'cz', 'fwhm_x', 'fwhm_z'):
            assert got[k] == pytest.approx(want[k], rel=1e-12,
                                           abs=1e-300), (name, k)
        assert got['nGood'] == want['nGood']
        np.testing.assert_allclose(got['extent'], want['extent'],
                                   rtol=1e-12, atol=0)
        good = np.asarray(jb.state) == 1
        x, z = np.asarray(jb.x)[good], np.asarray(jb.z)[good]
        ext = want['extent']
        edge = near_edge_rays(x, ext[0], ext[1], 80) + \
            near_edge_rays(z, ext[2], ext[3], 80)
        if edge == 0:
            assert got['h'] == want['h'], name
        else:
            diff = np.abs(np.asarray(got['h']) - np.asarray(want['h']))
            assert (diff > 0).sum() <= 2 * edge, (name, edge)


def test_beam_stats_against_jax(beams):
    for name in ('source', 'mirror', 'mirror_local', 'screen'):
        jb, tb = beams[name]
        assert_scalars(tw._beam_stats(tb), jw._beam_stats(jb))


def test_material_info_against_jax():
    cases = (
        (jm.Material.create('Si', rho=2.33, kind='mirror'),
         tm.Material.create('Si', rho=2.33, kind='mirror', **CPU)),
        (jm.Material.create('Rh', rho=12.41),
         tm.Material.create('Rh', rho=12.41, **CPU)),
        (jm.CrystalSi.create(hkl=(1, 1, 1)),
         tm.CrystalSi.create(hkl=(1, 1, 1), **CPU)),
        (jcat.crystal('Ge', hkl=(1, 1, 1)),
         tcat.crystal('Ge', hkl=(1, 1, 1), **CPU)),
        (jcat.compound('Air'), tcat.compound('Air', **CPU)))
    for jmat, tmat in cases:
        for E in (9000.0, 15000.0):
            assert_scalars(tw._material_info(tmat, E),
                           jw._material_info(jmat, E))


def test_full_params_against_jax():
    jbl, tbl = webui_beamline(False), webui_beamline(True)
    for name in ('source', 'mirror', 'screen'):
        want = jw._full_params(jbl[name])
        got = tw._full_params(tbl[name])
        assert set(got) == set(want), name
        for k, v in want.items():
            if isinstance(v, list) and v and isinstance(v[0], float):
                np.testing.assert_allclose(got[k], v, rtol=1e-12)
            elif isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=1e-12), (name, k)
            else:
                assert got[k] == v, (name, k)


def test_registry_against_jax(ui):
    reg = _get(f'http://{ui.host}:{ui.port}/api/registry')
    want = jw.WebUI.api_registry(None)
    assert json.dumps(reg, sort_keys=True) == \
        json.dumps(json.loads(json.dumps(want)), sort_keys=True)
    for cls in reg['classes'].values():
        assert 'dtype' not in cls and 'device' not in cls


def test_fwhm_closes_the_last_bin():
    """The largest ray lies on the right edge of ``_fwhm``'s range: the
    half-open bins of ``hist1d`` would drop it and narrow the width to one
    bin; the closed last bin keeps ``np.histogram``'s count."""
    x = np.array([0.0, 0.5, 1.0])
    w = np.array([1.0, 0.1, 1.0])
    want = jw._fwhm(x, w)
    assert want == 1.0
    got = tw._fwhm(torch.as_tensor(x), torch.as_tensor(w))
    assert got == want
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, 5000)
    w = rng.uniform(0.5, 1.0, 5000)
    w[np.argmax(x)] = 50.0          # the right edge's ray is the peak
    want = jw._fwhm(x, w)
    assert tw._fwhm(torch.as_tensor(x), torch.as_tensor(w)) == \
        pytest.approx(want, rel=1e-12)
    # one ray: numpy widens an empty range to +-0.5
    assert tw._fwhm(torch.tensor([2.0], dtype=torch.float64),
                    torch.tensor([1.0], dtype=torch.float64)) == \
        jw._fwhm(np.array([2.0]), np.array([1.0]))


def test_percentile_against_numpy():
    rng = np.random.default_rng(5)
    for n in (2, 3, 17, 1000, 4001):
        v = np.abs(rng.normal(0, 1, n))
        for q in (98, 50, 0, 100):
            assert tw._percentile(torch.as_tensor(v), q) == \
                np.percentile(v, q)
