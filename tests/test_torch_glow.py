"""The port's 3D view (``xrt_tpu_torch.glow``, ``BeamLine.glow``) against
the JAX package's ``xrt_tpu/glow.py`` on the same beams, float64, CPU.

* ``tests/test_glow.py``'s beamline (GeometricSource -> Si toroid ->
  slit -> screen) traced by the JAX package; its beams carried across by
  ``interop.beam_from_numpy``.  Both packages' scenes: the same elements
  in the same order and colours, every wireframe point to 1e-9 mm (the
  toroid's surface evaluated by ``local_z`` and placed by
  ``local_to_global`` in the port), the segments' end points equal after
  the scene's 4-decimal rounding or within 1e-4 mm, the colours to 1e-3
  and the good flags equal.
* ``tests/test_glow.py`` on the port: the scene and its HTML, the PNG
  export, the scan player whose post-mirror segments rise with the
  pitch.
* The surface fallback: an element without a surface height
  (``NotImplementedError``) is drawn as its flat plane, a ``RuntimeError``
  (what a failed launch raises) propagates.
"""
import torch_harness  # noqa: F401

import dataclasses
import json
import math
import re

import jax
import numpy as np
import pytest
import torch

import xrt_tpu.materials as jm
import xrt_tpu_torch.materials as tm
from xrt_tpu import apertures as japs, glow as jglow, oes as joes, \
    screens as jscr, sources as jsrc
from xrt_tpu.beamline import BeamLine as JBeamLine
from xrt_tpu_torch import apertures as taps, glow as tglow, interop, \
    oes as toes, screens as tscr, sources as tsrc
from xrt_tpu_torch.beamline import BeamLine as TBeamLine

CPU = dict(dtype=torch.float64, device='cpu')
P, Q, PITCH = 10000.0, 2000.0, 4e-3
R = 2 * P * Q / (P + Q) / math.sin(PITCH)
r = 2 * P * Q / (P + Q) * math.sin(PITCH)


def glow_beamline(port, nrays=500):
    """``tests/test_glow.py``'s beamline in either package."""
    kw = CPU if port else {}
    BL, mats, src, oes, aps, scr = (
        (TBeamLine, tm, tsrc, toes, taps, tscr) if port else
        (JBeamLine, jm, jsrc, joes, japs, jscr))
    mat = mats.Material.create('Si', rho=2.33, kind='mirror', **kw)
    bl = BL(name='glow-test')
    bl.add('src', src.GeometricSource.create(
        nrays=nrays, center=(0, 0, 0), dx=0.1, dz=0.05, dxprime=3e-5,
        dzprime=3e-5, distE='flat', energies=(8900.0, 9100.0),
        polarization='horizontal', **kw))
    bl.add('m1', oes.ToroidMirror.create(
        center=(0, P, 0), pitch=PITCH, R=R, r=r, material=mat,
        limPhysX=(-20, 20), limPhysY=(-300, 300)))
    bl.add('slit', aps.RectangularAperture.create(
        center=(0, P + 500, 2 * PITCH * 500), opening=(-5, 5, -5, 5)))
    bl.add('scr', scr.Screen.create(center=(0, P + Q, 2 * PITCH * Q)))
    return bl


def to_port(jbeams):
    """The JAX package's beams as the port's, the same numbers."""
    out = {}
    for name, b in jbeams.items():
        arrays = {f.name: np.asarray(getattr(b, f.name))
                  for f in dataclasses.fields(b)
                  if getattr(b, f.name) is not None}
        out[name] = interop.beam_from_numpy(arrays, **CPU)
    return out


@pytest.fixture(scope='module')
def both():
    jbl = glow_beamline(False)
    jbeams = jax.jit(lambda k: jbl.propagate_flow(k))(jax.random.PRNGKey(0))
    tbl = glow_beamline(True)
    # a jitted dict comes back with its keys sorted: both in flow order
    order = list(tbl.propagate_flow(torch.Generator().manual_seed(0)))
    jbeams = {k: jbeams[k] for k in order}
    return jbl, jbeams, tbl, to_port(jbeams)


def test_scene_against_jax(both):
    jbl, jbeams, tbl, tbeams = both
    js = jglow.build_scene(jbl, beams=jbeams)
    ts = tglow.build_scene(tbl, beams=tbeams)
    assert ts['title'] == js['title'] == 'glow-test'
    assert [(e['name'], e['color']) for e in ts['elements']] == \
        [(e['name'], e['color']) for e in js['elements']]
    for te, je in zip(ts['elements'], js['elements']):
        assert len(te['lines']) == len(je['lines'])
        for tl, jl in zip(te['lines'], je['lines']):
            np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-9)
    assert [(s['from'], s['to']) for s in ts['segments']] == \
        [(s['from'], s['to']) for s in js['segments']]
    for tseg, jseg in zip(ts['segments'], js['segments']):
        tp, jp = np.asarray(tseg['p']), np.asarray(jseg['p'])
        assert tp.shape == jp.shape == (200, 2, 3)
        assert ((tp == jp) | (np.abs(tp - jp) <= 1e-4)).all()
        np.testing.assert_allclose(tseg['rgb'], jseg['rgb'], rtol=0,
                                   atol=1e-3)
        assert tseg['good'] == jseg['good']
        assert 0 < sum(tseg['good']) <= 200


def test_energy_color_against_jax():
    E = np.random.default_rng(3).uniform(8800, 9200, 500)
    np.testing.assert_array_equal(tglow._energy_color(E, 8900, 9100),
                                  jglow._energy_color(E, 8900, 9100))
    np.testing.assert_array_equal(tglow._energy_color(E, 9000, 9000),
                                  jglow._energy_color(E, 9000, 9000))


def test_scene_and_html_export(both, tmp_path):
    """``tests/test_glow.py::test_scene_and_html_export`` on the port."""
    _, _, bl, beams = both
    scene = tglow.build_scene(bl, beams=beams)
    names = {e['name'] for e in scene['elements']}
    assert {'src', 'm1', 'slit', 'scr'} <= names
    # mirror wireframe reaches the mirror position (y ~ 10000)
    m1 = next(e for e in scene['elements'] if e['name'] == 'm1')
    ys = np.asarray([p[1] for line in m1['lines'] for p in line])
    assert abs(ys.mean() - 10000) < 400
    # beam segments connect consecutive flow elements
    pairs = [(s['from'], s['to']) for s in scene['segments']]
    assert ('src', 'm1') in pairs and ('m1', 'slit') in pairs
    seg = scene['segments'][0]
    assert len(seg['p']) == len(seg['rgb']) == len(seg['good'])

    out = tglow.export_html(bl, beams=beams,
                            fileName=str(tmp_path / 'bl.html'))
    html = open(out).read()
    assert html.startswith('<!DOCTYPE html>')
    assert 'glow-test' in html
    # embedded scene is valid JSON
    m = re.search(r'const SCENE = (\{.*?\});\n', html, re.S)
    embedded = json.loads(m.group(1))
    assert len(embedded['segments']) == 3


def test_png_export(both, tmp_path):
    _, _, bl, beams = both
    out = bl.glow(beams=beams, save=str(tmp_path / 'bl.png'), maxRays=50)
    data = open(out, 'rb').read()
    assert data[:8] == b'\x89PNG\r\n\x1a\n'
    assert len(data) > 10000


def test_scan_player(tmp_path):
    """``bl.glow(scan=...)`` writes a play-slider HTML whose frames move
    with the swept parameter (the flow recorded with a generator seeded
    with 0 on the source's device)."""
    bl = TBeamLine(alignE=9000.0)
    bl.add('source', tsrc.GeometricSource.create(
        nrays=500, dx=0.1, dz=0.05, dxprime=3e-5, dzprime=3e-5,
        distE='flat', energies=(8900.0, 9100.0),
        polarization='horizontal', **CPU))
    mat = tm.Material.create('Si', rho=2.33, kind='mirror', **CPU)
    bl.add('mirror', toes.ToroidMirror.create(
        center=(0, P, 0), pitch=PITCH, R=R, r=r, material=mat,
        limPhysX=(-20, 20), limPhysY=(-300, 300)))
    bl.add('screen', tscr.Screen.create(center=(0, P + Q, 2 * PITCH * Q)))
    fn = str(tmp_path / 'scan.html')
    out = bl.glow(scan={'element': 'mirror', 'param': 'pitch',
                        'values': [PITCH, PITCH + 3e-4, PITCH + 6e-4]},
                  save=fn, maxRays=50)
    assert out == fn
    html = open(fn).read()
    assert 'SCENES' in html and 'id="play"' in html
    scenes = json.loads(html.split('const SCENES = ')[1].split(';\n')[0])
    labels = json.loads(html.split('const LABELS = ')[1].split(';\n')[0])
    assert len(scenes) == 3 and len(labels) == 3
    assert 'mirror.pitch' in labels[0]

    # the post-mirror ray segments move up as the pitch grows
    def mean_end_z(scene):
        seg = [s for s in scene['segments']
               if s['to'].startswith('screen')][0]
        return np.mean([p[1][2] for p in seg['p']])
    z0, z1, z2 = (mean_end_z(s) for s in scenes)
    assert z2 - z0 > 1.0 and z0 < z1 < z2, (z0, z1, z2)
    # the frames replay the recorded flow: the first is the trace itself
    beams = bl.propagate_flow(torch.Generator('cpu').manual_seed(0))
    first = tglow.build_scene(bl, beams=beams, maxRays=50)
    assert scenes[0]['segments'][-1]['p'] == first['segments'][-1]['p']


class _NoSurface(toes.ToroidMirror):
    def local_z(self, x, y):
        raise NotImplementedError('no surface height')


class _DeviceFault(toes.ToroidMirror):
    def local_z(self, x, y):
        raise RuntimeError('CUDA error: an illegal memory access')


def test_surface_fallback_is_narrow():
    kw = dict(center=(0, P, 0), pitch=PITCH, R=R, r=r,
              material=tm.Material.create('Si', rho=2.33, kind='mirror',
                                          **CPU),
              limPhysX=(-20, 20), limPhysY=(-300, 300))
    flat = tglow._oe_wireframe(toes.FlatMirror.create(**{
        k: v for k, v in kw.items() if k not in ('R', 'r')}))
    np.testing.assert_array_equal(
        tglow._oe_wireframe(_NoSurface.create(**kw)), flat)
    with pytest.raises(RuntimeError, match='illegal memory access'):
        tglow._oe_wireframe(_DeviceFault.create(**kw))
    # the wireframe runs in the element's dtype on its device (its
    # material's): float32 points differ from float64 ones
    kw32 = dict(kw, material=tm.Material.create(
        'Si', rho=2.33, kind='mirror', dtype=torch.float32, device='cpu'))
    lines32 = tglow._oe_wireframe(toes.ToroidMirror.create(**kw32))
    lines64 = tglow._oe_wireframe(toes.ToroidMirror.create(**kw))
    np.testing.assert_allclose(lines32, lines64, rtol=0, atol=2e-2)
    assert not np.array_equal(lines32, lines64)
