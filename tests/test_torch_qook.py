"""The port's Qook project loader (``xrt_tpu_torch.qook``) on the reference
xrtQook's nine saved projects (``tests/data/qook/*.xml``), against the JAX
package's loader.

* Each project loads in both packages (the JAX package's in one
  subprocess, started first, that writes each beamline's JSON layout) and
  the port's beamline, written as a JSON layout, equals the JAX package's:
  the same elements, classes, flow, materials and skipped parameters, and
  every number to 1e-12 (the writing package's module names aside).  Two
  documented differences: a synchrotron source's layout holds its
  create() arguments in the port (ROADMAP C23), so each number of the JAX
  package's entry (a field) must equal the port element's field of that
  name; and the alignment ray through ``testGrating.xml``'s
  multi-order laminar grating goes out in one of the grating's five orders
  drawn at random (ROADMAP C25), so the screen placed on it follows the
  drawn order: both packages' placements are checked against the five
  orders' directions instead.
* ``tests/test_qook.py`` on the port: each project traced at 3000 rays
  (float64, CPU) keeps its ``min_good`` share of good rays on the last
  screen; 'auto' alignment of ``1crystal.xml``; plots and run card; the
  grating density's five orders and its equivalence with ``Grating``;
  plots of local beams; the branched flow of ``mask_tests.xml`` through a
  JSON round trip.
"""
import torch_harness  # noqa: F401

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import CLEAN_ENV
from xrt_tpu_torch.qook import _alignment_beam, load_qook_project

HERE = os.path.dirname(os.path.abspath(__file__))
QOOK = os.path.join(HERE, 'data', 'qook')
CPU = dict(dtype=torch.float64, device='cpu')
FILES = (('1crystal.xml', 0.5), ('toroid_focus.xml', 0.5),
         ('testGrating.xml', 0.3), ('lens1.xml', 0.5),
         ('4crystals.xml', 0.5), ('testAlignment.xml', 0.5),
         ('BioXAS_Main.xml', 0.05), ('canted_undulators.xml', 0.5),
         ('mask_tests.xml', 0.5))
NAMES = [f for f, _ in FILES]

JAX_CODE = r"""
import json, os, sys
import jax
jax.config.update('jax_enable_x64', True)
from xrt_tpu.qook import load_qook_project
out = {}
for fn in %(names)r:
    with jax.disable_jit():
        prj = load_qook_project(os.path.join(%(qook)r, fn), nrays=3000)
    out[fn] = {'layout': json.loads(prj.beamline.export_to_json()),
               'skipped': {k: sorted(v) for k, v in prj.skipped.items()},
               'plots': [p.beam for p in prj.plots],
               'run': prj.run_kwargs}
with open(%(path)r, 'w') as f:
    json.dump(out, f)
"""


@pytest.fixture(scope='module')
def jax_layouts(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('qook') / 'jax.json')
    code = JAX_CODE % dict(names=NAMES, qook=QOOK, path=path)
    proc = subprocess.Popen([sys.executable, '-c', code], env=CLEAN_ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _jax(jax_layouts, fn):
    proc, path = jax_layouts
    if proc.returncode is None:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, out + err
    with open(path) as f:
        return json.load(f)[fn]


@pytest.fixture(scope='module')
def port_projects():
    return {fn: load_qook_project(os.path.join(QOOK, fn), nrays=3000, **CPU)
            for fn in NAMES}


def _strip_modules(v):
    """The layout without its writer's top-level package names."""
    if isinstance(v, dict):
        return {k: (val.split('.', 1)[1] if k == 'module' else
                    _strip_modules(val)) for k, val in v.items()}
    if isinstance(v, list):
        return [_strip_modules(x) for x in v]
    return v


def _diffs(a, b, path=''):
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f'{path}: keys {sorted(set(a) ^ set(b))}']
        return sum((_diffs(a[k], b[k], f'{path}.{k}') for k in a), [])
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f'{path}: lengths {len(a)}, {len(b)}']
        return sum((_diffs(x, y, f'{path}[{i}]')
                    for i, (x, y) in enumerate(zip(a, b))), [])
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) and \
            not isinstance(a, bool) and not isinstance(b, bool):
        if abs(a - b) <= 1e-12 * max(1.0, abs(a), abs(b)):
            return []
    return [] if a == b else [f'{path}: {a!r} != {b!r}']


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().double().cpu().numpy().tolist()
    if isinstance(v, tuple):
        return [_host(x) for x in v]
    return v


def _grating_slopes(prj, name):
    """dz/dy of the alignment ray from the source leaving the grating
    *name* of testGrating.xml in each of its five orders, through the
    port's grating."""
    bl = prj.beamline
    slopes = []
    for m in (-2, -1, 0, 1, 2):
        beam = _alignment_beam((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), bl.alignE,
                               **CPU)
        out = bl[name].replace(order=m).reflect(
            beam, generator=torch.Generator().manual_seed(0))[0]
        slopes.append(float(out.c[0] / out.b[0]))
    return slopes


@pytest.mark.parametrize('fn', NAMES)
def test_qook_layout_equals_the_jax_packages(jax_layouts, port_projects,
                                             fn):
    ref = _jax(jax_layouts, fn)
    prj = port_projects[fn]
    mine = _strip_modules(json.loads(prj.beamline.export_to_json()))
    theirs = _strip_modules(ref['layout'])
    assert {k: sorted(v) for k, v in prj.skipped.items()} == ref['skipped']
    assert [p.beam for p in prj.plots] == ref['plots']
    assert prj.run_kwargs == ref['run']
    assert [(e['name'], e['class'], e['kind'], e['method'])
            for e in mine['elements']] == \
        [(e['name'], e['class'], e['kind'], e['method'])
         for e in theirs['elements']]
    diffs = []
    for em, et in zip(mine['elements'], theirs['elements']):
        el = prj.beamline[em['name']]
        if getattr(el, 'createArgs', None):
            # C23: the JAX package writes the fields, the port the create
            # arguments; every number of the JAX entry is one of the two
            for k, v in et['params'].items():
                got = _host(getattr(el, k)) if hasattr(el, k) else \
                    em['params'].get(k)
                diffs += _diffs(got, v, f"{em['name']}.{k}")
            et = dict(et, params=em['params'])
        diffs += _diffs(em, et, em['name'])
    if fn == 'testGrating.xml':
        # C25: each screen after a multi-order grating (and the axis state
        # that follows) sits on the order its alignment ray drew: the
        # first by its 'auto' centre, the second by its 'auto' z
        checks = (('LaminarGrating', 'LGScreen',
                   lambda p: p['center'][2] / 1000.0),
                  ('SphericalGrating', 'SGScreen',
                   lambda p: -p['z'][1] / p['z'][2]))
        for grating, screen, slope in checks:
            slopes = _grating_slopes(prj, grating)
            for lay in (mine, theirs):
                scr = next(e for e in lay['elements'] if e['name'] == screen)
                s = slope(scr['params'])
                assert min(abs(s - x) for x in slopes) < 1e-9, (s, slopes)
            diffs = [d for d in diffs
                     if not d.startswith(f'{screen}.params')]
        keep_axis = False
    else:
        keep_axis = True
    axis = _diffs(mine['axis'], theirs['axis'], 'axis')
    assert not diffs, diffs
    assert not axis or not keep_axis, axis
    assert {k: mine[k] for k in ('name', 'azimuth', 'height', 'alignE')} \
        == {k: theirs[k] for k in ('name', 'azimuth', 'height', 'alignE')}


@pytest.mark.parametrize('fn,min_good', FILES, ids=NAMES)
def test_qook_project_traces(port_projects, fn, min_good):
    prj = port_projects[fn]
    assert len(prj.beamline.flow) >= 3
    beams = prj.beamline.propagate_flow(torch.Generator().manual_seed(0))
    last = list(beams)[-1]
    ngood = int((beams[last].state == 1).sum())
    assert ngood > 3000 * min_good, f'{fn}: only {ngood} good rays'


def test_qook_auto_alignment_1crystal(port_projects):
    bl = port_projects['1crystal.xml'].beamline
    crystal = bl['oe01']
    thetaB = float(crystal.material.get_Bragg_angle(10000.0))
    assert math.isclose(float(crystal.pitch), thetaB, rel_tol=2e-3)
    z_expected = 1000.0 * math.tan(2 * float(crystal.pitch))
    assert abs(float(bl['screen01'].center[2]) - z_expected) < 2.0
    beams = bl.propagate_flow(torch.Generator().manual_seed(1))
    img = beams['screen01']
    good = img.state == 1
    assert abs(float(img.z[good].mean())) < 1.0    # local coordinates


def test_qook_plots_and_run_card(port_projects):
    prj = port_projects['1crystal.xml']
    assert prj.run_kwargs.get('repeats') == 1
    assert len(prj.plots) == 1
    assert prj.plots[0].beam == 'screen01'
    assert prj.plots[0].xaxis.bins == 128


def test_qook_grating_density_on_any_oe(port_projects):
    from xrt_tpu_torch import materials as xm
    from xrt_tpu_torch.oes import OE, Grating
    from xrt_tpu_torch.sources import GeometricSource
    prj = load_qook_project(os.path.join(QOOK, 'testGrating.xml'),
                            nrays=4000, **CPU)
    beams = prj.beamline.propagate_flow(torch.Generator().manual_seed(0))
    lg = beams['LaminarGrating']
    good = lg.state == 1
    assert set(torch.unique(lg.order[good]).tolist()) == \
        {-2.0, -1.0, 0.0, 1.0, 2.0}
    mat = xm.EmptyMaterial(kind='grating')
    kw = dict(center=(0, 10000, 0), pitch=5e-2, material=mat, order=1)
    g1 = OE.create(gratingDensity=['y', 300, 1], **kw)
    g2 = Grating.create(rho=300.0, **kw)
    src = GeometricSource.create(nrays=500, distE='lines', energies=(90.0,),
                                 dxprime=1e-5, dzprime=1e-5, **CPU)
    beam = src.shine(torch.Generator().manual_seed(2))
    o1, _ = g1.reflect(beam)
    o2, _ = g2.reflect(beam)
    np.testing.assert_allclose(o1.c.numpy(), o2.c.numpy(), atol=1e-12)


def test_qook_local_beam_plots_map_to_local_keys():
    prj = load_qook_project(os.path.join(QOOK, 'testAlignment.xml'),
                            nrays=500, **CPU)
    assert [p for p in prj.plots if p.beam.endswith('_local')]
    beams = prj.beamline.propagate_flow(torch.Generator().manual_seed(0))
    for p in prj.plots:
        assert p.beam in beams, p.beam


def test_qook_branched_flow_survives_json_roundtrip():
    from xrt_tpu_torch.beamline import BeamLine
    prj = load_qook_project(os.path.join(QOOK, 'mask_tests.xml'),
                            nrays=1000, **CPU)
    bl2 = BeamLine.load_from_json(prj.beamline.export_to_json(), **CPU)
    b1 = prj.beamline.propagate_flow(torch.Generator().manual_seed(3))
    b2 = bl2.propagate_flow(torch.Generator().manual_seed(3))
    last = list(b1)[-1]
    assert torch.equal(b1[last].x, b2[last].x)
    assert any('_input' in kw for *_, kw in bl2.flow)
