"""The port's beamline layouts, flows and alarms against the JAX package.

* ``_element_params`` of each element kind (sources, mirrors, a grating's
  density, a parametric ellipse and hyperbola, a DCM, a plate, apertures,
  a zone plate, a screen) and ``material_to_dict`` of each material kind
  (mirror, plate with a refractive index, grating with efficiencies,
  crystal, cell crystal, multilayer, empty) equal the JAX package's
  dictionaries (up to the writing package's module name); a synchrotron
  source's holds its create() arguments instead, so that its layout
  round-trips (ROADMAP C23: the JAX package's does not).
* A layout written by the JAX package (JSON and XML) loads in the port,
  which imports nothing of the JAX package for it, and its elements trace
  the same numpy rays as the JAX package's: the screen image to 1e-9,
  float64.
* The port's own JSON and XML round trips: the same layout text, and one
  ``propagate_flow`` of the reloaded beamline with the same generator
  seed gives bit-identical beams.
* Ports of ``tests/test_beamline.py``'s flow, alarms, JSON round-trip and
  ``remove`` tests at their limits, and ``reorder`` / ``update``.
"""
import torch_harness  # noqa: F401

import json
import math

import numpy as np
import pytest
import torch
import jax

import xrt_tpu.apertures as ja
import xrt_tpu.materials as jm
import xrt_tpu.oes as jo
import xrt_tpu.screens as jsc
import xrt_tpu.sources as js
from xrt_tpu import beamline as jbl
from xrt_tpu.materials import serialize as jser
from xrt_tpu_torch import apertures as ta
from xrt_tpu_torch import beamline as tbl
from xrt_tpu_torch import interop
from xrt_tpu_torch import materials as tm
from xrt_tpu_torch import oes as to
from xrt_tpu_torch import screens as tsc
from xrt_tpu_torch import sources as ts
from xrt_tpu_torch.materials import serialize as tser

CPU = dict(dtype=torch.float64, device='cpu')
E0 = 9000.0
PORT = dict(ap=ta, m=tm, o=to, sc=tsc, s=ts, bl=tbl, F=CPU)
JAX = dict(ap=ja, m=jm, o=jo, sc=jsc, s=js, bl=jbl, F={})


def line(p, slit=False):
    """tests/test_beamline.py's source -> Si mirror -> screen, placed."""
    bl = p['bl'].BeamLine(alignE=E0)
    bl.add('source', p['s'].GeometricSource.create(
        nrays=3000, dx=0.05, dz=0.02, dxprime=1e-5, dzprime=1e-5,
        distE='lines', energies=(E0,), polarization='horizontal',
        **p['F']))
    mat = p['m'].Material.create('Si', rho=2.33, kind='mirror', **p['F'])
    bl.place('mirror', p['o'].FlatMirror, distance=10000.0, pitch=4e-3,
             material=mat, limPhysX=(-20, 20), limPhysY=(-300, 300))
    if slit:
        bl.place('slit', p['ap'].RectangularAperture, distance=500.0,
                 opening=(-0.3, 0.3, -0.2, 0.2))
    bl.place('screen', p['sc'].Screen, distance=2000.0)
    return bl


def dcm_line(p):
    """Source -> Si(111) DCM (fixed exit) -> slit -> screen."""
    bl = p['bl'].BeamLine(alignE=E0)
    bl.add('source', p['s'].GeometricSource.create(
        nrays=2000, dx=0.05, dz=0.02, dxprime=1e-6, dzprime=1e-6,
        distE='flat', energies=(E0 - 2, E0 + 2), polarization='horizontal',
        **p['F']))
    cr = p['m'].CrystalSi.create(hkl=(1, 1, 1), **p['F'])
    bl.place('dcm', p['o'].DCM, distance=5000.0, material=cr, alignE=E0,
             fixedOffset=20.0, limPhysX=(-50, 50), limPhysY=(-500, 500))
    bl.place('slit', p['ap'].RectangularAperture, distance=500.0,
             opening=(-1.0, 1.0, -1.0, 1.0))
    bl.place('screen', p['sc'].Screen, distance=1000.0)
    return bl


def elements(p):
    o, m, F = p['o'], p['m'], p['F']
    return [
        p['s'].GeometricSource.create(nrays=100, dx=0.1, energies=(E0,),
                                      distE='lines', **F),
        p['s'].Undulator.create(gNodes=64, R0=20000.0, **F),
        o.FlatMirror.create(center=(0, 1000, 0), pitch=3e-3,
                            limPhysX=(-1, 1)),
        o.FlatMirror.create(gratingDensity=['y', 800.0, 1.0, 1e-4]),
        o.ToroidMirror.create(R=1e5, r=50.0, pitch='4 mrad'),
        o.EllipticalMirrorParam.create(p=1000, q=100, pitch=3e-3,
                                       isCylindrical=True),
        o.HyperbolicMirrorParam.create(p=1000, q=100, pitch=3e-3),
        o.DCM.create(material=m.CrystalSi.create(**F), bragg=0.2,
                     fixedOffset=20.0),
        o.Plate.create(t=0.1, material=m.Material.create('Be', rho=1.85,
                                                         **F)),
        o.NormalFZP.create(f=2000.0, E=E0, N=500),
        p['sc'].Screen.create(center=(0, 10, 0)),
        p['ap'].RectangularAperture.create(opening=(-1, 1, -2, 2)),
        p['ap'].RoundAperture.create(r=2.0),
        p['ap'].DoubleSlit.create(shadeFraction=(0.4, 0.6)),
    ]


def materials(p):
    m, F = p['m'], p['F']
    si = m.Material.create('Si', rho=2.33, **F)
    w = m.Material.create('W', rho=19.3, **F)
    return [
        m.Material.create('Rh', rho=12.41, kind='mirror', **F),
        m.Material.create(('Si', 'O'), (1, 2), rho=2.2, kind='plate',
                          refractiveIndex=1.5 + 0.01j, **F),
        m.Material.create('Au', rho=19.3, kind='grating',
                          efficiency=[(1, 0.3), (2, 0.1)], **F),
        m.CrystalSi.create(hkl=(3, 3, 3), **F),
        m.CrystalFromCell.create(name='Cell', hkl=(2, 2, 0), **F),
        m.Multilayer.create(si, 20.0, w, 25.0, 10, si, **F),
        m.EmptyMaterial(),
    ]


def same_but_module(a, b):
    """The dictionaries equal but for the writing package's module name."""
    def norm(v):
        if isinstance(v, dict):
            return {k: (x.split('.', 1)[1] if k == 'module' else norm(x))
                    for k, x in v.items()}
        if isinstance(v, list):
            return [norm(x) for x in v]
        return v
    return norm(a) == norm(b)


@pytest.mark.parametrize('i', range(14))
def test_element_params_equal_jax(i):
    j, t = elements(JAX)[i], elements(PORT)[i]
    assert type(t).__name__ == type(j).__name__
    want = jbl._element_params(j)
    if isinstance(t, ts.Undulator):
        # the port's synchrotron sources record their create() arguments
        # (ROADMAP C23) and the layout holds them in place of the fields
        assert set(want) <= set(tbl._create_signature_names(type(t)))
        want = dict(t.createArgs)
    assert tbl._element_params(t) == want
    assert same_but_module(tbl._element_materials(t),
                           jbl._element_materials(j))


def test_synchrotron_source_layout_round_trips():
    """ROADMAP C23: a synchrotron source's fields hold derived values in
    other units (the acceptance in rad where create() takes mrad, the
    e-beam sizes from the emittances, no period), so the JAX package's
    layout of an undulator reloads as another source.  The port's sources
    record their create() arguments, and their layouts round-trip."""
    kw = dict(nrays=200, eEpsilonX=0.263, eEpsilonZ=0.008, period=18.0,
              n=111, targetE=(E0, 7), xPrimeMax=0.02, zPrimeMax=0.02,
              gNodes=64, eMin=E0 - 40, eMax=E0 + 40)
    for p, extra in ((JAX, {}), (PORT, CPU)):
        bl = p['bl'].BeamLine()
        bl.add('source', p['s'].Undulator.create(**kw, **p['F']))
        back = p['bl'].BeamLine.load_from_json(bl.export_to_json(),
                                               **extra)['source']
        same = (float(back.xPrimeMax), float(back.dx), float(back.L0)) == \
            (float(bl['source'].xPrimeMax), float(bl['source'].dx),
             float(bl['source'].L0))
        assert same == (p is PORT)
    for src in (ts.BendingMagnet.create(B0=1.7, xPrimeMax=0.2, **CPU),
                ts.Wiggler.create(K=12.0, period=60.0, n=20, **CPU),
                ts.SourceFromField.create(customField=None, n=3, gNodes=64,
                                          **CPU)):
        bl = tbl.BeamLine()
        bl.add('source', src)
        back = tbl.BeamLine.load_from_json(bl.export_to_json(),
                                           **CPU)['source']
        for k, v in vars(src).items():
            if isinstance(v, (float, int, str)):
                assert getattr(back, k) == v, (type(src).__name__, k)


@pytest.mark.parametrize('i', range(7))
def test_material_to_dict_equal_jax(i):
    j, t = materials(JAX)[i], materials(PORT)[i]
    d = tser.material_to_dict(t)
    assert same_but_module(d, jser.material_to_dict(j))
    back = tser.material_from_dict(d, **CPU)
    assert type(back) is type(t)
    assert tser.material_to_dict(back) == d


def trace(bl, beam):
    """The flow after the source on *beam*: the screen's image."""
    for name, kind, method, kw in bl.flow[1:]:
        el = bl[name]
        if method == 'propagate':
            beam = el.propagate(beam, needNewGlobal=True)[0]
        elif method == 'expose':
            return el.expose(beam)
        else:
            beam = getattr(el, method)(beam)[0]


@pytest.mark.parametrize('fmt', ['json', 'xml'])
def test_jax_layout_traces_as_jax(fmt):
    jb = dcm_line(JAX)
    text = getattr(jb, 'export_to_' + fmt)()
    tb = getattr(tbl.BeamLine, 'load_from_' + fmt)(text, **CPU)
    assert [s[:3] for s in tb.flow] == [s[:3] for s in jb.flow]
    for name in ('source', 'dcm', 'slit', 'screen'):
        assert tbl._element_params(tb[name]) == \
            jbl._element_params(jb[name]), name
    jbeam = jb['source'].shine(jax.random.PRNGKey(4))
    jimg = trace(jb, jbeam)
    timg = trace(tb, interop.beam_from_numpy(
        {k: np.asarray(v) for k, v in vars(jbeam).items()
         if v is not None and np.ndim(v) > 0}, **CPU))
    np.testing.assert_array_equal(timg.state.numpy(), np.asarray(jimg.state))
    assert (timg.state == 1).sum() > 100
    for f in ('x', 'z', 'Jss', 'Jpp'):
        t, j = getattr(timg, f).numpy(), np.asarray(getattr(jimg, f))
        scale = max(float(np.abs(j).max()), 1.0)
        assert np.abs(t - j).max() < 1e-9 * scale, f


@pytest.mark.parametrize('fmt', ['json', 'xml'])
def test_port_roundtrip_traces_identically(fmt):
    bl = line(PORT, slit=True)
    text = getattr(bl, 'export_to_' + fmt)()
    bl2 = getattr(tbl.BeamLine, 'load_from_' + fmt)(text, **CPU)
    assert getattr(bl2, 'export_to_' + fmt)() == text
    b1 = bl.propagate_flow(torch.Generator().manual_seed(7))
    b2 = bl2.propagate_flow(torch.Generator().manual_seed(7))
    assert sorted(b1) == sorted(b2)
    for f in ('x', 'z', 'Jss', 'state'):
        assert torch.equal(getattr(b1['screen'], f),
                           getattr(b2['screen'], f)), f


def test_auto_alignment_axis():
    scr = line(PORT)['screen']
    c = [float(v) for v in scr.center]
    np.testing.assert_allclose(c[1], 10000.0 + 2000.0 * math.cos(8e-3),
                               rtol=1e-9)
    np.testing.assert_allclose(c[2], 2000.0 * math.sin(8e-3), rtol=1e-9)


def test_propagate_flow():
    beams = line(PORT).propagate_flow(torch.Generator().manual_seed(0))
    assert set(beams) >= {'source', 'mirror', 'mirror_local', 'screen'}
    img = beams['screen']
    good = img.state.numpy() == 1
    assert good.mean() > 0.95
    assert abs(img.z.numpy()[good].mean()) < 0.1


def test_dcm_auto_bragg_placement():
    beams = dcm_line(PORT).propagate_flow(torch.Generator().manual_seed(2))
    assert set(beams) >= {'dcm', 'dcm_local1', 'dcm_local2', 'slit'}
    assert (beams['dcm'].state.numpy() == 1).mean() > 0.5


def test_alarms():
    bl = tbl.BeamLine(alignE=E0)
    bl.add('source', ts.GeometricSource.create(
        nrays=2000, dx=0.5, dz=0.5, dxprime=0.0, dzprime=0.0,
        distxprime=None, distzprime=None, distE='lines', energies=(E0,),
        polarization='horizontal', **CPU))
    bl.add('slit', ta.RectangularAperture.create(
        center=(0, 1000.0, 0), opening=(-0.05, 0.05, -0.05, 0.05)))
    beams = bl.propagate_flow(torch.Generator().manual_seed(3))
    alarms = bl.check_alarms(beams, threshold=0.5)
    assert len(alarms) == 1 and 'slit' in alarms[0]


def test_json_roundtrip(tmp_path):
    bl = line(PORT)
    fn = tmp_path / 'layout.json'
    bl.export_to_json(str(fn))
    mat = tm.Material.create('Si', rho=2.33, kind='mirror', **CPU)
    bl2 = tbl.BeamLine.load_from_json(str(fn), materials={'mirror': mat},
                                      **CPU)
    assert bl2['mirror'].material is mat
    assert bl2['mirror'].center == bl['mirror'].center
    assert float(bl2['mirror'].pitch) == float(bl['mirror'].pitch)
    np.testing.assert_array_equal(bl2.axis_point, bl.axis_point)
    beams = bl2.propagate_flow(torch.Generator().manual_seed(4))
    assert (beams['screen'].state.numpy() == 1).mean() > 0.9
    layout = json.loads(fn.read_text())
    assert layout['elements'][1]['module'] == 'xrt_tpu_torch.oes.mirrors'


def test_remove_with_same_class_sibling_and_axis_rewind():
    bl = tbl.BeamLine()
    bl.add('src', ts.GeometricSource.create(nrays=10, energies=(9000.,),
                                            distE='lines', **CPU))
    s1 = tsc.Screen.create(center=(0, 1000.0, 0))
    bl.add('s1', s1)
    bl.place('s2', tsc.Screen, distance=500.0)
    c2 = np.asarray(bl['s2'].center, float)
    bl.remove('s2')
    assert 's2' not in bl._elements
    assert sum(1 for e in bl.screens if e is s1) == 1
    assert all(nm != 's2' for nm, *_ in bl.flow)
    bl.place('s2b', tsc.Screen, distance=500.0)
    assert np.allclose(np.asarray(bl['s2b'].center, float), c2)


def test_reorder_and_update():
    bl = line(PORT)
    with pytest.raises(ValueError):
        bl.reorder(['screen', 'mirror'])
    bl.reorder(['source', 'screen', 'mirror'])
    assert [s[0] for s in bl.flow] == ['source', 'screen', 'mirror']
    new = bl['mirror'].replace(pitch=5e-3)
    old = bl['mirror']
    bl.update('mirror', new)
    assert bl['mirror'] is new
    assert any(e is new for e in bl.oes) and not any(e is old
                                                     for e in bl.oes)
