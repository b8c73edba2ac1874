"""The port's EPICS layer (``xrt_tpu_torch.epics``) against the JAX
package's ``xrt_tpu/epics.py``, float64, CPU.

* ``tests/test_epics.py``'s beamline in both packages: every element's
  records (names, labels, paths, kinds, access, groups, units) equal and
  in the same order, initial values to 1e-12; the categories and the
  workflow records equal; the ``.bob`` screens byte-identical (the class
  name in a screen's title names each package's own module: the port's
  is compared with the package prefix mapped).
* The nine reference xrtQook projects (``tests/data/qook``), loaded by
  the JAX package in a subprocess (eagerly) and by the port: the same,
  but for two documented differences.  The JAX package's synchrotron
  sources carry a field ``Imax_hint`` that nothing sets or reads (always
  0.0), published as a PV; the port has no such field, so the JAX
  package's records and screens are compared without it.  The screen
  placed on ``testGrating.xml``'s multi-order grating follows the order
  the alignment ray draws (ROADMAP C25): its centre's values are left
  out.
* ``tests/test_epics.py`` on the port: the schema covers the tunables,
  the categories, the workflow records, the screens, ``EpicsIOC`` without
  ``softioc`` raising ``ImportError``, the TCP server taking the schema's
  addresses, and ``EpicsIOC`` on a stand-in ``softioc`` module: a write
  replays the recorded flow, and the flux readback equals a full
  re-trace's to 1e-9.
"""
import torch_harness  # noqa: F401

import json
import os
import socket
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import xrt_tpu.materials as jm
import xrt_tpu_torch.materials as tm
from conftest import CLEAN_ENV
from xrt_tpu import apertures as japs, epics as je, oes as joes, \
    screens as jscr, sources as jsrc
from xrt_tpu.beamline import BeamLine as JBeamLine
from xrt_tpu_torch import apertures as taps, epics as te, oes as toes, \
    screens as tscr, sources as tsrc
from xrt_tpu_torch.beamline import BeamLine as TBeamLine
from xrt_tpu_torch.qook import load_qook_project

HERE = os.path.dirname(os.path.abspath(__file__))
QOOK = os.path.join(HERE, 'data', 'qook')
NAMES = sorted(f for f in os.listdir(QOOK) if f.endswith('.xml'))
CPU = dict(dtype=torch.float64, device='cpu')
E0 = 9000.0


def build_bl(port):
    """``tests/test_epics.py``'s beamline in either package."""
    kw = CPU if port else {}
    BL, mats, src, oes, aps, scr = (
        (TBeamLine, tm, tsrc, toes, taps, tscr) if port else
        (JBeamLine, jm, jsrc, joes, japs, jscr))
    bl = BL(name='epics-test', alignE=E0)
    bl.add('source', src.GeometricSource.create(
        nrays=1000, dx=0.1, dz=0.05, dxprime=1e-5, dzprime=1e-5,
        distE='flat', energies=(E0 - 10, E0 + 10),
        polarization='horizontal', **kw))
    bl.place('slit', aps.RectangularAperture, distance=5000.0,
             opening=(-1, 1, -1, 1))
    bl.place('m1', oes.ToroidMirror, distance=5000.0, pitch=4e-3,
             deflection='up', R=1e6, r=40.0,
             material=mats.Material.create('Rh', rho=12.41, **kw),
             limPhysX=(-20, 20), limPhysY=(-300, 300))
    bl.place('screen', scr.Screen, distance=2000.0)
    return bl


def pv_rows(spec):
    """The records of an element spec without their values."""
    return [(p.record, p.label, p.property_path, p.kind, p.access, p.group,
             json.dumps(p.metadata, sort_keys=True)) for p in spec.pvs]


def values(spec):
    return {p.record: p.initial_value for p in spec.pvs}


def assert_values(got, want, skip=()):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in skip:
            continue
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
        else:
            assert got[k] == v, k


def bob_texts(root, port):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            text = open(os.path.join(d, f)).read()
            if port:
                text = text.replace('(xrt_tpu_torch.', '(xrt_tpu.')
            out[os.path.relpath(os.path.join(d, f), root)] = text
    return out


def test_records_against_jax(tmp_path):
    jbl, tbl = build_bl(False), build_bl(True)
    js, ts = list(je.iter_element_specs(jbl)), list(te.iter_element_specs(
        tbl))
    assert [(s.name, s.valid_name, s.category) for s in ts] == \
        [(s.name, s.valid_name, s.category) for s in js]
    for t, j in zip(ts, js):
        assert t.class_name.replace('xrt_tpu_torch.', 'xrt_tpu.') == \
            j.class_name
        assert pv_rows(t) == pv_rows(j)
        assert_values(values(t), values(j))
        assert te.categorize_element(tbl[t.name]) == \
            je.categorize_element(jbl[j.name])
    assert te.workflow_records() == [te.PvSpec(*(getattr(p, f) for f in (
        'record', 'label', 'property_path', 'kind', 'access',
        'initial_value', 'group', 'metadata')))
        for p in je.workflow_records()]
    jfiles = je.generate_bob_screens(jbl, str(tmp_path / 'jax'))
    tfiles = te.generate_bob_screens(tbl, str(tmp_path / 'port'))
    assert len(tfiles) == len(jfiles) == 5
    assert bob_texts(str(tmp_path / 'port'), True) == \
        bob_texts(str(tmp_path / 'jax'), False)


JAX_QOOK = r"""
import json, os, sys
import jax
jax.config.update('jax_enable_x64', True)
from xrt_tpu import epics as je
from xrt_tpu.qook import load_qook_project
out = {}
for fn in %(names)r:
    with jax.disable_jit():
        bl = load_qook_project(os.path.join(%(qook)r, fn),
                               nrays=3000).beamline
    specs = []
    root = os.path.join(%(bob)r, fn)
    w = je.BobWriter()
    for s in je.iter_element_specs(bl):
        pvs = [p for p in s.pvs if p.property_path != 'Imax_hint']
        specs.append({'name': s.name, 'class_name': s.class_name,
                      'category': s.category,
                      'pvs': [dict(record=p.record, label=p.label,
                                   property_path=p.property_path,
                                   kind=p.kind, access=p.access,
                                   initial_value=p.initial_value,
                                   group=p.group, metadata=p.metadata)
                              for p in pvs]})
        d = os.path.join(root, s.category)
        os.makedirs(d, exist_ok=True)
        w.write(os.path.join(d, s.valid_name + '.bob'),
                f'{s.name} ({s.class_name})', pvs)
    w.write(os.path.join(root, 'workflow.bob'), 'Beamline workflow',
            je.workflow_records())
    out[fn] = specs
with open(%(path)r, 'w') as f:
    json.dump(out, f)
"""


@pytest.fixture(scope='module')
def jax_qook(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('epics')
    path, bob = str(tmp / 'jax.json'), str(tmp / 'bob')
    code = JAX_QOOK % dict(names=NAMES, qook=QOOK, path=path, bob=bob)
    proc = subprocess.Popen([sys.executable, '-c', code], env=CLEAN_ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    with open(path) as f:
        return json.load(f), bob


def test_qook_records_and_screens(jax_qook, tmp_path):
    jspecs, jbob = jax_qook
    assert sorted(jspecs) == NAMES and len(NAMES) == 9
    for fn in NAMES:
        bl = load_qook_project(os.path.join(QOOK, fn), nrays=3000,
                               **CPU).beamline
        ts = list(te.iter_element_specs(bl))
        js = jspecs[fn]
        assert [(s.name, s.category) for s in ts] == \
            [(s['name'], s['category']) for s in js], fn
        for t, j in zip(ts, js):
            assert t.class_name.replace('xrt_tpu_torch.', 'xrt_tpu.') == \
                j['class_name']
            assert pv_rows(t) == [
                (p['record'], p['label'], p['property_path'], p['kind'],
                 p['access'], p['group'],
                 json.dumps(p['metadata'], sort_keys=True))
                for p in j['pvs']], (fn, t.name)
            skip = {f'{t.valid_name}:center:{c}' for c in 'xyz'} \
                if (fn, t.name) == ('testGrating.xml', 'LGScreen') else ()
            assert_values(values(t), {p['record']: p['initial_value']
                                      for p in j['pvs']}, skip)
        out = str(tmp_path / fn)
        files = te.generate_bob_screens(bl, out)
        assert len(files) == len(ts) + 1
        assert bob_texts(out, True) == bob_texts(os.path.join(jbob, fn),
                                                 False), fn


# ---------------------------------------------------------------------------
# tests/test_epics.py on the port
# ---------------------------------------------------------------------------

def test_schema_covers_tunables():
    """Every scalar float field of every element appears as a writable
    number PV named element:field (the server's addressing)."""
    from xrt_tpu_torch.beamline import _fields
    bl = build_bl(True)
    specs = {s.name: s for s in te.iter_element_specs(bl)}
    assert set(specs) == {'source', 'slit', 'm1', 'screen'}
    for name, spec in specs.items():
        el = bl[name]
        recs = {pv.record: pv for pv in spec.pvs}
        assert f'{spec.valid_name}:name' in recs
        assert recs[f'{spec.valid_name}:flux'].access == 'ro'
        assert recs[f'{spec.valid_name}:image'].kind == 'waveform'
        for fname in _fields(el):
            v = getattr(el, fname, None)
            if v is None or isinstance(v, (str, bool, dict, tuple)):
                continue
            if fname in ('material', 'material2', 'figure_error',
                         'createArgs'):
                continue
            if isinstance(v, float) or (isinstance(v, torch.Tensor) and
                                        v.ndim == 0):
                pv = recs.get(f'{spec.valid_name}:{fname}')
                assert pv is not None, f'{name}:{fname} missing from schema'
                assert pv.access == 'rw' and pv.kind == 'number'
                assert pv.initial_value == float(v)
        if getattr(el, 'center', None) is not None:
            for comp in 'xyz':
                assert f'{spec.valid_name}:center:{comp}' in recs


def test_element_categories():
    cats = {s.name: s.category for s in te.iter_element_specs(build_bl(
        True))}
    assert cats == {'source': 'sources', 'slit': 'apertures',
                    'm1': 'oes', 'screen': 'screens'}


def test_workflow_records():
    recs = {pv.record: pv for pv in te.workflow_records()}
    assert recs['Acquire'].kind == 'bool_command'
    assert recs['AcquireStatus'].access == 'ro'
    assert recs['AutoUpdate'].initial_value == 1


def test_bob_generation(tmp_path):
    bl = build_bl(True)
    files = te.generate_bob_screens(bl, str(tmp_path))
    assert len(files) == 5
    assert os.path.exists(tmp_path / 'oes' / 'm1.bob')
    assert os.path.exists(tmp_path / 'workflow.bob')
    root = ET.parse(tmp_path / 'oes' / 'm1.bob').getroot()
    assert root.tag == 'display'
    pv_names = [w.find('pv_name').text for w in root.findall('widget')
                if w.find('pv_name') is not None]
    spec = [s for s in te.iter_element_specs(bl) if s.name == 'm1'][0]
    for pv in spec.pvs:
        assert f'$(P){pv.record}' in pv_names
    wtypes = {w.find('pv_name').text: w.get('type')
              for w in root.findall('widget')
              if w.find('pv_name') is not None}
    assert wtypes['$(P)m1:pitch'] == 'textentry'
    assert wtypes['$(P)m1:flux'] == 'textupdate'


def test_ioc_graceful_without_softioc():
    bl = build_bl(True)
    try:
        import softioc  # noqa
        have = True
    except ImportError:
        have = False
    if have:
        assert te.EpicsIOC(bl).records
    else:
        with pytest.raises(ImportError, match='BeamLineServer'):
            te.EpicsIOC(bl)


def test_protocol_conformance_with_server():
    from xrt_tpu_torch.server import BeamLineServer
    bl = build_bl(True)
    spec = [s for s in te.iter_element_specs(bl) if s.name == 'm1'][0]
    pv = [p for p in spec.pvs if p.record == 'm1:pitch'][0]
    assert pv.access == 'rw'
    srv = BeamLineServer(bl, autoUpdate=False, port=0, device='cpu').start()
    try:
        with socket.create_connection((srv.host, srv.port),
                                      timeout=60) as s:
            f = s.makefile('rw')
            f.write(json.dumps({'cmd': 'set', 'pv': pv.record,
                                'value': 5e-3}) + '\n')
            f.flush()
            resp = json.loads(f.readline())
            assert resp.get('ok'), resp
        assert abs(float(bl['m1'].pitch) - 5e-3) < 1e-12
    finally:
        srv.stop()


def fake_softioc(monkeypatch):
    """A stand-in ``softioc`` module with the builder and record interface
    ``EpicsIOC`` uses (``tests/test_epics.py``'s); returns the records it
    made."""
    import types

    class FakeRecord:
        def __init__(self, name, initial_value=None, on_update=None):
            self.name = name
            self.value = initial_value
            self.on_update = on_update

        def set(self, v):
            self.value = v

        def get(self):
            return self.value

        def caput(self, v):          # what a client write does
            self.value = v
            if self.on_update is not None:
                self.on_update(v)

    made = {}

    def _rec(kind):
        def f(record, initial_value=None, on_update=None, **kw):
            r = FakeRecord(record, initial_value, on_update)
            made[record] = (kind, r)
            return r
        return f

    builder = types.SimpleNamespace(
        aOut=_rec('aOut'), aIn=_rec('aIn'), boolOut=_rec('boolOut'),
        boolIn=_rec('boolIn'), stringIn=_rec('stringIn'),
        WaveformIn=_rec('WaveformIn'),
        SetDeviceName=lambda p: made.setdefault('~device', p),
        LoadDatabase=lambda: made.setdefault('~loaded', True))
    fake = types.ModuleType('softioc')
    fake.builder = builder
    fake.softioc = types.SimpleNamespace(iocInit=lambda: None)
    monkeypatch.setitem(sys.modules, 'softioc', fake)
    monkeypatch.setitem(sys.modules, 'softioc.builder', builder)
    return made


def readbacks(results, bins=128):
    """{element: {'flux', 'image'}} of flow outputs: the good rays' flux
    and their (bins, bins) histogram (``histogram.hist2d``)."""
    from xrt_tpu_torch.histogram import hist2d
    out = {}
    for key, val in results.items():
        b = val[0] if isinstance(val, tuple) else val
        if key.startswith('~') or not hasattr(b, 'state'):
            continue
        w = torch.where(b.state == 1, b.Jss + b.Jpp, 0.0)
        out[key.split('.')[0]] = {
            'flux': float(w.sum()),
            'image': hist2d(b.x, b.z, w, bins, bins, (-2, 2), (-2, 2))}
    return out


def test_epics_ioc_with_fake_softioc(monkeypatch):
    """The IOC's runtime path on the stand-in: a record for every PV, a
    write that replaces the element field and (AutoUpdate on) replays the
    recorded flow from the changed element, flux and image readbacks, the
    Acquire record; every readback equals a full re-trace's."""
    from xrt_tpu_torch.flow import record_flow
    made = fake_softioc(monkeypatch)
    bl = build_bl(True)
    with record_flow(bl) as flow:
        bl.propagate_flow(torch.Generator().manual_seed(0))
    recorded = dict(bl._elements)
    traces = {'n': 0}

    def trace_fn(bl_):
        traces['n'] += 1
        changed = {n: el for n, el in bl_._elements.items()
                   if el is not recorded[n]}
        return readbacks(flow.replay(replace=changed))

    def retrace():
        fresh = TBeamLine()
        for name, kind, method, kw in bl.flow:
            fresh.add(name, bl[name], kind, method, **kw)
        return readbacks(fresh.propagate_flow(
            torch.Generator().manual_seed(0)))

    ioc = te.EpicsIOC(bl, prefix='XRT:', trace_fn=trace_fn)
    for el in ('source', 'slit', 'm1'):
        assert f'{el}:flux' in ioc.records
        assert f'{el}:image' in ioc.records
    assert 'm1:pitch' in ioc.records
    assert made['~loaded'] is True

    ioc.records['Acquire'].caput(1)
    assert traces['n'] == 1
    f0 = ioc.records['m1:flux'].get()
    assert f0 and f0 > 0
    img = np.asarray(ioc.records['m1:image'].get())
    assert img.size == 128 * 128 and img.sum() > 0

    ioc.records['AutoUpdate'].set(True)
    p0 = float(bl['m1'].pitch)
    for k, dp in enumerate((2e-4, -1e-4, 3e-4)):
        ioc.records['m1:pitch'].caput(p0 + dp)
        assert traces['n'] == 2 + k
        assert float(bl['m1'].pitch) == p0 + dp
        full = retrace()
        for name in ('m1', 'screen'):
            assert ioc.records[f'{name}:flux'].get() == pytest.approx(
                full[name]['flux'], rel=1e-9)
        np.testing.assert_allclose(
            ioc.records['screen:image'].get(),
            full['screen']['image'].numpy().ravel().astype(np.float32),
            rtol=1e-6, atol=0)
        assert ioc.records['screen:image'].get().sum() > 0

    ioc.records['m1:center:z'].caput(1.5)
    assert float(bl['m1'].center[2]) == 1.5
    assert traces['n'] == 5

    ioc.records['AutoUpdate'].set(False)
    ioc.records['m1:pitch'].caput(p0)
    assert traces['n'] == 5
