"""The port's flow capture and replay (``xrt_tpu_torch.flow``) and its
control server (``xrt_tpu_torch.server``), on the CPU.

The JAX package's ``test_flow.py`` and ``test_server.py`` on the port:
capture of every propagation call with automatic and beamline names, a
replay after a ``replace`` of the mirror bitwise equal to a full re-trace
with the same generator seed (each recorded step keeps the state of its
generators), an unchanged replay equal to the recording, scoped
recording, the JSON-lines server's list / get / set / acquire / shutdown
with a trace function, with a BeamLine, and a ``set`` that replays a
recorded flow from the changed element.  The flux and centroid readbacks
of the replayed flow equal a full re-trace's to 1e-9 mm, the JAX test's
limit.  Both packages capture the same steps of the same user code.
"""
import torch_harness  # noqa: F401

import json
import math
import socket

import numpy as np
import pytest
import torch
import jax

from xrt_tpu_torch import materials as tm
from xrt_tpu_torch.beamline import BeamLine
from xrt_tpu_torch.flow import record_flow
from xrt_tpu_torch.oes import FlatMirror
from xrt_tpu_torch.screens import Screen
from xrt_tpu_torch.server import BeamLineClient, BeamLineServer, _params_of
from xrt_tpu_torch.sources import GeometricSource

CPU = dict(dtype=torch.float64, device='cpu')


def _setup(mods=None):
    """tests/test_flow.py's source -> toroid -> slit / screen."""
    if mods is None:
        from xrt_tpu_torch import apertures, oes, screens, sources
        F, mat_mod = CPU, tm
    else:
        apertures, oes, screens, sources, mat_mod = mods
        F = {}
    pitch = 4e-3
    p, q = 10000.0, 2000.0
    mat = mat_mod.Material.create('Si', rho=2.33, kind='mirror', **F)
    src = sources.GeometricSource.create(
        nrays=2000, center=(0, 0, 0), dx=0.1, dz=0.05, dxprime=3e-5,
        dzprime=3e-5, distE='flat', energies=(8900.0, 9100.0),
        polarization='horizontal', **F)
    R = 2 * p * q / (p + q) / math.sin(pitch)
    r = 2 * p * q / (p + q) * math.sin(pitch)
    mirror = oes.ToroidMirror.create(center=(0, p, 0), pitch=pitch, R=R,
                                     r=r, material=mat, limPhysX=(-20, 20),
                                     limPhysY=(-300, 300))
    slit = apertures.RectangularAperture.create(
        center=(0, p + 500, 2 * pitch * 500), opening=(-5, 5, -5, 5))
    screen = screens.Screen.create(center=(0, p + q, 2 * pitch * q))
    return src, mirror, slit, screen


def _run(src, mirror, slit, screen, seed):
    g = torch.Generator().manual_seed(seed)
    beam = src.shine(g)
    glo, lo = mirror.reflect(beam, generator=g)
    loc = slit.propagate(glo)
    img = screen.expose(glo)
    return beam, glo, lo, loc, img


def test_capture_and_bitwise_replay():
    src, mirror, slit, screen = _setup()
    with record_flow() as flow:
        beam, glo, lo, loc, img = _run(src, mirror, slit, screen, 7)
    assert [s.method for s in flow.steps] == \
        ['shine', 'reflect', 'propagate', 'expose']
    mirror2 = mirror.replace(pitch=mirror.pitch + 2e-5)
    out = flow.replay(replace={flow.steps[1].name: mirror2})
    _, _, _, loc_t, img_t = _run(src, mirror2, slit, screen, 7)
    sname, apname, scname = (flow.steps[i].name for i in (0, 2, 3))
    # upstream beam comes from the cache: the identical object
    assert out[f'{sname}.shine'] is flow.steps[0].out
    # downstream results bitwise equal to the full re-trace
    assert torch.equal(out[f'{scname}.expose'].x, img_t.x)
    assert torch.equal(out[f'{scname}.expose'].Jss, img_t.Jss)
    assert torch.equal(out[f'{apname}.propagate'].state, loc_t.state)
    # and different from the original: the pitch change had an effect
    assert not torch.equal(out[f'{scname}.expose'].z, img.z)


def _tensors(v):
    import dataclasses
    for b in v if isinstance(v, tuple) else (v,):
        for f in dataclasses.fields(b):
            t = getattr(b, f.name)
            if isinstance(t, torch.Tensor):
                yield f.name, t


def test_replay_without_changes_redraws_the_same_rays():
    """With nothing replaced every step runs again, each generator from
    its recorded state: the same bits as the recording."""
    src, mirror, slit, screen = _setup()
    with record_flow() as flow:
        _run(src, mirror, slit, screen, 1)
    out = flow.replay()
    assert list(out) == [f'{s.name}.{s.method}' for s in flow.steps]
    for s in flow.steps:
        got = out[f'{s.name}.{s.method}']
        assert got is not s.out
        for (name, a), (_, b) in zip(_tensors(s.out), _tensors(got)):
            assert torch.equal(a, b), (s, name)


def test_named_elements_via_beamline_and_propagate_flow():
    src, mirror, slit, screen = _setup()
    bl = BeamLine()
    for name, el in (('src', src), ('m1', mirror), ('slit', slit),
                     ('scr', screen)):
        bl.add(name, el)
    with record_flow(bl) as flow:
        _run(bl['src'], bl['m1'], bl['slit'], bl['scr'], 0)
    assert [s.name for s in flow.steps] == ['src', 'm1', 'slit', 'scr']
    out = flow.replay(replace={'m1': mirror.replace(pitch=4.2e-3)})
    assert 'scr.expose' in out
    # propagate_flow goes back to global after the slit: that step is
    # captured too, so the screen's input is tracked across it
    with record_flow(bl) as flow2:
        ref = bl.propagate_flow(torch.Generator().manual_seed(2))
    assert ('slit', '_to_global') in [(s.name, s.method)
                                      for s in flow2.steps]
    m2 = mirror.replace(pitch=4.1e-3)
    out = flow2.replay(replace={'m1': m2})
    bl.update('m1', m2)
    truth = bl.propagate_flow(torch.Generator().manual_seed(2))
    assert torch.equal(out['scr.expose'].z, truth['scr'].z)
    assert not torch.equal(truth['scr'].z, ref['scr'].z)


def test_replay_unknown_name_raises():
    src, mirror, slit, screen = _setup()
    with record_flow() as flow:
        _run(src, mirror, slit, screen, 0)
    with pytest.raises(KeyError):
        flow.replay(replace={'nope': mirror})


def test_recording_is_scoped():
    src, mirror, slit, screen = _setup()
    with record_flow() as flow:
        src.shine(torch.Generator().manual_seed(0))
    n = len(flow.steps)
    src.shine(torch.Generator().manual_seed(1))
    assert len(flow.steps) == n


def test_both_packages_capture_the_same_steps():
    import xrt_tpu.apertures as ja
    import xrt_tpu.materials as jm
    import xrt_tpu.oes as jo
    import xrt_tpu.screens as jsc
    import xrt_tpu.sources as js
    from xrt_tpu.flow import record_flow as jrecord
    jsrc, jmirror, jslit, jscreen = _setup((ja, jo, jsc, js, jm))
    with jrecord() as jflow:
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        b = jsrc.shine(k1)
        glo, _ = jmirror.reflect(b, k2)
        jslit.propagate(glo)
        jscreen.expose(glo)
    with record_flow() as flow:
        _run(*_setup(), 0)
    assert [s.method for s in flow.steps] == \
        [s.method for s in jflow.steps]
    assert [s.name.split('_')[0] for s in flow.steps] == \
        [s.name.split('_')[0] for s in jflow.steps]


def _make():
    src = GeometricSource.create(nrays=500, dzprime=1e-5,
                                 energies=(9000.0,), distE='lines', **CPU)
    mirror = FlatMirror.create(center=(0, 1000.0, 0), pitch=4e-3,
                               limPhysX=(-20, 20), limPhysY=(-200, 200))
    screen = Screen.create(center=(0, 2000.0, 0))

    def trace(elements):
        g = torch.Generator().manual_seed(0)
        beam = elements['source'].shine(g)
        glo, _ = elements['mirror'].reflect(beam, generator=g)
        img = elements['screen'].expose(glo)
        good = (glo.state == 1).numpy()
        return {'z_mean': float(img.z.numpy()[good].mean()),
                'ngood': int(good.sum())}
    return {'source': src, 'mirror': mirror, 'screen': screen}, trace


def test_server_get_set_acquire():
    elements, trace = _make()
    srv = BeamLineServer(elements, trace_fn=trace, device='cpu').start()
    try:
        cli = BeamLineClient(srv.host, srv.port)
        pvs = cli.list()
        assert 'mirror' in pvs and 'pitch' in pvs['mirror']
        assert pvs['mirror']['center'] == [0.0, 1000.0, 0.0]
        assert np.isclose(cli.get('mirror:pitch'), 4e-3)
        r0 = cli.acquire()
        assert r0['ngood'] > 400
        # the beam lands at z ~ 2 pitch q above the axis
        assert np.isclose(r0['z_mean'], 2 * 4e-3 * 1000.0, rtol=0.05)
        # a new pitch: autoUpdate re-traces and the spot moves
        r1 = cli.set('mirror:pitch', 5e-3)['result']
        assert np.isclose(r1['z_mean'], 2 * 5e-3 * 1000.0, rtol=0.05)
        assert np.isclose(cli.get('mirror:pitch'), 5e-3)
        assert isinstance(srv.elements['mirror'].pitch, float)
        # an unknown pv errors without killing the server
        assert 'error' in cli.request(cmd='get', pv='mirror:nope')
        assert 'error' in cli.request(cmd='frobnicate')
        assert np.isclose(cli.get('mirror:pitch'), 5e-3)
        assert cli.request(cmd='shutdown') == {'ok': True}
        cli.close()
    finally:
        srv.stop()


def test_server_with_beamline_object():
    elements, trace = _make()
    bl = BeamLine()
    for name, el in elements.items():
        bl.add(name, el)
    srv = BeamLineServer(bl, trace_fn=trace, autoUpdate=False,
                         device='cpu').start()
    try:
        cli = BeamLineClient(srv.host, srv.port)
        assert cli.set('mirror:pitch', 6e-3).get('ok')
        assert np.isclose(float(bl['mirror'].pitch), 6e-3)
        # a tensor parameter stays a tensor of its dtype
        bl.update('mirror', bl['mirror'].replace(
            roll=torch.tensor(0.0, dtype=torch.float64)))
        srv.elements['mirror'] = bl['mirror']
        cli.set('mirror:roll', 1e-4)
        assert bl['mirror'].roll.dtype == torch.float64
        r = cli.acquire()
        assert np.isclose(r['z_mean'], 2 * 6e-3 * 1000.0, rtol=0.05)
        cli.close()
    finally:
        srv.stop()


def test_params_of_reads_numbers_tensors_and_vectors():
    m = FlatMirror.create(center=(0, 10.0, 0), pitch=torch.tensor(3e-3),
                          limPhysX=(-20, 20), limPhysY=(-200, 200))
    p = _params_of(m)
    assert p['pitch'] == pytest.approx(3e-3)
    assert p['center'] == [0.0, 10.0, 0.0]
    assert p['limPhysX'] == [-20.0, 20.0]
    assert 'name' not in p and 'shape' not in p


def test_server_set_replays_from_element():
    src, mirror, slit, screen = _setup()
    bl = BeamLine()
    for name, el in (('src', src), ('m1', mirror), ('slit', slit),
                     ('scr', screen)):
        bl.add(name, el)
    with record_flow(bl) as flow:
        _run(bl['src'], bl['m1'], bl['slit'], bl['scr'], 3)
    srv = BeamLineServer(bl, flow=flow, port=0, device='cpu').start()
    try:
        s = socket.create_connection((srv.host, srv.port), timeout=30)
        f = s.makefile('rw')

        def rpc(**req):
            f.write(json.dumps(req) + '\n')
            f.flush()
            return json.loads(f.readline())

        r0 = rpc(cmd='acquire')['result']
        new_pitch = float(mirror.pitch) + 5e-5
        r1 = rpc(cmd='set', pv='m1:pitch', value=new_pitch)['result']
        # the screen centroid moved by ~ 2 dpitch q
        assert r1['scr.expose']['cz'] > r0['scr.expose']['cz'] + 0.1
        # the source readback is unchanged (cached upstream)
        assert r1['src.shine'] == r0['src.shine']
        # and the partial replay equals a full re-trace
        _, _, _, _, img_t = _run(src, mirror.replace(pitch=new_pitch),
                                 slit, screen, 3)
        w = np.where(img_t.state.numpy() == 1,
                     (img_t.Jss + img_t.Jpp).numpy(), 0)
        cz_t = float((img_t.z.numpy() * w).sum() / w.sum())
        assert abs(r1['scr.expose']['cz'] - cz_t) < 1e-9
        rpc(cmd='shutdown')
        s.close()
    finally:
        srv.server.shutdown()
        srv.server.server_close()
