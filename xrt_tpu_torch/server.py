"""Live beamline control server: the EPICS-layer equivalent.

Port of the reference package's ``server.py``.  The reference xrt exposes
a running beamline as EPICS process variables through ``softioc``
(xrt/backends/raycing/epics/device.py:239, records.py:49-279):
every element's orientation/shape parameter becomes a PV; writing a PV
re-runs the propagation and publishes new histograms.  ``softioc``/EPICS
is not available here, so this module provides the same *capability* over a
dependency-free TCP line protocol (JSON per line):

    {"cmd": "list"}                          -> {"pvs": {...}}
    {"cmd": "get", "pv": "mirror:pitch"}     -> {"value": ...}
    {"cmd": "set", "pv": "mirror:pitch", "value": 4.1e-3}
    {"cmd": "acquire"}                        -> re-trace, {"result": {...}}
    {"cmd": "shutdown"}

Parameters address elements by ``element:field``; a ``set`` makes the
element's ``replace`` copy (a ``BeamLine`` takes it by ``update``) and,
like the EPICS AutoUpdate mode, re-traces when *autoUpdate* is on.  The
trace function is user supplied and returns a JSON-serializable dict
(e.g. histogram summaries), the analog of the EPICS image/readback
records.  The trace runs on the card: the server's threads make the
server's device current before the first launch of a request.
"""
from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _host(v):
    """A number, a tensor or a sequence of them as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (tuple, list)):
        if not all(isinstance(x, (int, float, torch.Tensor)) and
                   not isinstance(x, bool) for x in v):
            return np.asarray(None)
        return np.asarray([float(x) for x in v])
    return np.asarray(v)


def _params_of(element) -> Dict[str, float]:
    """The element's numeric parameters: numbers, and vectors of up to
    three (the port keeps a centre or a limit pair as a tuple where the
    reference package keeps an array)."""
    from .beamline import _fields
    out = {}
    for fname in _fields(element):
        v = getattr(element, fname)
        if v is None or isinstance(v, (str, bool)):
            continue
        arr = _host(v)
        if arr.ndim == 0 and np.issubdtype(arr.dtype, np.number):
            out[fname] = float(arr)
        elif arr.ndim == 1 and 0 < arr.size <= 3 and \
                np.issubdtype(arr.dtype, np.floating):
            out[fname] = [float(x) for x in arr]
    return out


def _value_like(cur, value):
    """*value* (a JSON number or list) in the form of the parameter *cur*
    it replaces: a tensor of its dtype and device, a tuple or a number."""
    if isinstance(cur, torch.Tensor):
        return torch.as_tensor(value, dtype=cur.dtype, device=cur.device)
    if isinstance(cur, (tuple, list)):
        return type(cur)(float(x) for x in value)
    if isinstance(cur, int) and not isinstance(cur, bool):
        return int(value)
    return float(value)


def _default_summary(results) -> Dict[str, dict]:
    """JSON summary of flow-replay outputs: per-beam good-ray flux and
    centroid (the analog of the EPICS readback/image records)."""
    out = {}
    for key, val in results.items():
        if key.startswith('~'):     # derived-beam helper steps
            continue
        beams = val if isinstance(val, tuple) else (val,)
        b = beams[0]
        if not hasattr(b, 'state'):
            continue
        state = _host(b.state)
        good = state == 1
        Jss = _host(b.Jss)
        Jpp = _host(b.Jpp)
        w = np.where(good, Jss + Jpp, 0.0)
        tot = float(w.sum())
        x = _host(b.x)
        z = _host(b.z)
        out[key] = {
            'flux': tot,
            'nGood': int(good.sum()),
            'cx': float((x * w).sum() / tot) if tot > 0 else 0.0,
            'cz': float((z * w).sum() / tot) if tot > 0 else 0.0,
        }
    return out


class BeamLineServer:
    """Serves the elements of a dict {name: element} (or a
    :class:`~xrt_tpu_torch.beamline.BeamLine`) for remote get/set/acquire.
    *device*: the card the traces run on (the current CUDA device when
    None and CUDA is there), made current in each handler thread."""

    def __init__(self, elements, trace_fn: Optional[Callable] = None,
                 host='127.0.0.1', port=0, autoUpdate=True, flow=None,
                 summarize_fn: Optional[Callable] = None, device=None):
        if hasattr(elements, '_elements'):    # a BeamLine
            self._bl = elements
            self.elements = elements._elements
        else:
            self._bl = None
            self.elements = dict(elements)
        self.trace_fn = trace_fn
        #: optional recorded Flow (:mod:`.flow`): a `set` on element k then
        #: replays only from k onward with cached upstream beams — the
        #: analog of the reference's restart-from-element propagation
        #: (_flow.py:31-40)
        self.flow = flow
        self.summarize_fn = summarize_fn or _default_summary
        self._flow_replacements: Dict[str, object] = {}
        self.autoUpdate = autoUpdate
        self.lastResult = None
        self._lock = threading.Lock()
        if device is None and torch.cuda.is_available():
            device = 'cuda'
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == 'cuda' and \
                self.device.index is None:
            self.device = torch.device('cuda', torch.cuda.current_device())
        srv_self = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                # a thread starts on CUDA device 0: make the server's
                # current before this request's first launch
                if srv_self.device is not None and \
                        srv_self.device.type == 'cuda':
                    torch.cuda.set_device(srv_self.device)
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    req = {}
                    try:
                        req = json.loads(line.decode())
                        text = json.dumps(srv_self._dispatch(req))
                    except Exception as e:  # report, keep serving
                        text = json.dumps(
                            {'error': f'{type(e).__name__}: {e}'})
                    self.wfile.write((text + '\n').encode())
                    self.wfile.flush()
                    if req.get('cmd') == 'shutdown':
                        threading.Thread(
                            target=srv_self.server.shutdown).start()
                        return

        class _TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.server = _TCP((host, port), Handler)
        self.host, self.port = self.server.server_address
        self._thread = None

    # ------------------------------------------------------------------
    def _dispatch(self, req):
        cmd = req.get('cmd')
        with self._lock:
            if cmd == 'list':
                return {'pvs': {name: _params_of(el)
                                for name, el in self.elements.items()}}
            if cmd == 'get':
                name, field = req['pv'].split(':')
                params = _params_of(self.elements[name])
                if field not in params:
                    return {'error': f'unknown pv {req["pv"]}'}
                return {'value': params[field]}
            if cmd == 'set':
                name, field = req['pv'].split(':')
                el = self.elements[name]
                new = el.replace(**{field: _value_like(getattr(el, field),
                                                       req['value'])})
                self.elements[name] = new
                if self._bl is not None:
                    self._bl.update(name, new)
                out = {'ok': True}
                if self.autoUpdate:
                    res = self._retrace(changed=name)
                    if res is not None:
                        self.lastResult = res
                        out['result'] = res
                return out
            if cmd == 'acquire':
                res = self._retrace()
                if res is None:
                    return {'error': 'no trace_fn or flow configured'}
                self.lastResult = res
                return {'result': res}
            if cmd == 'shutdown':
                return {'ok': True}
        return {'error': f'unknown cmd {cmd}'}

    # ------------------------------------------------------------------
    def _retrace(self, changed: Optional[str] = None):
        """Re-run the propagation after a parameter change.

        With a recorded *flow*, only the steps from the (earliest) changed
        element onward re-run — upstream beams come from the recording
        cache.  Falls back to the full *trace_fn* otherwise."""
        if self.flow is not None:
            if changed is not None:
                self._flow_replacements[changed] = self.elements[changed]
            results = self.flow.replay(replace=self._flow_replacements)
            return self.summarize_fn(results)
        if self.trace_fn is not None:
            return self.trace_fn(self.elements)
        return None

    # ------------------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class BeamLineClient:
    """Tiny blocking client for :class:`BeamLineServer`."""

    def __init__(self, host, port):
        self.sock = socket.create_connection((host, port))
        self.f = self.sock.makefile('rwb')

    def request(self, **req):
        self.f.write((json.dumps(req) + '\n').encode())
        self.f.flush()
        return json.loads(self.f.readline().decode())

    def list(self):
        return self.request(cmd='list')['pvs']

    def get(self, pv):
        return self.request(cmd='get', pv=pv)['value']

    def set(self, pv, value):
        return self.request(cmd='set', pv=pv, value=value)

    def acquire(self):
        return self.request(cmd='acquire')['result']

    def close(self):
        try:
            self.f.close()
            self.sock.close()
        except OSError:
            pass
