"""Interactive beamline control in the browser: the capability analog of
the reference's GUI pair, xrtQook's parameter-editing element tree
(xrt/gui/xrtQook/widgets/qookbase.py:2-31) and xrtGlow's live 3D view
with refreshing footprints (xrt/gui/xrtGlow/widgets/main.py), with no
GUI toolkit: a stdlib HTTP server and one self-contained HTML page.
Port of the reference package's ``webui.py``.

    python -m xrt_tpu_torch serve beamline.json --ui

opens an editable element tree (every numeric create() parameter of
every element), a rotatable 3D beamline view, and a live detector
histogram; editing a parameter re-runs the dirty part of the recorded
flow (flow.replay) and refreshes both: the browser twin of the EPICS
AutoUpdate mode served by server.py.

The page also assembles beamlines (the xrtQook capability,
qookbase.py:2-31): add/remove/reorder elements from the class registry
with materials picked from the catalogs, auto-aligned on the optical axis
(BeamLine.place), save/load the JSON layout, download the generated
python script (codegen), and sweep a virtual probe screen along the beam
with a live histogram (the xrtGlow draggable-screen analog,
gui/xrtGlow/widgets/main.py).

The traces run on the UI's device (the card unless ``device='cpu'``).
The readouts are reduced there: the good-ray mask, the weights
Jss + Jpp, flux, centroids, the 98th percentiles (a sort) and the
histograms (``histogram.hist2d``: the kernel ``hist2d_kernel`` on CUDA
tensors); only the tables and the scalars are copied to the host.  Every histogram
closes its last bin as ``np.histogram`` does: a ray on the upper limit
counts in the last bin.

Endpoints (JSON):
    GET  /api/elements          {name: {param: value}}
    GET  /api/beams             [beam keys in flow order]
    GET  /api/hist?beam=K       2D histogram + flux/centroid/FWHM readouts
    GET  /api/scene             glow wireframes + ray segments
    GET  /api/registry          addable classes + create() defaults +
                                material catalogs
    GET  /api/layout            the beamline's JSON layout (download)
    GET  /api/codegen           generated runnable python script
    GET  /api/probe?beam&d      histogram on a virtual screen *d* mm
                                downstream of the selected beam
    GET  /api/inspect?element=N full parameter set + derived material
                                optics (Bragg angle, Darwin width,
                                delta/beta) + footprint ray categories,
                                flux and per-axis centroid/FWHM + flux
                                transmission vs the upstream element
                                (the xrtGlow instance-inspector analog)
    POST /api/set               {"element","param","value"} -> re-trace;
                                value may be a catalog material spec
                                {"catalog","name",...} for param
                                "material"/"material2"
    POST /api/add               {"name","class","params",["material"],
                                ["distance"|"center"],["pitch"]}
    POST /api/remove            {"name"}
    POST /api/reorder           {"order": [names]}
    POST /api/load              {"json": layout-text} -> rebuild
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from . import config
from .glow import build_scene
from .server import _params_of

#: the errors a material raises where it has no such optics number (a
#: device error is not among them and propagates)
_NO_NUMBER = (AttributeError, NotImplementedError, TypeError, ValueError,
              ZeroDivisionError)


def _beam_of(val):
    b = val[0] if isinstance(val, tuple) else val
    return b if hasattr(b, 'state') else None


def _item(v):
    """A number, a 0-dim tensor or array as a Python number."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().item()
    return np.asarray(v).item()


def _closed(v, limits, bins):
    """*v* with the rays on the upper limit moved into the last bin, so
    that the histograms' half-open ``[lo, hi)`` bins close the last one as
    ``np.histogram`` does: every ray up to *hi* is clamped to the middle
    of the last bin (a ray inside the last bin stays in it), a ray above
    *hi* stays outside."""
    lo, hi = limits
    mid = lo + (hi - lo) * (bins - 0.5) / bins
    return torch.where(v <= hi, torch.clamp(v, max=mid), v)


def _percentile(v, q):
    """``np.percentile(v, q)`` of a 1D tensor with numpy's default
    ('linear') interpolation: the two order statistics are taken from a
    sort on the device (no size limit; ``kthvalue`` scans a 1D tensor in
    one block) and interpolated on the host as numpy does."""
    n = v.shape[0]
    virtual = (n - 1) * (q / 100)
    prev = int(np.floor(virtual))
    nxt = min(prev + 1, n - 1)
    a, b = torch.sort(v).values[[prev, nxt]].tolist()
    g = virtual - prev
    diff = b - a
    return b - diff * (1 - g) if g >= 0.5 else a + diff * g


def _fwhm(x, w, bins=128):
    """The full width at half maximum of the weighted 1D histogram of the
    rays *x* (tensors) over their own range, as ``np.histogram(x, 128,
    weights=w)`` bins it (the last bin closed, the edges ``np.linspace``
    of the data's dtype); the 128 sums come back to the host."""
    from .histogram import hist1d
    if float(w.sum()) <= 0:
        return 0.0
    mm = torch.stack([x.min(), x.max()]).detach().cpu().numpy()
    lo, hi = mm[0], mm[1]
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(f'autodetected range of [{lo}, {hi}] is not '
                         'finite')
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = np.linspace(lo, hi, bins + 1, dtype=mm.dtype)
    lim = (float(lo), float(hi))
    h = hist1d(_closed(x, lim, bins), w, bins, lim).detach().cpu().numpy()
    if h.max() <= 0:
        return 0.0
    above = np.nonzero(h > h.max() / 2)[0]
    return float((above[-1] - above[0] + 1) * (edges[1] - edges[0]))


def _full_params(el):
    """All fields of *el*, JSON-ready: numbers and small vectors as
    values, strings/bools verbatim, nested objects (e.g. a material) by
    class name and big arrays summarized by shape."""
    from .beamline import _fields
    out = {}
    for fname in _fields(el):
        v = getattr(el, fname)
        if v is None:
            continue
        if isinstance(v, (str, bool)):
            out[fname] = v
        elif isinstance(v, tuple):
            try:
                out[fname] = [float(x) for x in v]
            except (TypeError, ValueError):
                out[fname] = [str(x) for x in v]
        elif isinstance(v, (int, float, list, np.ndarray, np.number,
                            torch.Tensor)):
            arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
            try:
                if arr.ndim == 0 and np.issubdtype(arr.dtype, np.number):
                    # 0-d complex (or other non-float-convertible
                    # numerics) fall through to the summary form below
                    out[fname] = float(arr)
                elif arr.ndim == 1 and arr.size <= 3 and \
                        np.issubdtype(arr.dtype, np.floating):
                    out[fname] = [float(x) for x in arr]
                else:
                    out[fname] = f'array{tuple(arr.shape)}'
            except (TypeError, ValueError):
                out[fname] = f'array{tuple(arr.shape)}'
        else:
            out[fname] = type(v).__name__
    return out


def _material_info(mat, E):
    """Derived optics numbers for *mat* at energy *E*: the inspector's
    material card (Bragg angle/Darwin width for crystals, delta/beta of
    the refractive index for mirrors/lenses)."""
    info = {'class': type(mat).__name__,
            'kind': getattr(mat, 'kind', None),
            'name': getattr(mat, 'name', None),
            'at_E_eV': float(E)}
    rho = getattr(mat, 'rho', None)
    if rho is not None:
        try:
            info['rho_g_cm3'] = float(_item(rho))
        except _NO_NUMBER:
            pass
    if hasattr(mat, 'get_Bragg_angle'):
        try:
            tb = float(_item(mat.get_Bragg_angle(E)))
            info['braggAngle_deg'] = float(np.degrees(tb))
            if hasattr(mat, 'get_Darwin_width'):
                info['darwinWidth_urad'] = 1e6 * float(
                    _item(mat.get_Darwin_width(E)))
            d = getattr(mat, 'd', None)
            if d is not None:
                info['dSpacing_A'] = float(_item(d))
        except _NO_NUMBER:
            pass
    elif hasattr(mat, 'get_refractive_index'):
        try:
            n = complex(_item(mat.get_refractive_index(E)))
            info['delta'] = 1.0 - n.real
            info['beta'] = abs(n.imag)
        except _NO_NUMBER:
            pass
    return info


def _weights(b):
    """(good mask, float64 weights Jss + Jpp of the good rays and zero
    elsewhere) of a beam, on its device."""
    good = b.state == 1
    w = torch.where(good, (b.Jss + b.Jpp).to(torch.float64), 0.0)
    return good, w


def _beam_stats(b):
    """Ray-category counts + flux + per-axis centroid/FWHM of a beam:
    the reference's plot readouts (nRaysGood/Out/Over/Dead, flux, FWHM)
    computed on demand for the inspector, on the beam's device."""
    st = b.state
    good, w = _weights(b)
    counts = torch.stack([good.sum(), (st == 2).sum(), (st == 3).sum(),
                          (st < 0).sum()]).cpu().tolist()
    out = {'nGood': counts[0], 'nOut': counts[1], 'nOver': counts[2],
           'nDead': counts[3], 'flux': float(w.sum())}
    if out['nGood'] > 1:
        idx = good.nonzero().squeeze(1)
        wg = w[idx]
        tot = float(wg.sum())
        if tot > 0:
            for ax in 'xyz':
                v = getattr(b, ax)[idx]
                out[f'c{ax}'] = float((v.to(torch.float64) * wg).sum() /
                                      tot)
                out[f'fwhm_{ax}'] = _fwhm(v, wg.to(v.dtype))
    return out


# addable element classes for the assembly registry: (module, class) —
# the full placeable set (MeshOE and SourceFromField are omitted: they
# need an STL / B-field table payload the add-dialog cannot carry)
_REGISTRY = (
    ('sources', 'GeometricSource'), ('sources', 'GaussianBeam'),
    ('sources', 'LaguerreGaussianBeam'),
    ('sources', 'HermiteGaussianBeam'),
    ('sources', 'MeshSource'), ('sources', 'CollimatedMeshSource'),
    ('sources', 'Undulator'), ('sources', 'BendingMagnet'),
    ('sources', 'Wiggler'),
    ('oes', 'FlatMirror'), ('oes', 'BentFlatMirror'),
    ('oes', 'SphericalMirror'), ('oes', 'CylindricalMirror'),
    ('oes', 'ToroidMirror'), ('oes', 'DualVFM'),
    ('oes', 'ConicalMirror'),
    ('oes', 'EllipticalMirrorParam'), ('oes', 'ParabolicalMirrorParam'),
    ('oes', 'HyperbolicMirrorParam'),
    ('oes', 'EllipsoidCapillaryMirror'),
    ('oes', 'ParaboloidCapillaryMirror'),
    ('oes', 'HyperboloidCapillaryMirror'),
    ('oes.dcm', 'DCM'), ('oes.dcm', 'DCMwithSagittalFocusing'),
    ('oes', 'Grating'), ('oes', 'BlazedGrating'),
    ('oes', 'LaminarGrating'), ('oes', 'VLSLaminarGrating'),
    ('oes.gratings', 'NormalFZP'), ('oes.gratings', 'GeneralFZPin0YZ'),
    ('oes.refractive', 'Plate'), ('oes.refractive', 'ParaboloidFlatLens'),
    ('oes.refractive', 'ParabolicCylinderFlatLens'),
    ('oes.refractive', 'DoubleParaboloidLens'),
    ('oes.refractive', 'DoubleParabolicCylinderLens'),
    ('oes.bragg', 'JohannCylinder'), ('oes.bragg', 'JohanssonCylinder'),
    ('oes.bragg', 'JohannToroid'), ('oes.bragg', 'JohanssonToroid'),
    ('oes.bragg', 'GeneralBraggToroid'), ('oes.bragg', 'DicedOE'),
    ('oes.bragg', 'DicedJohannToroid'),
    ('oes.bragg', 'DicedJohanssonToroid'),
    ('oes.laue', 'LauePlate'), ('oes.laue', 'BentLaueCylinder'),
    ('oes.laue', 'GroundBentLaueCylinder'), ('oes.laue', 'BentLaue2D'),
    ('oes.laue', 'BentLaueSphere'),
    ('apertures', 'RectangularAperture'), ('apertures', 'RoundAperture'),
    ('apertures', 'DoubleSlit'), ('apertures', 'PolygonalAperture'),
    ('apertures', 'GridAperture'), ('apertures', 'SiemensStar'),
    # (SetOfRectangularAperturesOnZActuator is omitted like MeshOE /
    # SourceFromField: it is a host-side aperture *selector*, not a
    # traceable element — use select_aperture() and add the result)
    ('screens', 'Screen'), ('screens', 'HemisphericScreen'),
)

#: create() arguments that say where an element runs, not what it is:
#: the UI passes its own, the registry does not list them
_RUN_ARGS = ('dtype', 'device')


def _registry_class(clsName):
    import importlib
    for mod, cls in _REGISTRY:
        if cls == clsName:
            m = importlib.import_module('.' + mod, __package__)
            return getattr(m, cls)
    raise KeyError(f'unknown element class {clsName!r}; '
                   f'see /api/registry')


def _create_defaults(cls):
    """JSON-serializable create() parameter defaults across the MRO,
    less the dtype and device arguments (the constructor's where a
    create() only passes its keyword arguments on).

    Factory *functions* (LaguerreGaussianBeam / HermiteGaussianBeam wrap
    GaussianBeam) expose their own signature merged over
    GaussianBeam.create's defaults."""
    import inspect
    out = {}

    def take(fn, skip):
        for p in inspect.signature(fn).parameters.values():
            if p.name in skip or p.name in _RUN_ARGS or \
                    p.kind not in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
                continue
            d = p.default
            if d is inspect.Parameter.empty:
                out.setdefault(p.name, None)
            elif isinstance(d, (int, float, str, bool, type(None))):
                out[p.name] = d
            elif isinstance(d, (tuple, list)):
                out[p.name] = list(d)
    if not isinstance(cls, type):            # a factory function
        from .sources import GaussianBeam
        out = _create_defaults(GaussianBeam)
        take(cls, ('kwargs',))
        return out
    for c in reversed(getattr(cls, '__mro__', (cls,))):
        fn = c.__dict__.get('create')
        if fn is None:
            continue
        fn = getattr(fn, '__func__', fn)
        if set(inspect.signature(fn).parameters) == {'cls', 'kwargs'}:
            # a create() that passes its arguments on to the constructor
            fn = c.__init__
        take(fn, ('self', 'cls', 'kwargs'))
    return out


def _material_from_spec(spec, dtype, device):
    """Build a material from a catalog spec {"catalog","name",...} in
    *dtype* on *device*: the browser picks from the 38/92/76-entry
    catalogs."""
    from .materials import catalogs
    cat = spec.get('catalog', 'elemental')
    name = spec['name']
    kw = {k: v for k, v in spec.items() if k not in ('catalog', 'name')}
    kw.update(dtype=dtype, device=device)
    if cat == 'crystals':
        if 'hkl' in kw:
            kw['hkl'] = tuple(kw['hkl'])
        return catalogs.crystal(name, **kw)
    if cat == 'compounds':
        return catalogs.compound(name, **kw)
    return catalogs.elemental(name, **kw)


def _value_of(cur, value):
    """A JSON *value* in the form of the parameter *cur* it replaces (a
    tensor of its dtype on its device, a tuple or a number); a list for an
    unset parameter becomes a tuple."""
    from .server import _value_like
    if cur is None:
        return tuple(value) if isinstance(value, list) else value
    return _value_like(cur, value)


class WebUI:
    """HTTP wrapper around a beamline (+ optionally a recorded flow).

    With *flow=None* the results come from ``bl.propagate_flow`` on the
    beamline's default flow: the mode used for in-browser assembly
    (starting from an empty BeamLine is fine: trace results appear once
    a source is added).  *device* (the card by default) and *dtype*
    (float32 by default) are those of the traces and of the sources and
    materials the page adds or loads."""

    def __init__(self, bl, flow=None, host='127.0.0.1', port=0, bins=80,
                 maxRays=150, device=None, dtype=None):
        self.bl = bl
        self.flow = flow
        self.device = config.resolve_device(device)
        if self.device.type == 'cuda' and self.device.index is None:
            self.device = torch.device('cuda', torch.cuda.current_device())
        self.dtype = config.resolve_dtype(dtype)
        self.elements = dict(bl._elements)
        self.bins = bins
        self.maxRays = maxRays
        self._repl: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._results = self._trace()
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # quiet
                pass

            def _send(self, payload, ctype='application/json', code=200):
                body = payload if isinstance(payload, bytes) else \
                    json.dumps(payload).encode()
                self.send_response(code)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _on_device(self):
                # a thread starts on CUDA device 0: make the UI's current
                # before this request's first launch
                if ui.device.type == 'cuda':
                    torch.cuda.set_device(ui.device)

            def do_GET(self):
                try:
                    self._on_device()
                    u = urlparse(self.path)
                    q = {k: v[0] for k, v in parse_qs(u.query).items()}
                    if u.path == '/':
                        self._send(ui.page().encode(),
                                   'text/html; charset=utf-8')
                    elif u.path == '/api/elements':
                        self._send(ui.api_elements())
                    elif u.path == '/api/beams':
                        self._send(ui.api_beams())
                    elif u.path == '/api/hist':
                        self._send(ui.api_hist(q.get('beam')))
                    elif u.path == '/api/scene':
                        self._send(ui.api_scene())
                    elif u.path == '/api/registry':
                        self._send(ui.api_registry())
                    elif u.path == '/api/layout':
                        self._send(ui.api_layout().encode(),
                                   'application/json')
                    elif u.path == '/api/codegen':
                        self._send(ui.api_codegen().encode(),
                                   'text/x-python; charset=utf-8')
                    elif u.path == '/api/probe':
                        self._send(ui.api_probe(
                            q.get('beam'), float(q.get('d', 0.0))))
                    elif u.path == '/api/inspect':
                        self._send(ui.api_inspect(q.get('element')))
                    else:
                        self._send({'error': 'not found'}, code=404)
                except Exception as e:
                    self._send({'error': f'{type(e).__name__}: {e}'},
                               code=500)

            def do_POST(self):
                try:
                    self._on_device()
                    n = int(self.headers.get('Content-Length', 0))
                    req = json.loads(self.rfile.read(n) or b'{}')
                    path = urlparse(self.path).path
                    if path == '/api/set':
                        self._send(ui.api_set(req['element'],
                                              req['param'],
                                              req['value']))
                    elif path == '/api/add':
                        self._send(ui.api_add(req))
                    elif path == '/api/remove':
                        self._send(ui.api_remove(req['name']))
                    elif path == '/api/reorder':
                        self._send(ui.api_reorder(req['order']))
                    elif path == '/api/load':
                        self._send(ui.api_load(req['json']))
                    else:
                        self._send({'error': 'not found'}, code=404)
                except Exception as e:
                    self._send({'error': f'{type(e).__name__}: {e}'},
                               code=500)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.server.server_address
        self._thread: Optional[threading.Thread] = None

    # -- tracing ---------------------------------------------------------
    def _trace(self):
        """Current results: the recorded flow's replay, or (assembly
        mode) a propagate_flow pass over the beamline's default flow with
        a generator seeded with 0 on the UI's device."""
        if self.flow is not None:
            return self.flow.replay(replace=self._repl)
        if not self.bl.flow:
            return {}
        return self.bl.propagate_flow(
            torch.Generator(self.device).manual_seed(0))

    # -- api ------------------------------------------------------------
    def api_elements(self):
        with self._lock:
            out = {name: _params_of(el)
                   for name, el in self.elements.items()}
            # DAG wiring: expose each step's recorded '_input' so the
            # tree can show which upstream beam feeds it
            for step in self.bl.flow:
                kw = step[3] if len(step) > 3 else None
                if isinstance(kw, dict) and kw.get('_input') and \
                        step[0] in out:
                    inp = kw['_input']
                    out[step[0]]['_input'] = inp if isinstance(inp, str) \
                        else getattr(inp, 'name', str(inp))
            return out

    def _beams(self):
        out = {}
        for key, val in self._results.items():
            if key.startswith('~'):
                continue
            b = _beam_of(val)
            if b is not None:
                out[key] = b
        return out

    def api_beams(self):
        with self._lock:
            return list(self._beams())

    def api_set(self, name, param, value):
        with self._lock:
            el = self.elements[name]
            if param in ('material', 'material2') and \
                    isinstance(value, dict):
                # swap the element's material from a catalog spec
                # {"catalog","name",...}: xrtQook's material combo box
                val = _material_from_spec(value, self.dtype, self.device)
            else:
                val = _value_of(getattr(el, param), value)
            new = el.replace(**{param: val})
            old_repl = self._repl.get(name)
            had_repl = name in self._repl
            self.elements[name] = new
            self.bl.update(name, new)
            self._repl[name] = new
            try:
                self._results = self._trace()
            except Exception:
                # roll back so a failing value cannot poison every
                # subsequent replay (the old results stay displayed)
                self.elements[name] = el
                self.bl.update(name, el)
                if had_repl:
                    self._repl[name] = old_repl
                else:
                    del self._repl[name]
                raise
            return {'ok': True}

    # -- assembly --------------------------------------------------------
    def api_registry(self):
        from .materials.catalogs import (list_crystals, list_elemental,
                                         list_compounds)
        classes = {}
        for mod, cls in _REGISTRY:
            classes[cls] = _create_defaults(_registry_class(cls))
        return {'classes': classes,
                'materials': {'crystals': list_crystals(),
                              'elemental': list_elemental(),
                              'compounds': list_compounds()}}

    def _to_assembly_mode(self):
        """Structural edits cannot be expressed as a recorded-flow
        replay: drop to assembly mode (full re-trace of the beamline's
        default flow) on the first add/remove/reorder."""
        if self.flow is not None:
            self.flow = None
            self._repl = {}

    def api_add(self, req):
        """Create + register an element; with "distance" it is placed on
        the current optical axis by BeamLine.place (auto center, auto
        Bragg pitch from the material at alignE: the assembly analog of
        the reference's auto-alignment, beamline.py:368-508).  A class
        whose create() takes a dtype and a device gets the UI's."""
        from .beamline import _create_signature_names
        with self._lock:
            self._to_assembly_mode()
            name = req['name']
            if name in self.bl._elements:
                raise ValueError(f'element {name!r} already exists')
            cls = _registry_class(req['class'])
            params = dict(req.get('params') or {})
            for k, v in list(params.items()):
                if isinstance(v, list):
                    params[k] = tuple(v)
            accepted = _create_signature_names(cls)
            for k, v in (('dtype', self.dtype), ('device', self.device)):
                if k in accepted:
                    params[k] = v
            if req.get('material'):
                params['material'] = _material_from_spec(
                    req['material'], self.dtype, self.device)
            # DAG wiring: "input" names the upstream element feeding
            # this step (the reference Qook's beam wiring,
            # qookbase.py:2-31); distance placement then branches off
            # that element's outgoing axis
            inputName = req.get('input') or None
            if inputName is not None and inputName not in self.elements:
                raise KeyError(f'unknown input element {inputName!r}')
            saved = self._structural_snapshot()
            try:
                if req.get('distance') is not None:
                    kw = dict(params)
                    kw.pop('pitch', None)
                    if req.get('autoBragg'):
                        pitch = 'auto'
                    elif req.get('pitch') is not None:
                        pitch = float(req['pitch'])
                    else:
                        pitch = params.get('pitch')
                    self.bl.place(name, cls,
                                  distance=float(req['distance']),
                                  pitch=pitch,
                                  bragg_material=kw.get('material'),
                                  after=inputName,
                                  **kw)
                else:
                    el = cls.create(**params) if hasattr(cls, 'create') \
                        else cls(**params)
                    fkw = {'_input': inputName} if inputName else {}
                    self.bl.add(name, el, **fkw)
                self._results = self._trace()
            except Exception:
                # undo the add, the placement axis included, or every
                # later distance-placed element lands relative to the
                # failed one
                self._restore_structural(saved)
                raise
            self.elements = dict(self.bl._elements)
            return {'ok': True, 'elements': list(self.elements)}

    def api_remove(self, name):
        with self._lock:
            self._to_assembly_mode()
            saved = self._structural_snapshot()
            self.bl.remove(name)
            self._repl.pop(name, None)
            try:
                self._results = self._trace()
            except Exception:
                self._restore_structural(saved)
                raise
            self.elements = dict(self.bl._elements)
            return {'ok': True, 'elements': list(self.elements)}

    def api_reorder(self, order):
        with self._lock:
            self._to_assembly_mode()
            saved = self._structural_snapshot()
            self.bl.reorder(list(order))
            try:
                self._results = self._trace()
            except Exception:
                self._restore_structural(saved)
                raise
            return {'ok': True, 'order': [s[0] for s in self.bl.flow]}

    def _structural_snapshot(self):
        bl = self.bl
        return (dict(bl._elements), list(bl.flow), list(bl.sources),
                list(bl.oes), list(bl.slits), list(bl.screens),
                bl.axis_point, bl.axis_dir, dict(bl._axis_before),
                dict(bl._axis_after))

    def _restore_structural(self, saved):
        """Roll back a structural edit whose re-trace failed, so stale
        results are never served for a mutated beamline."""
        bl = self.bl
        (bl._elements, bl.flow, bl.sources, bl.oes, bl.slits,
         bl.screens) = (dict(saved[0]), list(saved[1]), list(saved[2]),
                        list(saved[3]), list(saved[4]), list(saved[5]))
        bl._axis_point = np.array(saved[6])
        bl._axis_dir = np.array(saved[7])
        bl._axis_before = dict(saved[8])
        bl._axis_after = dict(saved[9])
        self.elements = dict(bl._elements)

    def api_layout(self):
        with self._lock:
            return self.bl.export_to_json()

    def api_load(self, text):
        """Rebuild the whole beamline from a JSON layout (switches to
        assembly mode: a recorded flow cannot survive the swap)."""
        from .beamline import BeamLine
        with self._lock:
            bl = BeamLine.load_from_json(text, dtype=self.dtype,
                                         device=self.device)
            self.bl = bl
            self.flow = None
            self._repl = {}
            self.elements = dict(bl._elements)
            self._results = self._trace()
            return {'ok': True, 'elements': list(self.elements)}

    def api_codegen(self):
        from .codegen import generate_script
        with self._lock:
            return generate_script(json.loads(self.bl.export_to_json()))

    def api_probe(self, beam_key, d):
        """Histogram on a virtual screen *d* mm downstream of the
        selected beam: the xrtGlow draggable-screen analog: drag the
        slider, watch the focus form (gui/xrtGlow/widgets/main.py).  The
        mean position and direction of the good rays are taken on the
        device, the screen's frame is built on the host in float64, and
        the screen exposes the beam on the device."""
        from .screens import Screen
        with self._lock:
            beams = self._beams()
            if not beams:
                return {'error': 'no beams'}
            if beam_key is None or beam_key not in beams:
                beam_key = list(beams)[-1]
            b = beams[beam_key]
            good = b.state == 1
            ngood = int(good.sum())
            if ngood < 2:
                return {'error': 'no good rays'}
            sums = torch.stack([
                torch.where(good, getattr(b, ax), 0.0).sum(
                    dtype=torch.float64) for ax in 'xyzabc'])
            means = sums.cpu().numpy() / ngood
            pos, dirv = means[:3], means[3:]
            dirv = dirv / np.linalg.norm(dirv)
            # orthonormal screen frame: x horizontal-ish, z completes
            up = np.array([0.0, 0.0, 1.0])
            if abs(dirv @ up) > 0.99:
                up = np.array([0.0, 1.0, 0.0])
            ex = np.cross(up, dirv)
            ex /= np.linalg.norm(ex)
            ez = np.cross(dirv, ex)
            scr = Screen.create(center=tuple(pos + dirv * d),
                                x=tuple(ex), z=tuple(ez))
            img = scr.expose(b)
            out = self._hist_payload(img)
            out['beam'] = beam_key
            out['d'] = d
            return out

    def _element_beams(self, name):
        """(global_beam, [local footprints]) of *name* in the current
        results, resolving both result-key styles: propagate_flow's
        ``name``/``name_local``/``name_local1|2`` and flow-replay's
        ``name.method`` tuples."""
        glob, locs = None, []
        for key, val in self._results.items():
            if key.startswith('~'):
                continue
            base = key.split('.', 1)[0]
            suffix = None
            if base != name:
                # strip a _local* suffix only when the full key is NOT
                # itself a registered element (an element literally
                # named 'm1_local' keeps its own beams)
                for suf in ('_local1', '_local2', '_local'):
                    if base.endswith(suf) and base not in self.elements:
                        base, suffix = base[:-len(suf)], suf
                        break
            if base != name:
                continue
            if isinstance(val, tuple):
                bs = [v for v in val if hasattr(v, 'state')]
                if bs:
                    glob = bs[0]
                    locs.extend(bs[1:])
            elif hasattr(val, 'state'):
                if suffix:
                    locs.append(val)
                else:
                    glob = val
        return glob, locs

    def api_inspect(self, name):
        """Deep per-element readout: the capability analog of xrtGlow's
        instance inspector (gui/xrtGlow/widgets/inspector.py): the full
        parameter set (incl. non-numeric fields), the material's derived
        optics numbers at the alignment energy (Bragg angle, Darwin
        width, d-spacing for crystals; delta/beta for mirrors/lenses),
        the traced footprint statistics (ray categories, flux,
        centroid/FWHM per axis), and the flux transmission vs the
        upstream element."""
        with self._lock:
            if name not in self.elements:
                raise KeyError(f'unknown element {name!r}')
            el = self.elements[name]
            alignE = getattr(el, 'alignE', None)
            if alignE is None:
                alignE = getattr(self.bl, 'alignE', None)
            if alignE is None:
                alignE = 9000.0
            alignE = config.host_float(alignE)
            out = {'name': name, 'class': type(el).__name__,
                   'module': type(el).__module__,
                   'params': _full_params(el)}
            from .materials import EmptyMaterial, Material, Multilayer
            for fld in ('material', 'material2'):
                mat = getattr(el, fld, None)
                if isinstance(mat, (Material, EmptyMaterial, Multilayer)):
                    out[fld] = _material_info(mat, alignE)
            glob, locs = self._element_beams(name)
            if locs:
                out['footprint'] = _beam_stats(locs[0])
                if len(locs) > 1:
                    out['footprint2'] = _beam_stats(locs[1])
            if glob is not None:
                out['beamOut'] = _beam_stats(glob)
                order = [s[0] for s in self.bl.flow]
                if name in order and order.index(name) > 0:
                    # the actual feeding element: the step's recorded
                    # '_input' kwarg when the flow is branched (DAG),
                    # else the positional predecessor
                    step = self.bl.flow[order.index(name)]
                    upname = None
                    kw = step[3] if len(step) > 3 else None
                    if isinstance(kw, dict) and kw.get('_input') \
                            is not None:
                        inp = kw['_input']
                        upname = inp if isinstance(inp, str) else \
                            getattr(inp, 'name', None)
                    if upname is None or upname not in self.elements:
                        upname = order[order.index(name) - 1]
                    up, _ = self._element_beams(upname)
                    if up is not None:
                        fin = _beam_stats(up)['flux']
                        out['fluxIn'] = fin
                        if fin > 0:
                            out['transmission'] = \
                                out['beamOut']['flux'] / fin
            return out

    def _hist_table(self, b):
        """The 2D readout of a beam, reduced on its device: (table of
        (bins, bins) float64 numpy sums with rows = z, x range, z range,
        flux, good rays, cx, cz, fwhm_x, fwhm_z).  The range is the
        weighted centroid +- 1.3 times the 98th percentile of the good
        rays' distance from it, per axis."""
        from .histogram import hist2d
        good, w = _weights(b)
        ngood = int(good.sum())
        tot = float(w.sum())
        bins = self.bins
        if tot > 0 and ngood > 1:
            idx = good.nonzero().squeeze(1)
            xg, zg, wg = b.x[idx], b.z[idx], w[idx]
            cx = float((xg.to(torch.float64) * wg).sum() / tot)
            cz = float((zg.to(torch.float64) * wg).sum() / tot)
            sx = max(_percentile((xg.to(torch.float64) - cx).abs(), 98) *
                     1.3, 1e-9)
            sz = max(_percentile((zg.to(torch.float64) - cz).abs(), 98) *
                     1.3, 1e-9)
            xr, zr = (cx - sx, cx + sx), (cz - sz, cz + sz)
            wd = wg.to(xg.dtype)
            h = hist2d(_closed(xg, xr, bins), _closed(zg, zr, bins), wd,
                       bins, bins, xr, zr)
            h = h.detach().cpu().numpy().astype(np.float64)
            fx = _fwhm(xg, wd)
            fz = _fwhm(zg, wd)
        else:
            h = np.zeros((bins, bins))
            xr = zr = (-1.0, 1.0)
            cx = cz = fx = fz = 0.0
        return h, xr, zr, tot, ngood, cx, cz, fx, fz

    def _hist_payload(self, b):
        h, xr, zr, tot, ngood, cx, cz, fx, fz = self._hist_table(b)
        hmax = h.max() or 1.0
        return {
            'h': np.round(h / hmax, 4).tolist(),   # rows = z
            'extent': [float(xr[0]), float(xr[1]),
                       float(zr[0]), float(zr[1])],
            'flux': tot, 'nGood': ngood,
            'cx': cx, 'cz': cz, 'fwhm_x': fx, 'fwhm_z': fz,
        }

    def api_hist(self, beam_key=None):
        with self._lock:
            beams = self._beams()
            if not beams:
                return {'error': 'no beams'}
            if beam_key is None or beam_key not in beams:
                beam_key = list(beams)[-1]
            out = self._hist_payload(beams[beam_key])
            out['beam'] = beam_key
            return out

    def api_scene(self):
        with self._lock:
            return build_scene(elements=self.elements,
                               beams=self._beams(),
                               maxRays=self.maxRays)

    # -- lifecycle -------------------------------------------------------
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

    # -- the page --------------------------------------------------------
    def page(self):
        return _PAGE.replace('__TITLE__',
                             getattr(self.bl, 'name', '') or 'beamline')


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__ — xrt_tpu_torch</title>
<style>
 body { margin:0; display:flex; height:100vh; background:#101018;
        color:#ddd; font:13px sans-serif; }
 #tree { width:270px; overflow-y:auto; padding:8px;
         background:#181824; border-right:1px solid #333; }
 #tree h3 { margin:4px 0 8px; font-size:14px; color:#8cf; }
 details { margin-bottom:6px; }
 summary { cursor:pointer; color:#fc6; }
 .prow { display:flex; justify-content:space-between; margin:2px 0 2px
         12px; }
 .prow label { color:#aaa; margin-right:6px; }
 .prow input { width:110px; background:#0c0c14; color:#cfc;
               border:1px solid #444; font:12px monospace; }
 #main { flex:1; display:flex; flex-direction:column; }
 #view3d { flex:1.1; position:relative; }
 #view3d canvas { position:absolute; inset:0; }
 #histrow { flex:1; display:flex; border-top:1px solid #333; }
 #histwrap { position:relative; }
 #hist { image-rendering:pixelated; background:#000; }
 #readouts { padding:10px; min-width:210px; }
 #readouts div { margin:4px 0; }
 #readouts .v { color:#8f8; font-family:monospace; }
 select { background:#0c0c14; color:#ddd; border:1px solid #444; }
 #status { color:#f88; }
 #toolbar button, #addform button, .loadlab { background:#223;
   color:#8cf; border:1px solid #446; cursor:pointer; font:12px
   sans-serif; margin:1px; padding:2px 6px; display:inline-block; }
 #addform { background:#14141e; border:1px solid #334; padding:6px;
   margin:4px 0; }
 #addform input, #addform textarea, #addform select {
   background:#0c0c14; color:#cfc; border:1px solid #444;
   font:12px monospace; }
 .del { float:right; background:none; border:none; color:#f66;
   cursor:pointer; }
</style></head><body>
<div id="tree"><h3>__TITLE__</h3>
 <div id="toolbar">
  <button id="addbtn">+ add element</button>
  <button id="savebtn">save layout</button>
  <button id="codebtn">python script</button>
  <label class="loadlab">load<input type="file" id="loadfile"
   style="display:none"></label>
 </div>
 <div id="addform" style="display:none">
  <div>class <select id="addclass"></select></div>
  <div>name <input id="addname" size="10"></div>
  <div>distance <input id="adddist" size="8"
       placeholder="auto-align mm"></div>
  <div>input <select id="addinput"><option value="">(previous)</option>
   </select></div>
  <div>pitch <input id="addpitch" size="8" placeholder="rad|auto"></div>
  <div>material <select id="addmat"><option value="">none</option>
   </select></div>
  <div>params <textarea id="addparams" rows="3" cols="28"
       placeholder='{"limPhysX": [-20, 20]}'></textarea></div>
  <button id="addgo">create</button>
  <button id="addcancel">cancel</button>
 </div>
 <div id="els"></div>
 <div id="status"></div>
 <pre id="inspect" style="color:#9cd; font:11px monospace;
  white-space:pre-wrap; border-top:1px solid #333; margin-top:6px;
  padding-top:4px"></pre></div>
<div id="main">
 <div id="view3d"><canvas id="c3d"></canvas></div>
 <div id="histrow">
  <div id="histwrap"><canvas id="hist" width="480" height="480"></canvas>
  </div>
  <div id="readouts">
   <div>beam <select id="beamsel"></select></div>
   <div>flux <span class="v" id="flux"></span></div>
   <div>nGood <span class="v" id="ngood"></span></div>
   <div>center <span class="v" id="cen"></span> mm</div>
   <div>FWHM <span class="v" id="fwhm"></span> mm</div>
   <div>window <span class="v" id="ext"></span> mm</div>
   <div id="proberow">probe +<input type="range" id="probe" min="0"
    max="5000" step="10" value="0" style="width:120px">
    <span class="v" id="probed">0</span> mm</div>
  </div>
 </div>
</div>
<script>
const $ = id => document.getElementById(id);
async function jget(u) { const r = await fetch(u); return r.json(); }
async function jpost(u, body) {
  const r = await fetch(u, {method:'POST', body:JSON.stringify(body)});
  return r.json(); }

// ---- element tree ----
async function buildTree() {
  const els = await jget('/api/elements');
  const root = $('els'); root.innerHTML = '';
  for (const [name, params] of Object.entries(els)) {
    const d = document.createElement('details');
    const s = document.createElement('summary'); s.textContent = name;
    const del = document.createElement('button');
    del.textContent = '✕'; del.className = 'del';
    del.onclick = async ev => {
      ev.preventDefault();
      $('status').textContent = 'removing...';
      const r = await jpost('/api/remove', {name: name});
      $('status').textContent = r.error || '';
      buildTree(); refresh();
    };
    s.appendChild(del);
    const ins = document.createElement('button');
    ins.textContent = 'ⓘ'; ins.className = 'del';
    ins.style.color = '#8cf';
    ins.onclick = async ev => {
      ev.preventDefault();
      const d = await jget('/api/inspect?element=' +
                           encodeURIComponent(name));
      $('inspect').textContent = d.error ? d.error :
        JSON.stringify(d, (k, v) =>
          typeof v === 'number' ? Number(v.toPrecision(6)) : v, 1);
    };
    s.appendChild(ins);
    d.appendChild(s);
    for (const [p, v] of Object.entries(params)) {
      if (Array.isArray(v)) continue;           // vectors read-only
      const row = document.createElement('div'); row.className = 'prow';
      const lab = document.createElement('label'); lab.textContent = p;
      const inp = document.createElement('input');
      inp.value = Number(v).toPrecision(8);
      inp.onchange = async () => {
        $('status').textContent = 'tracing...';
        const r = await jpost('/api/set',
          {element: name, param: p, value: parseFloat(inp.value)});
        $('status').textContent = r.error || '';
        refresh();
      };
      row.appendChild(lab); row.appendChild(inp); d.appendChild(row);
    }
    root.appendChild(d);
  }
}

// ---- histogram ----
const turbo = t => {     // compact inferno-like colormap
  const r = Math.min(255, 255*Math.pow(t,0.5)*1.3);
  const g = Math.max(0, 255*(t*t*1.2-0.08));
  const b = t < 0.45 ? 255*(0.25+t) : 255*Math.max(0, 1.8-2.4*t);
  return [r|0, g|0, Math.max(0,b)|0];
};
async function drawHist() {
  const sel = $('beamsel');
  const probeD = parseFloat($('probe').value) || 0;
  const q = (sel.value ? ('?beam=' + encodeURIComponent(sel.value)) : '?x=1');
  const d = probeD > 0 ?
    await jget('/api/probe' + q + '&d=' + probeD) :
    await jget('/api/hist' + q);
  if (d.error) { $('status').textContent = d.error; return; }
  sel.onchange = () => { refreshBeams(); drawHist(); };
  renderHist(d);
}
async function refreshBeams() {
  const sel = $('beamsel'), cur = sel.value;
  const beams = await jget('/api/beams');
  sel.innerHTML = '';
  beams.forEach(b => {
    const o = document.createElement('option');
    o.value = o.textContent = b; sel.appendChild(o); });
  sel.value = beams.includes(cur) ? cur : beams[beams.length-1] || '';
}
function renderHist(d) {
  const n = d.h.length, cv = $('hist'), ctx = cv.getContext('2d');
  const img = ctx.createImageData(n, n);
  for (let i = 0; i < n; i++)          // rows = z, bottom-up
    for (let j = 0; j < n; j++) {
      const c = turbo(d.h[n-1-i][j]);
      const k = 4*(i*n+j);
      img.data[k]=c[0]; img.data[k+1]=c[1]; img.data[k+2]=c[2];
      img.data[k+3]=255;
    }
  const off = new OffscreenCanvas(n, n);
  off.getContext('2d').putImageData(img, 0, 0);
  ctx.imageSmoothingEnabled = false;
  ctx.clearRect(0,0,cv.width,cv.height);
  ctx.drawImage(off, 0, 0, cv.width, cv.height);
  $('flux').textContent = d.flux.toExponential(3);
  $('ngood').textContent = d.nGood;
  $('cen').textContent = d.cx.toPrecision(4)+', '+d.cz.toPrecision(4);
  $('fwhm').textContent =
    d.fwhm_x.toPrecision(3)+' x '+d.fwhm_z.toPrecision(3);
  $('ext').textContent =
    '['+d.extent[0].toPrecision(3)+', '+d.extent[1].toPrecision(3)+
    '] x ['+d.extent[2].toPrecision(3)+', '+d.extent[3].toPrecision(3)+']';
}

// ---- 3D view (glow) ----
let SCENE = null, yaw=0.6, pit=0.35, zoom=null, panX=0, panY=0;
const c3 = $('c3d'), ctx3 = c3.getContext('2d');
let W, H;
function resize3() {
  const r = $('view3d').getBoundingClientRect();
  W = c3.width = r.width; H = c3.height = r.height; draw3();
}
onresize = resize3;
let ctr=[0,0,0], span=1;
function setBounds() {
  let mn=[1e30,1e30,1e30], mx=[-1e30,-1e30,-1e30];
  const acc = p => { for (let k=0;k<3;k++) {
    mn[k]=Math.min(mn[k],p[k]); mx[k]=Math.max(mx[k],p[k]); } };
  SCENE.elements.forEach(e=>e.lines.forEach(l=>l.forEach(acc)));
  SCENE.segments.forEach(s=>s.p.forEach(pr=>pr.forEach(acc)));
  ctr=[0,1,2].map(k=>(mn[k]+mx[k])/2);
  span=Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-9);
  if (zoom === null) zoom = 0.9/span;
}
function proj(p) {
  const x=p[0]-ctr[0], y=p[1]-ctr[1], z=p[2]-ctr[2];
  const cy=Math.cos(yaw), sy=Math.sin(yaw);
  const cp=Math.cos(pit), sp=Math.sin(pit);
  const X = cy*y - sy*x, Y0 = cy*x + sy*y, Y = cp*z - sp*Y0;
  return [W/2 + X*zoom*W*0.9 + panX, H/2 - Y*zoom*W*0.9 + panY];
}
function draw3() {
  if (!SCENE) return;
  ctx3.clearRect(0,0,W,H);
  SCENE.segments.forEach(s => {
    for (let i=0;i<s.p.length;i++) {
      const a=proj(s.p[i][0]), b=proj(s.p[i][1]), c=s.rgb[i];
      ctx3.strokeStyle = `rgba(${255*c[0]|0},${255*c[1]|0},` +
        `${255*c[2]|0},${s.good[i] ? 0.5 : 0.07})`;
      ctx3.beginPath(); ctx3.moveTo(a[0],a[1]); ctx3.lineTo(b[0],b[1]);
      ctx3.stroke();
    }
  });
  SCENE.elements.forEach(e => {
    ctx3.strokeStyle = e.color; ctx3.globalAlpha = 0.9;
    e.lines.forEach(l => {
      ctx3.beginPath();
      l.forEach((p,i) => { const q=proj(p);
        i ? ctx3.lineTo(q[0],q[1]) : ctx3.moveTo(q[0],q[1]); });
      ctx3.stroke();
    });
    const q = proj(e.lines[0][0]);
    ctx3.fillStyle = e.color; ctx3.fillText(e.name, q[0]+4, q[1]-4);
    ctx3.globalAlpha = 1;
  });
}
let drag=null;
c3.onmousedown = e => drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup = () => drag=null;
onmousemove = e => { if (!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if (drag[2]) { panX+=dx; panY+=dy; }
  else { yaw+=dx*0.008; pit+=dy*0.008; }
  drag=[e.clientX,e.clientY,drag[2]]; draw3(); };
c3.onwheel = e => { zoom *= Math.exp(-e.deltaY*0.001); draw3();
  e.preventDefault(); };

async function drawScene() {
  SCENE = await jget('/api/scene'); setBounds(); draw3();
}
async function refresh() {
  await refreshBeams();
  await Promise.all([drawHist(), drawScene()]);
}

// ---- assembly toolbar ----
let REG = null;
async function loadRegistry() {
  REG = await jget('/api/registry');
  const cs = $('addclass'); cs.innerHTML = '';
  Object.keys(REG.classes).forEach(c => {
    const o = document.createElement('option');
    o.value = o.textContent = c; cs.appendChild(o); });
  const ms = $('addmat');
  for (const [cat, names] of Object.entries(REG.materials)) {
    const g = document.createElement('optgroup'); g.label = cat;
    names.forEach(nm => {
      const o = document.createElement('option');
      o.value = cat + ':' + nm; o.textContent = nm; g.appendChild(o); });
    ms.appendChild(g);
  }
}
$('addbtn').onclick = async () => {
  $('addform').style.display =
    $('addform').style.display === 'none' ? 'block' : 'none';
  if (!REG) loadRegistry();
  // input-beam selector: branch the new element off any placed element
  const els = await jget('/api/elements');
  const is_ = $('addinput'); is_.innerHTML =
    '<option value="">(previous)</option>';
  Object.keys(els).forEach(nm => {
    const o = document.createElement('option');
    o.value = o.textContent = nm; is_.appendChild(o); });
};
$('addcancel').onclick = () => $('addform').style.display = 'none';
$('addgo').onclick = async () => {
  const body = {name: $('addname').value,
                'class': $('addclass').value};
  try { body.params = JSON.parse($('addparams').value || '{}'); }
  catch (e) { $('status').textContent = 'bad params JSON'; return; }
  const dist = parseFloat($('adddist').value);
  if (!isNaN(dist)) body.distance = dist;
  if ($('addinput').value) body.input = $('addinput').value;
  const pv = $('addpitch').value.trim();
  if (pv === 'auto') body.autoBragg = true;
  else if (pv) body.pitch = parseFloat(pv);
  const mv = $('addmat').value;
  if (mv) {
    const [cat, nm] = mv.split(':');
    body.material = {catalog: cat, name: nm};
    if (cat === 'crystals' && body.params.hkl) {
      body.material.hkl = body.params.hkl; delete body.params.hkl;
    }
  }
  $('status').textContent = 'creating...';
  const r = await jpost('/api/add', body);
  $('status').textContent = r.error || '';
  if (!r.error) $('addform').style.display = 'none';
  buildTree(); refresh();
};
$('savebtn').onclick = () => window.open('/api/layout');
$('codebtn').onclick = () => window.open('/api/codegen');
$('loadfile').onchange = async ev => {
  const f = ev.target.files[0];
  if (!f) return;
  const text = await f.text();
  $('status').textContent = 'loading...';
  const r = await jpost('/api/load', {json: text});
  $('status').textContent = r.error || '';
  buildTree(); refresh();
};
document.querySelector('.loadlab').onclick = () => $('loadfile').click();
$('probe').oninput = () => {
  $('probed').textContent = $('probe').value;
  drawHist();
};
buildTree(); resize3(); refresh();
</script></body></html>
"""
