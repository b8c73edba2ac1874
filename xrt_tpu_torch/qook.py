"""Import reference-xrt Qook project files.

Port of the reference package's ``qook.py``.  xrtQook (the reference's
GUI beamline editor) saves projects as XML with four sections: Materials,
the beamline element tree (each element carrying its constructor
properties and its propagation method with beam wiring), plots, and the
run_ray_tracing card
(reference gui/xrtQook/widgets/qookbase.py, e.g.
examples/withRaycing/_QookBeamlines/*.xml).  This module loads such a
file directly into the port's objects, on the card by default
(``device=``):

    from xrt_tpu_torch.qook import load_qook_project
    prj = load_qook_project('1crystal.xml')
    beams = prj.beamline.propagate_flow(torch.Generator('cuda'))
    run_ray_tracing(prj.plots, beamLine=prj.beamline, **prj.run_kwargs,
                    run_process=lambda bl, g: bl.propagate_flow(g))

Class names map one-to-one (the same physics classes exist here);
parameters this package does not take (targetOpenCL, shouldCheckCenter,
...) are collected in ``prj.skipped`` instead of raising.  'auto'
placement (centers with "auto" components, pitch='auto' from a crystal)
follows a one-ray alignment beam through each element's own propagation
method, like Qook's own auto-alignment.
"""
from __future__ import annotations

import ast
import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from .beamline import BeamLine, _create_signature_names


@dataclass
class QookProject:
    beamline: BeamLine
    plots: List[Any]
    run_kwargs: Dict[str, Any]
    materials: Dict[str, Any]
    beam_sources: Dict[str, str]         # beam name -> element name
    beam_keys: Dict[str, str] = field(default_factory=dict)
    skipped: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    description: str = ''


_EVAL_NAMES = {'auto': 'auto', 'None': None, 'True': True, 'False': False,
               'pi': math.pi, 'inf': math.inf}
_NP_WHITELIST = {'pi', 'inf', 'e', 'linspace', 'arange', 'array', 'sqrt',
                 'sin', 'cos', 'tan', 'radians', 'degrees', 'abs', 'exp',
                 'log', 'log10'}


def _safe_eval(node):
    """Evaluate the tiny expression language Qook files actually use
    (arithmetic, tuples/lists, np.pi / np.linspace(...)) WITHOUT eval —
    a project file is untrusted input."""
    if isinstance(node, ast.Expression):
        return _safe_eval(node.body)
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        if node.id in _EVAL_NAMES:
            return _EVAL_NAMES[node.id]
        raise ValueError(node.id)
    if isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and \
                node.value.id in ('np', 'numpy', 'math') and \
                node.attr in _NP_WHITELIST:
            return getattr(np, node.attr) if node.value.id != 'math' \
                else getattr(math, node.attr)
        raise ValueError('attribute')
    if isinstance(node, ast.Call):
        fn = _safe_eval(node.func)
        if node.keywords:
            raise ValueError('kwargs')
        return fn(*[_safe_eval(a) for a in node.args])
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow,
                      ast.FloorDiv, ast.Mod)):
        L, R = _safe_eval(node.left), _safe_eval(node.right)
        op = type(node.op)
        return {ast.Add: lambda: L + R, ast.Sub: lambda: L - R,
                ast.Mult: lambda: L * R, ast.Div: lambda: L / R,
                ast.Pow: lambda: L ** R, ast.FloorDiv: lambda: L // R,
                ast.Mod: lambda: L % R}[op]()
    if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.UAdd, ast.USub)):
        v = _safe_eval(node.operand)
        return v if isinstance(node.op, ast.UAdd) else -v
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = [_safe_eval(e) for e in node.elts]
        return tuple(vals) if isinstance(node, ast.Tuple) else vals
    raise ValueError(type(node).__name__)


def _parse_value(text):
    """Qook stores values as python expressions ('10000-10', '(0, 0, 0)',
    '[0, 21000, "auto"]', 'auto', 'None', 'np.linspace(-2, 2, 5)').
    Evaluated with a whitelisted mini-interpreter, never eval()."""
    if text is None:
        return None
    t = text.strip()
    if t == '':
        return None
    try:
        return ast.literal_eval(t)
    except (ValueError, SyntaxError):
        pass
    try:
        return _safe_eval(ast.parse(t, mode='eval'))
    except (ValueError, SyntaxError, TypeError, KeyError, ZeroDivisionError):
        return t          # a bareword: element/material/beam name, 'Si'...


def _props(node):
    out = {}
    p = node.find('properties')
    if p is None:
        return out
    for ch in p:
        out[ch.tag] = _parse_value(ch.text)
    return out


def _obj_path(node):
    o = node.find('_object')
    return (o.text or '').strip() if o is not None else ''


_DROP_PARAMS = {'bl', 'targetOpenCL', 'precisionOpenCL',
                'shouldCheckCenter', 'uuid', 'surface'}


def _resolve_class(obj_path):
    """'xrt.backends.raycing.oes.OE' -> the same-named class of this
    package."""
    from . import apertures, screens
    from . import materials as xm
    from . import oes, sources
    cls_name = obj_path.rsplit('.', 1)[-1]
    for ns in (sources, oes, apertures, screens, xm):
        cls = getattr(ns, cls_name, None)
        if cls is not None:
            return cls
    raise ValueError(f'no equivalent of {obj_path!r} in this package')


def _filtered_create_kwargs(cls, params, skipped, tag, dtype=None,
                            device=None):
    accepted = _create_signature_names(cls)
    kwargs, skip = {}, {}
    for k, v in params.items():
        if v is None or k in _DROP_PARAMS:
            continue
        if isinstance(v, str) and v == 'auto' and \
                k not in ('pitch', 'bragg'):
            # 'auto' values other than placement pitch are defaults here
            # (x/z screen orientation resolves from the axis below)
            if k not in ('x', 'z'):
                skip[k] = v
            continue
        if k in accepted:
            kwargs[k] = v
        else:
            skip[k] = v
    if skip:
        skipped[tag] = skip
    if 'device' in accepted or _takes_kwargs(cls):
        kwargs.update(dtype=dtype, device=device)
    return kwargs


def _takes_kwargs(fn):
    """A factory function that passes ``**kwargs`` on (``Coated``)."""
    import inspect
    if isinstance(fn, type):
        return False
    return any(p.kind == p.VAR_KEYWORD
               for p in inspect.signature(fn).parameters.values())


def _alignment_beam(p, d, E, dtype, device):
    import torch

    from . import config
    from .beam import Beam

    def one(v):
        return torch.full((1,), float(v), dtype=dtype, device=device)
    return Beam(x=one(p[0]), y=one(p[1]), z=one(p[2]),
                a=one(d[0]), b=one(d[1]), c=one(d[2]), E=one(E),
                state=torch.ones((1,), dtype=torch.int32, device=device),
                path=one(0.0), Jss=one(0.5), Jpp=one(0.5),
                Jsp=torch.zeros((1,), dtype=config.cdtype(dtype),
                                device=device))


def _advance_alignment(el, p, d, E, center, dtype, device):
    """Propagate the single alignment ray through the freshly built
    element with its REAL method (the reference advances its alignment
    beam the same way, beamline.py:380-428); fall back to the incoming
    ray when the element cannot take it, and say why."""
    import torch
    if hasattr(el, 'shine'):
        c = np.asarray(el.center, float) if getattr(el, 'center', None) \
            is not None else center
        return c, np.array([0.0, 1.0, 0.0])
    try:
        beam = _alignment_beam(p, d, E, dtype, device)
        g = torch.Generator(device).manual_seed(0)
        if hasattr(el, 'double_reflect'):
            out = el.double_reflect(beam, generator=g)[0]
        elif hasattr(el, 'double_refract'):
            out = el.double_refract(beam, generator=g)[0]
        elif hasattr(el, 'reflect'):
            out = el.reflect(beam, generator=g)[0]
        elif hasattr(el, 'propagate'):
            out = el._to_global(el.propagate(beam))
        else:
            return p, d       # screens do not change the ray
        vals = torch.stack([out.x[0], out.y[0], out.z[0], out.a[0],
                            out.b[0], out.c[0]]).double().cpu().numpy()
        p2, d2 = vals[:3], vals[3:]
        if int(out.state[0]) > 0 and np.all(np.isfinite(p2)) and \
                np.all(np.isfinite(d2)) and np.linalg.norm(d2) > 0.5:
            return p2, d2 / np.linalg.norm(d2)
    except Exception as e:   # any element kind: report, keep loading
        print(f'qook: the alignment ray does not pass '
              f'{type(el).__name__} ({type(e).__name__}: {e}); it goes '
              f'on unchanged')
    return p, d


def load_qook_project(fileName_or_text, nrays=None, dtype=None,
                      device=None) -> QookProject:
    """Load a Qook project XML into (BeamLine, plots, run kwargs).

    *nrays*: override every source's ray count (quick looks / tests).
    *dtype*, *device*: of the sources, materials and the alignment ray
    (float32 on the card by default)."""
    from . import config as _cfg
    dtype = _cfg.resolve_dtype(dtype)
    device = _cfg.resolve_device(device)
    text = fileName_or_text
    if not text.lstrip().startswith('<'):
        with open(fileName_or_text) as f:
            text = f.read()
    root = ET.fromstring(text)
    skipped: Dict[str, Dict[str, Any]] = {}

    # --- materials
    materials: Dict[str, Any] = {}
    mats_node = root.find('Materials')
    if mats_node is not None:
        for m in mats_node:
            cls = _resolve_class(_obj_path(m))
            params = _props(m)
            # nested material references (e.g. multilayer layers)
            for k, v in list(params.items()):
                if isinstance(v, str) and v in materials:
                    params[k] = materials[v]
            kwargs = _filtered_create_kwargs(cls, params, skipped, m.tag,
                                             dtype, device)
            materials[m.tag] = cls.create(**kwargs) \
                if hasattr(cls, 'create') else cls(**kwargs)

    # --- the beamline node: any direct child whose _object is a BeamLine
    bl_node = None
    for ch in root:
        if _obj_path(ch).endswith('BeamLine'):
            bl_node = ch
            break
    if bl_node is None:
        raise ValueError('no BeamLine section in the Qook project')
    blp = _props(bl_node)
    alignE = blp.get('alignE', 9000.0)
    from . import config as _config
    eparsed = _config.parse_energy(alignE) if isinstance(alignE, str) \
        else None
    if eparsed is not None:
        alignE = eparsed
    bl = BeamLine(azimuth=float(blp.get('azimuth', 0.0) or 0.0),
                  height=float(blp.get('height', 0.0) or 0.0),
                  alignE=9000.0 if alignE in (None, 'auto')
                  else float(alignE),
                  name=bl_node.tag)

    # collect elements: child nodes with an _object class + a method node
    elements = []
    for el in bl_node:
        if el.tag in ('properties', '_object'):
            continue
        obj = _obj_path(el)
        if not obj:
            continue
        method_node = None
        for mn in el:
            if mn.tag in ('properties', '_object'):
                continue
            if mn.find('_object') is not None:
                method_node = mn
                break
        elements.append((el, obj, method_node))

    # 'auto' alignE: middle of the first source's energy window
    if alignE in (None, 'auto') and elements:
        p0 = _props(elements[0][0])
        if p0.get('eMin') is not None and p0.get('eMax') is not None:
            bl.alignE = 0.5 * (float(p0['eMin']) + float(p0['eMax']))

    # --- build elements, auto-aligning with a traced 1-ray alignment
    # beam exactly like the reference (beamline.py:430-503: fixed-plane
    # intersection for 'auto' center components, the targetPitch formula
    # for pitch/bragg='auto', then the real propagation method advances
    # the alignment beam)
    beam_sources: Dict[str, str] = {}
    beam_keys: Dict[str, str] = {}
    align: Dict[str, Any] = {}       # element -> (point, direction)
    p_cur = np.zeros(3)
    d_cur = np.array([0.0, 1.0, 0.0])
    for el, obj, method_node in elements:
        src_el = None
        if method_node is not None:
            pnode = method_node.find('parameters')
            if pnode is not None:
                in_beam = (pnode.findtext('beam') or '').strip()
                src_el = beam_sources.get(in_beam)
        if src_el is not None and src_el in align:
            p_cur, d_cur = align[src_el]
        cls = _resolve_class(obj)
        params = _props(el)
        for k, v in list(params.items()):
            if isinstance(v, str) and v in materials:
                params[k] = materials[v]
        center = params.pop('center', (0.0, 0.0, 0.0))
        if nrays is not None and 'nrays' in params:
            params['nrays'] = int(nrays)
        pitch = params.get('pitch')
        kwargs = _filtered_create_kwargs(cls, params, skipped, el.tag,
                                         dtype, device)
        kwargs.pop('center', None)
        kwargs.pop('name', None)    # registered under the node tag

        # 'auto' center components: intersect the alignment ray with the
        # plane of a fixed coordinate (reference beamline.py:440-454)
        c = list(center) if isinstance(center, (list, tuple)) \
            else list(np.asarray(center, float))
        if any(v == 'auto' for v in c):
            t = None
            for i in (1, 0, 2):
                if c[i] != 'auto' and abs(d_cur[i]) > 1e-3:
                    t = (float(c[i]) - p_cur[i]) / d_cur[i]
                    break
            t = 0.0 if t is None else t
            for i in range(3):
                c[i] = float(p_cur[i] + t * d_cur[i]) if c[i] == 'auto' \
                    else float(c[i])
        else:
            c = [float(v) for v in c]

        # screen 'auto' orientation: perpendicular to the incoming ray
        if hasattr(cls, 'expose') and \
                (params.get('x') == 'auto' or params.get('z') == 'auto'):
            if not np.allclose(d_cur, [0.0, 1.0, 0.0], atol=1e-12):
                x_b = np.cross(d_cur, [0.0, 0.0, 1.0])
                nx = np.linalg.norm(x_b)
                x_b = np.array([1.0, 0.0, 0.0]) if nx < 1e-12 else x_b / nx
                z_b = np.cross(x_b, d_cur)
                if params.get('x') == 'auto':
                    kwargs['x'] = tuple(x_b)
                if params.get('z') == 'auto':
                    kwargs['z'] = tuple(z_b)

        # pitch/bragg='auto': the reference targetPitch formula
        # (beamline.py:472-503)
        if pitch == 'auto' or kwargs.get('bragg') == 'auto':
            from . import config as _config
            mat = kwargs.get('material')
            mats = mat if not isinstance(mat, (list, tuple)) else \
                mat[int(kwargs.get('curSurface', 0) or 0)]
            target = 0.0
            if mats is not None and hasattr(mats, 'get_Bragg_angle'):
                braggT = float(mats.get_Bragg_angle(bl.alignE))
                alphaT = _config.auto_units_angle(
                    kwargs.get('alpha')) or 0.0
                lauePitch = 0.0
                geom = getattr(mats, 'geom', '')
                if getattr(mats, 'kind', '') == 'multilayer':
                    braggT -= float(mats.get_dtheta(bl.alignE))
                elif geom.startswith('Laue'):
                    lauePitch = 0.5 * math.pi
                else:
                    try:
                        braggT -= float(mats.get_dtheta(bl.alignE, alphaT))
                    except TypeError:
                        braggT -= float(mats.get_dtheta(bl.alignE))
                roll0 = (_config.auto_units_angle(
                    kwargs.get('positionRoll')) or 0.0) + \
                    (_config.auto_units_angle(kwargs.get('roll')) or 0.0)
                yaw0 = _config.auto_units_angle(kwargs.get('yaw')) or 0.0
                a_, b_, cz = d_cur
                # undo the element's yaw (about z) then roll (about y) —
                # the reference's RzRyRx order (rotate_beam,
                # _rotate.py:39-43)
                cy, sy = math.cos(-yaw0), math.sin(-yaw0)
                a1, b1 = cy * a_ - sy * b_, sy * a_ + cy * b_
                ca, sa = math.cos(-roll0), math.sin(-roll0)
                a2, c1 = ca * a1 + sa * cz, -sa * a1 + ca * cz
                theta0 = math.atan2(-c1, b1)
                th2pitch = math.sqrt(max(1.0 - a2 * a2, 1e-12))
                target = math.asin(
                    min(1.0, math.sin(braggT) / th2pitch)) - theta0
                target += alphaT + lauePitch
            if pitch == 'auto':
                kwargs['pitch'] = target
            if kwargs.get('bragg') == 'auto':
                kwargs['bragg'] = target - (_config.auto_units_angle(
                    kwargs.get('pitch')) or 0.0)

        factory = getattr(cls, 'create', cls)
        if 'center' in _create_signature_names(cls):
            el_obj = factory(center=tuple(c), **kwargs)
        else:
            el_obj = factory(**kwargs)
        bl.add(el.tag, el_obj)

        # '_input' names the upstream element for propagate_flow
        if src_el is not None:
            n_, k_, m_, kw_ = bl.flow[-1]
            kw_ = dict(kw_)
            kw_['_input'] = src_el
            bl.flow[-1] = (n_, k_, m_, kw_)

        # advance the alignment ray through the element
        p_cur, d_cur = _advance_alignment(el_obj, p_cur, d_cur, bl.alignE,
                                          np.asarray(c, float), dtype,
                                          device)
        align[el.tag] = (p_cur, d_cur)

        # record which beam names this element's method produces.
        # beam_sources (for '_input' wiring) always points at the element
        # (propagate_flow's GLOBAL beam); beam_keys maps each output beam
        # to its exact key in the propagate_flow dict so plots of local
        # footprints keep local coordinates
        if method_node is not None:
            out = method_node.find('output')
            if out is not None:
                isScreenLike = hasattr(cls, 'expose') or \
                    (hasattr(cls, 'propagate') and
                     not hasattr(cls, 'reflect'))
                for b in out:
                    bname = (b.text or '').strip()
                    beam_sources[bname] = el.tag
                    if b.tag == 'beamLocal1':
                        beam_keys[bname] = el.tag + '_local1'
                    elif b.tag == 'beamLocal2':
                        beam_keys[bname] = el.tag + '_local2'
                    elif b.tag.startswith('beamLocal') and not isScreenLike:
                        beam_keys[bname] = el.tag + '_local'
                    else:
                        beam_keys[bname] = el.tag

    # --- plots
    plots = []
    plots_node = root.find('plots')
    if plots_node is not None:
        from .plotspec import XYCAxis, XYCPlot
        ax_names = _create_signature_names(XYCAxis) | \
            set(XYCAxis.__dataclass_fields__)
        pl_names = set(XYCPlot.__dataclass_fields__)
        for pn in plots_node:
            kw: Dict[str, Any] = {}
            for ch in pn:
                if ch.tag == '_object':
                    continue
                if ch.find('_object') is not None:     # an axis
                    axkw = {c.tag: _parse_value(c.text) for c in ch
                            if c.tag != '_object'}
                    axkw = {k: v for k, v in axkw.items()
                            if k in ax_names and v is not None}
                    kw[ch.tag] = XYCAxis(**axkw)
                else:
                    v = _parse_value(ch.text)
                    if ch.tag in pl_names and v is not None:
                        kw[ch.tag] = v
            beam = kw.get('beam', '')
            if beam in beam_keys:
                kw['beam'] = beam_keys[beam]
            if isinstance(kw.get('rayFlag'), (list, tuple)):
                kw['rayFlag'] = tuple(kw['rayFlag'])
            elif isinstance(kw.get('rayFlag'), int):
                kw['rayFlag'] = (kw['rayFlag'],)
            plots.append(XYCPlot(**kw))

    # --- run card
    run_kwargs: Dict[str, Any] = {}
    rn = root.find('run_ray_tracing')
    if rn is not None:
        for ch in rn:
            if ch.tag in ('repeats', 'updateEvery', 'pickleEvery'):
                v = _parse_value(ch.text)
                if isinstance(v, (int, float)):
                    run_kwargs[ch.tag] = int(v)

    desc = root.findtext('description') or ''
    return QookProject(beamline=bl, plots=plots, run_kwargs=run_kwargs,
                       materials=materials, beam_sources=beam_sources,
                       beam_keys=beam_keys, skipped=skipped,
                       description=desc.strip())
