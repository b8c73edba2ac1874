"""BeamLine: a host-side container of beamline elements that places them
along the optical axis, runs their default flow and writes and reads
layouts.

Port of the reference package's ``beamline.py``: the element registry
(``add``, ``remove``, ``reorder``, ``update``, ``__getitem__``), the
default flow it records and runs (``propagate_flow``, with one
``torch.Generator`` stream where the reference splits a key a step),
``check_alarms``, ``place``, which builds an element on the current
optical axis: its centre at a distance along the axis, its pitch from a
crystal's Bragg angle at ``alignE`` ('auto'), the extra angles that turn
its frame into a deflected beam's frame (``_axis_extra_angles``), the axis
deflected by a mirror and moved by a fixed-exit monochromator's offset;
and the JSON and XML layouts (``export_to_json``/``load_from_json``,
``export_to_xml``/``load_from_xml``) with the elements' creation
parameters (``_element_params``) and materials (``materials.serialize``).
All of it is host float64 numpy, as in the reference; the elements it
builds run on their own device.

A layout names each element's class and module.  The module is resolved
below its top-level package name inside this package
(:func:`_layout_module`), so the two packages read each other's layouts.
``glow`` writes the 3D view (:mod:`xrt_tpu_torch.glow`).
"""
from __future__ import annotations

import importlib
import inspect
import json
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import config
from .transforms import rotate_xyz


def _rot_matrix(seq, pitch, roll, yaw):
    """The 3 x 3 matrix of ``transforms.rotate_xyz`` with the given angles
    (acting on column vectors), built by applying it to the basis."""
    cols = []
    for v in np.eye(3):
        x, y, z = rotate_xyz(float(v[0]), float(v[1]), float(v[2]), seq,
                             pitch, roll, yaw)
        cols.append([float(x), float(y), float(z)])
    return np.array(cols).T


def _rodrigues(v, axis, ang):
    axis = np.asarray(axis, float)
    axis = axis / np.linalg.norm(axis)
    c, s = math.cos(ang), math.sin(ang)
    return v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c)


def _axis_extra_angles(d, pitch, roll, yaw, seq='RzRyRx'):
    """The extra (pitch, roll, yaw) that turn an element's frame into the
    beam's frame when the optical axis *d* is not +y.

    The element's global -> local transform is ``Rext(-e) @ Rmain(-m)``;
    an element aligned to the tilted axis needs ``Rmain(-m) @ T^-1``, T
    mapping y-hat onto *d*.  Hence ``Rext(-e) = Rmain(-m) @ T^-1 @
    Rmain(-m)^-1``, and the angles follow from the Euler extraction of the
    Rx @ Ry @ Rz composition of 'RzRyRx'."""
    d = np.asarray(d, float)
    d = d / np.linalg.norm(d)
    yhat = np.array([0.0, 1.0, 0.0])
    axis = np.cross(yhat, d)
    na = np.linalg.norm(axis)
    if na < 1e-15:
        return 0.0, 0.0, 0.0
    ang = math.atan2(na, float(np.dot(yhat, d)))
    T = np.stack([_rodrigues(v, axis, ang) for v in np.eye(3)]).T
    Mi = _rot_matrix(seq, -pitch, -roll, -yaw)
    G = Mi @ T.T @ np.linalg.inv(Mi)
    # G = Rx(a) @ Ry(b) @ Rz(c) with the angles (-ep, -er, -ey)
    b = math.asin(max(-1.0, min(1.0, G[0, 2])))
    c = math.atan2(-G[0, 1], G[0, 0])
    a = math.atan2(-G[1, 2], G[2, 2])
    return -a, -b, -c


def _beam_axes(d):
    """The beam frame's x and z axes for the axis direction *d*."""
    x_b = np.cross(d, [0.0, 0.0, 1.0])
    nx = np.linalg.norm(x_b)
    x_b = np.array([1.0, 0.0, 0.0]) if nx < 1e-12 else x_b / nx
    return x_b, np.cross(x_b, d)


class BeamLine:
    """Container of sources, optical elements, apertures and screens.

    *azimuth* turns the beamline's horizontal axis; *alignE* is the energy
    of 'auto' Bragg angles."""

    def __init__(self, azimuth=0.0, height=0.0, alignE=9000.0, name=''):
        self.name = name
        self.azimuth = azimuth
        self.height = height
        self.alignE = alignE
        self.sources: List[Any] = []
        self.oes: List[Any] = []
        self.slits: List[Any] = []
        self.screens: List[Any] = []
        self.flow: List[tuple] = []      # (name, kind, method, kwargs)
        self.alarms: List[str] = []
        self._elements: Dict[str, Any] = {}
        # the optical axis of the placement: a point and a direction, and
        # its state before and after each element (``remove`` of the last
        # element rewinds to the first, a branch resumes from the second)
        self._axis_point = np.zeros(3)
        self._axis_dir = np.array([0.0, 1.0, 0.0])
        self._axis_before: Dict[str, tuple] = {}
        self._axis_after: Dict[str, tuple] = {}

    @property
    def sinAzimuth(self):
        return math.sin(self.azimuth)

    @property
    def cosAzimuth(self):
        return math.cos(self.azimuth)

    # ------------------------------------------------------------------
    def add(self, name: str, element: Any, kind: str = 'auto',
            method: Optional[str] = None, **methodKwargs):
        """Register *element* under *name* and append it to the default
        flow.  *kind* is 'source', 'oe', 'slit', 'screen' or 'auto'.  The
        placement axis moves on to the element's centre, along the line
        from the previous one."""
        if kind == 'auto':
            if hasattr(element, 'shine'):
                kind = 'source'
            elif hasattr(element, 'propagate') and not hasattr(element,
                                                              'reflect'):
                kind = 'slit'
            elif hasattr(element, 'expose'):
                kind = 'screen'
            else:
                kind = 'oe'
        {'source': self.sources, 'oe': self.oes, 'slit': self.slits,
         'screen': self.screens}[kind].append(element)
        self._axis_before.setdefault(
            name, (self._axis_point.copy(), self._axis_dir.copy()))
        c = getattr(element, 'center', None)
        if c is not None:
            c = np.array([config.host_float(v) for v in c], float)
            if c.shape == (3,) and np.all(np.isfinite(c)):
                d = c - self._axis_point
                nrm = float(np.linalg.norm(d))
                if nrm > 1e-9:
                    self._axis_dir = d / nrm
                self._axis_point = c
        self._axis_after[name] = (self._axis_point.copy(),
                                  self._axis_dir.copy())
        self._elements[name] = element
        if method is None:
            method = {'source': 'shine', 'oe': 'reflect',
                      'slit': 'propagate', 'screen': 'expose'}[kind]
            if hasattr(element, 'double_refract'):
                method = 'double_refract'
            elif hasattr(element, 'double_reflect'):
                method = 'double_reflect'
        self.flow.append((name, kind, method, methodKwargs))
        return element

    def __getitem__(self, name):
        return self._elements[name]

    def remove(self, name: str):
        """Unregister *name* and drop its flow step.  Removing the element
        added last rewinds the placement axis to its state before it, so
        remove and place again at a distance is an undo."""
        was_last = bool(self.flow) and self.flow[-1][0] == name
        el = self._elements.pop(name)
        for lst in (self.sources, self.oes, self.slits, self.screens):
            for i, e in enumerate(lst):
                if e is el:      # by identity, not by equality
                    del lst[i]
                    break
        self.flow = [s for s in self.flow if s[0] != name]
        axis = self._axis_before.pop(name, None)
        self._axis_after.pop(name, None)
        if was_last and axis is not None:
            self._axis_point, self._axis_dir = axis
        return el

    def reorder(self, names):
        """Reorder the default flow to *names*: every flow step's name,
        each once."""
        steps = {s[0]: s for s in self.flow}
        if sorted(names) != sorted(steps):
            raise ValueError(f'reorder needs exactly {sorted(steps)}, '
                             f'got {sorted(names)}')
        self.flow = [steps[n] for n in names]

    def update(self, name, element):
        """Put *element* (e.g. a ``replace`` copy) in the place of the
        element registered as *name*; its flow step stays."""
        old = self._elements[name]
        self._elements[name] = element
        for lst in (self.sources, self.oes, self.slits, self.screens):
            for i, e in enumerate(lst):
                if e is old:
                    lst[i] = element

    # ------------------------------------------------------------------
    def place(self, name, element_cls, distance=None, center=None,
              pitch=None, bragg_material=None, deflection='up',
              autoOrient=True, after=None, flowKwargs=None, **kwargs):
        """Build and register an element aligned on the current optical
        axis.

        *distance*: the centre lies this far along the axis from the
        previous element (else *center* is given).  *pitch*: a number, or
        'auto' with *bragg_material* (or the element's material): the Bragg
        angle, less the refraction correction, at ``alignE``.
        *deflection*: 'up', 'down', 'left' or 'right', how a reflecting
        element bends the axis.  *autoOrient*: off the +y axis, turn the
        element's frame into the beam's by the extra angles
        (:func:`_axis_extra_angles`), as the second mirror of a KB pair
        needs.  *after*: the name of a placed element to branch from; the
        trunk's axis is kept.  *flowKwargs* go to the recorded flow
        step."""
        trunk_axis = None
        if after is not None:
            st = self._axis_after.get(after)
            if st is None:
                raise KeyError(f'place(after={after!r}): no such placed '
                               f'element')
            trunk_axis = (self._axis_point.copy(), self._axis_dir.copy())
            self._axis_point, self._axis_dir = (st[0].copy(),
                                                st[1].copy())
            flowKwargs = dict(flowKwargs or {})
            flowKwargs.setdefault('_input', after)
        if center is None:
            center = self._axis_point + self._axis_dir * float(distance)
        center = np.asarray(center, float)
        for angName in ('pitch', 'roll', 'yaw', 'positionRoll'):
            if angName in kwargs:
                kwargs[angName] = config.auto_units_angle(kwargs[angName])
        pitch = config.auto_units_angle(pitch)
        if pitch == 'auto':
            m = bragg_material or kwargs.get('material')
            pitch = float(m.get_Bragg_angle(self.alignE) -
                          m.get_dtheta(self.alignE))
        if pitch is not None:
            kwargs['pitch'] = pitch
        d = self._axis_dir / np.linalg.norm(self._axis_dir)
        canOrient = hasattr(element_cls, 'reflect') or \
            hasattr(element_cls, 'double_reflect')
        if autoOrient and canOrient and \
                not np.allclose(d, [0.0, 1.0, 0.0], atol=1e-12):
            ep, er, ey = _axis_extra_angles(
                d,
                float(kwargs.get('pitch', 0.0) or 0.0),
                float(kwargs.get('roll', 0.0) or 0.0) +
                float(kwargs.get('positionRoll', 0.0) or 0.0),
                float(kwargs.get('yaw', 0.0) or 0.0),
                kwargs.get('rotationSequence', 'RzRyRx'))
            kwargs.setdefault('extraPitch', ep)
            kwargs.setdefault('extraRoll', er)
            kwargs.setdefault('extraYaw', ey)
        if hasattr(element_cls, 'create'):
            element = element_cls.create(center=tuple(center), **kwargs)
        else:       # a factory function
            element = element_cls(center=tuple(center), **kwargs)
        self.add(name, element, **(flowKwargs or {}))
        self._axis_point = center
        perp = getattr(element, 'cryst2perpTransl', None)
        if perp is not None and hasattr(element, 'double_reflect') and \
                config.host_float(perp) != 0.0:
            # a fixed-exit DCM: the axis jumps by 2 perp cos(bragg), the
            # fixed offset, along the beam's z
            fx = 2.0 * config.host_float(perp) * \
                math.cos(config.host_float(element.braggAngle))
            self._axis_point = self._axis_point + _beam_axes(d)[1] * fx
        if pitch and hasattr(element, 'reflect') and \
                not hasattr(element, 'double_reflect'):
            sign = {'up': 1.0, 'down': -1.0}.get(deflection, 1.0)
            dbl = 2.0 * float(pitch) * sign
            # turn the axis in the beam's frame: about its x for up/down,
            # about its z for left/right
            x_b, z_b = _beam_axes(d)
            if deflection in ('up', 'down'):
                axis, ang = x_b, dbl
            else:
                axis = z_b
                ang = dbl * (1.0 if deflection == 'left' else -1.0)
            self._axis_dir = _rodrigues(d, axis, ang)
        self._axis_after[name] = (self._axis_point.copy(),
                                  self._axis_dir.copy())
        if trunk_axis is not None:
            self._axis_point, self._axis_dir = trunk_axis
        return element

    @property
    def axis_point(self):
        return self._axis_point.copy()

    @property
    def axis_dir(self):
        return self._axis_dir.copy()

    # ------------------------------------------------------------------
    def propagate_flow(self, generator=None, startFrom=0):
        """Run the recorded default flow; returns {name: beam}: a
        source's beam, an OE's global beam (and its local beams under
        name + '_local', '_local1', '_local2'), an aperture's local beam
        and a screen's image.  *generator* (a ``torch.Generator``; seed 0
        on the first source's device if None) is the one stream every
        step draws from, in flow order.  A step's '_input' names the
        element whose global beam feeds it."""
        beams = {}
        globalBeams = {}
        beam = None
        for i, (name, kind, method, kwargs) in enumerate(self.flow):
            if i < startFrom and beam is not None:
                continue
            el = self._elements[name]
            fn = getattr(el, method)
            kwargs = dict(kwargs)
            inputName = kwargs.pop('_input', None)
            if inputName is not None and inputName in globalBeams:
                beam = globalBeams[inputName]
            if kind == 'source':
                if generator is None:
                    generator = torch.Generator(config.resolve_device(
                        getattr(el, 'device', None))).manual_seed(0)
                beam = fn(generator, **kwargs)
                beams[name] = beam
            elif method in ('double_reflect', 'double_refract'):
                beam, lo1, lo2 = fn(beam, generator=generator, **kwargs)
                beams[name] = beam
                beams[name + '_local1'] = lo1
                beams[name + '_local2'] = lo2
            elif method == 'reflect':
                beam, lo = fn(beam, generator=generator, **kwargs)
                beams[name] = beam
                beams[name + '_local'] = lo
            elif method == 'propagate':
                lo = fn(beam, **kwargs)
                beams[name] = lo
                beam = el._to_global(lo)
            elif method == 'expose':
                beams[name] = fn(beam, **kwargs)
            else:
                beam = fn(beam, **kwargs)
                beams[name] = beam
            globalBeams[name] = beam
        return beams

    def glow(self, beams=None, save='glow.html', maxRays=200, scan=None,
             flow=None, generator=None):
        """Headless 3D view of the beamline layout and traced beams: the
        capability analog of the reference's ``bl.glow()`` Qt/OpenGL
        viewer (beamline.py:888, gui/xrtGlow).  Writes a standalone
        interactive HTML file (or a PNG if *save* ends with '.png') and
        returns the file name.  *beams*: an ordered {name: Beam} of global
        beams, e.g. from :meth:`propagate_flow`.

        *scan*: ``{'element': name, 'param': field, 'values': [...]}``
        animates a parameter sweep with a play slider (the reference's
        xrtGlow scan player, gui/xrtGlow/widgets/scan.py): each frame is
        a dirty-aware flow replay at one value.  Pass a recorded *flow*
        (:func:`xrt_tpu_torch.flow.record_flow`) or one is recorded here
        with *generator* (seed 0 on the first source's device if None)."""
        from . import glow as _glow
        if scan is not None:
            if flow is None:
                from .flow import record_flow
                with record_flow(self) as flow:
                    self.propagate_flow(generator)
            frames = _glow.build_scan_frames(
                self, flow, scan['element'], scan['param'],
                scan['values'], maxRays=maxRays)
            return _glow.export_scan_html(
                frames, fileName=save,
                title=f"{self.name or 'beamline'} — scan "
                      f"{scan['element']}.{scan['param']}")
        if str(save).endswith('.png'):
            return _glow.export_png(self, beams=beams, fileName=save,
                                    maxRays=maxRays)
        return _glow.export_html(self, beams=beams, fileName=save,
                                 maxRays=maxRays)

    def check_alarms(self, beams, threshold=0.5):
        """The elements of the flow that lose more than *threshold* of the
        rays alive before them (a host read of each beam's states)."""
        self.alarms = []
        prev_alive = None
        for name, kind, method, _ in self.flow:
            if name not in beams:
                continue
            alive = int((beams[name].state > 0).sum())
            if prev_alive and alive < prev_alive * (1 - threshold):
                self.alarms.append(
                    f'{name}: absorbed '
                    f'{(prev_alive - alive) / prev_alive:.1%} of rays')
            prev_alive = alive
        return self.alarms

    # ------------------------------------------------------------------
    def export_to_xml(self, fileName=None):
        """The XML layout: the JSON layout's content (without the axis
        state) as elements with param, material and methodKwargs
        children."""
        import xml.etree.ElementTree as ET
        from xml.dom import minidom
        root = ET.Element('beamline', name=self.name,
                          azimuth=repr(self.azimuth),
                          height=repr(self.height),
                          alignE=repr(self.alignE))
        for entry in self._layout_entries():
            e = ET.SubElement(root, 'element', name=entry['name'],
                              kind=entry['kind'], method=entry['method'],
                              **{'class': entry['class'],
                                 'module': entry['module']})
            for k, v in entry['params'].items():
                ET.SubElement(e, 'param', name=k).text = json.dumps(v)
            for fname, mdict in entry.get('materials', {}).items():
                ET.SubElement(e, 'material', name=fname).text = \
                    json.dumps(mdict)
            if 'methodKwargs' in entry:
                ET.SubElement(e, 'methodKwargs').text = \
                    json.dumps(entry['methodKwargs'])
        text = minidom.parseString(ET.tostring(root)).toprettyxml(
            indent=' ')
        return _write(fileName, text)

    @classmethod
    def load_from_xml(cls, fileName_or_text, materials=None, dtype=None,
                      device=None):
        """The beamline of an XML layout (see :meth:`export_to_xml`);
        *materials* maps element names to materials that replace theirs,
        *dtype* and *device* go to the sources and materials."""
        import xml.etree.ElementTree as ET
        if isinstance(fileName_or_text, str) and \
                fileName_or_text.lstrip().startswith('<'):
            root = ET.fromstring(fileName_or_text)
        else:
            root = ET.parse(fileName_or_text).getroot()
        bl = cls(azimuth=float(root.get('azimuth', 0.0)),
                 height=float(root.get('height', 0.0)),
                 alignE=float(root.get('alignE', 9000.0)),
                 name=root.get('name', ''))
        for e in root.findall('element'):
            mk = e.findtext('methodKwargs')
            bl._add_entry(dict(
                name=e.get('name'), kind=e.get('kind'),
                method=e.get('method'), module=e.get('module'),
                **{'class': e.get('class')},
                params={p.get('name'): json.loads(p.text)
                        for p in e.findall('param')},
                materials={m.get('name'): json.loads(m.text)
                           for m in e.findall('material')},
                methodKwargs=json.loads(mk) if mk else {}),
                materials, dtype, device)
        return bl

    def export_to_json(self, fileName=None):
        """The JSON layout: the beamline's parameters, the placement
        axis's state (a reloaded layout places and removes as the
        original does) and each flow step's element: class, module,
        creation parameters, materials and method keyword arguments."""
        def pairs(states):
            return {nm: [[float(v) for v in p], [float(v) for v in d]]
                    for nm, (p, d) in states.items()}
        layout = {'name': self.name, 'azimuth': self.azimuth,
                  'height': self.height, 'alignE': self.alignE,
                  'axis': {'point': [float(v) for v in self._axis_point],
                           'dir': [float(v) for v in self._axis_dir],
                           'before': pairs(self._axis_before),
                           'after': pairs(self._axis_after)},
                  'elements': self._layout_entries()}
        return _write(fileName, json.dumps(layout, indent=1))

    @classmethod
    def load_from_json(cls, fileName_or_text, materials=None, dtype=None,
                       device=None):
        """The beamline of a JSON layout (see :meth:`export_to_json`);
        *materials* maps element names to materials that replace theirs
        (a voxel volume has no layout form), *dtype* and *device* go to
        the sources and materials."""
        if isinstance(fileName_or_text, str) and \
                fileName_or_text.lstrip().startswith('{'):
            layout = json.loads(fileName_or_text)
        else:
            with open(fileName_or_text) as f:
                layout = json.load(f)
        bl = cls(azimuth=layout.get('azimuth', 0.0),
                 height=layout.get('height', 0.0),
                 alignE=layout.get('alignE', 9000.0),
                 name=layout.get('name', ''))
        for entry in layout['elements']:
            bl._add_entry(entry, materials, dtype, device)
        axis = layout.get('axis')
        if axis:
            def states(d):
                return {nm: (np.asarray(p, float), np.asarray(v, float))
                        for nm, (p, v) in d.items()}
            bl._axis_point = np.asarray(axis['point'], float)
            bl._axis_dir = np.asarray(axis['dir'], float)
            bl._axis_before = states(axis.get('before', {}))
            if axis.get('after'):
                bl._axis_after = states(axis['after'])
        return bl

    def _layout_entries(self):
        """Each flow step's layout entry."""
        entries = []
        for name, kind, method, kwargs in self.flow:
            el = self._elements[name]
            entry = {'name': name, 'kind': kind, 'method': method,
                     'class': type(el).__name__,
                     'module': type(el).__module__,
                     'params': _element_params(el)}
            if kwargs:
                entry['methodKwargs'] = {
                    k: v for k, v in kwargs.items()
                    if isinstance(v, (str, int, float, bool))}
            mats = _element_materials(el)
            if mats:
                entry['materials'] = mats
            entries.append(entry)
        return entries

    def _add_entry(self, entry, materials, dtype, device):
        """Build a layout entry's element and add it."""
        from .materials.serialize import material_from_dict
        ecls = getattr(_layout_module(entry['module']), entry['class'])
        params = dict(entry['params'])
        for fname, mdict in (entry.get('materials') or {}).items():
            params[fname] = material_from_dict(mdict, dtype, device)
        if materials and entry['name'] in materials:
            params['material'] = materials[entry['name']]
        accepted = _create_signature_names(ecls)
        params.update({k: v for k, v in (('dtype', dtype),
                                          ('device', device))
                       if k in accepted})
        el = ecls.create(**params) if hasattr(ecls, 'create') \
            else ecls(**params)
        self.add(entry['name'], el, kind=entry['kind'],
                 method=entry['method'],
                 **(entry.get('methodKwargs') or {}))


def _write(fileName, text):
    if fileName:
        with open(fileName, 'w') as f:
            f.write(text)
    return text


def _layout_module(name):
    """The module a layout names, resolved inside this package: the path
    below the writer's top-level package name is imported relative to
    this package's own top level."""
    top = __name__.split('.')[0]
    parts = name.split('.', 1)
    if len(parts) == 1:
        return importlib.import_module(top)
    return importlib.import_module('.' + parts[1], top)


def _fields(obj):
    """An element's or material's fields: its attributes, in the order
    its constructor sets them, less the dtype and device it runs in (a
    layout names no device)."""
    return [k for k in vars(obj) if k not in ('dtype', 'device')]


def _create_signature_names(cls):
    """The parameter names ``create()`` accepts across the MRO (a
    subclass's create forwards its keyword arguments to its parents'); a
    factory function's own, and the constructor's where no class defines
    create."""
    names = set()

    def take(fn):
        for p in inspect.signature(fn).parameters.values():
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
                names.add(p.name)
    if not hasattr(cls, '__mro__'):
        take(cls)
        names.discard('kwargs')
        return names
    for c in cls.__mro__:
        fn = c.__dict__.get('create')
        if fn is not None:
            take(getattr(fn, '__func__', fn))
    names.discard('cls')
    names.discard('kwargs')
    if not names:
        take(cls.__init__)
        names.discard('self')
    return names


def _element_params(el):
    """The JSON-safe creation parameters of an element: the fields whose
    (renamed) names ``create()`` accepts, overlaid with the element's
    ``createArgs`` (the arguments of a class whose fields derive from
    them, the parametric conics) and its ``_export_params`` hook (drop,
    extra): composite parameters such as an aperture's opening."""
    cls = type(el)
    accepted = _create_signature_names(cls)
    out = {}
    for fname in _fields(el):
        val = getattr(el, fname)
        if val is None or fname in ('material', 'material2',
                                    'figure_error', 'createArgs'):
            continue
        cname = _RENAMES.get(fname, fname)
        if cname not in accepted:
            continue
        if hasattr(val, 'tolist'):
            out[cname] = val.tolist()
        elif isinstance(val, (int, float, str, bool, tuple, list)):
            out[cname] = list(val) if isinstance(val, tuple) else val
    ca = getattr(el, 'createArgs', None)
    if ca:
        out.update(dict(ca))
    hook = getattr(el, '_export_params', None)
    if hook is not None:
        drop, extra = hook()
        for k in drop:
            out.pop(k, None)
        out.update(extra)
    return out


def _element_materials(el):
    """The material-valued fields of an element as dictionaries
    (``materials.serialize``); a material without one (a voxel volume) is
    left out: pass it by ``materials=`` on load."""
    from .materials import EmptyMaterial, Material, Multilayer
    from .materials.serialize import material_to_dict
    out = {}
    for fname in _fields(el):
        val = getattr(el, fname)
        if isinstance(val, (Material, EmptyMaterial, Multilayer)):
            try:
                out[fname] = material_to_dict(val)
            except ValueError:
                pass
    return out


#: fields stored under another name than create() takes
_RENAMES = {'bragg_': 'bragg', 'braggAngle': 'bragg', 'E0': 'E',
            'theta_c': 'theta', 'b_': 'b', 'ex': 'x', 'ez': 'z',
            'f2Virtual': 'f2isVirtual'}
