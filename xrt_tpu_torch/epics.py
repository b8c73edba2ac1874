"""EPICS process-variable layer: PV schema, Phoebus screens, optional IOC.

Port of the reference package's ``epics.py``.  The reference xrt exposes
a live beamline through ``softioc``
(xrt/backends/raycing/epics/device.py:161+): every element parameter
becomes a PV (schema generated per element category,
epics/records.py:49-279), histograms are published as waveform records,
and Phoebus Display Builder ``.bob`` screens are generated for each
element category (epics/generate_bob.py).

This module provides the same capability for the port's beamlines:

- :func:`element_records` / :func:`iter_element_specs`: the PV schema.
  PV record names use the ``element:field`` addressing that
  :class:`xrt_tpu_torch.server.BeamLineServer` serves over TCP, so a thin
  CA gateway (or the optional IOC below) maps 1:1.  The records follow
  the reference's field order (:data:`FIELD_ORDER`), so both packages
  write the same screens.
- :class:`BobWriter`: dependency-free Phoebus ``.bob`` XML generation.
- :class:`EpicsIOC`: a softioc-backed IOC when the ``softioc`` package is
  installed (the TCP server is the always-available fallback).  Writing a
  parameter PV replaces the element's field by a value in the form of the
  one it replaces (a tensor of its dtype on its device, a tuple or a
  number) and, with AutoUpdate on, runs the trace function, publishing
  its flux readbacks and histogram waveforms.  Only the scalars and the
  images the trace function returns are copied to the host.
"""
from __future__ import annotations

import dataclasses
import os
import re
import xml.etree.ElementTree as ET
from typing import Any, Dict, Iterable, List
from xml.dom import minidom

import numpy as np
import torch

from . import units

#: parameters exposed as orientation PVs (reference _sets_units.py:12-14)
ORIENTATION_FIELDS = ('center', 'pitch', 'roll', 'yaw', 'bragg_',
                      'braggAngle', 'positionRoll', 'ex', 'ez')
#: parameters exposed as shape PVs (reference _sets_units.py:16-21)
SHAPE_FIELDS = ('limPhysX', 'limPhysY', 'limPhysX2', 'limPhysY2',
                'left', 'right', 'bottom', 'top', 'shadeLeft',
                'shadeRight', 'vertices', 'r', 'R', 'Rm', 'Rs',
                'ellipseA', 'ellipseB', 'parabParam', 'hyperbolaA',
                'hyperbolaB', 'workingDistance', 'f1', 'f2', 'rho',
                'focus', 'zmax', 't', 'dx', 'dz', 'px', 'pz')
SOURCE_FIELDS = ('nrays', 'eE', 'eI', 'eEspread', 'dxprime', 'dzprime',
                 'Kx', 'Ky', 'L0', 'n', 'eMin', 'eMax', 'xPrimeMax',
                 'zPrimeMax', 'w0', 'B0', 'K')

#: the reference's field order of the classes whose constructors set their
#: fields in another order (``nrays`` after the shape and angles of a
#: geometric source, and so on); a class not listed keeps its own order.
#: A class's fields that are not listed follow in their own order.
FIELD_ORDER = {
    'GeometricSource': (
        'center', 'dx', 'dy', 'dz', 'dxprime', 'dzprime', 'energies',
        'energyWeights', 'pitch', 'roll', 'yaw', 'nrays'),
}


def to_valid_var_name(name, default='unnamed'):
    """EPICS-safe record name (reference epics/device.py:13-27)."""
    name = str(name) or default
    name = re.sub(r'[^0-9a-zA-Z_:]', '_', name)
    if name[0].isdigit():
        name = '_' + name
    return name


@dataclasses.dataclass(frozen=True)
class PvSpec:
    """One EPICS-visible process variable (reference records.py:17-29)."""
    record: str
    label: str
    property_path: str
    kind: str                      # number | string | waveform | bool_*
    access: str = 'rw'
    initial_value: Any = None
    group: str = 'Properties'
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ElementSpec:
    name: str
    valid_name: str
    class_name: str
    category: str
    pvs: List[PvSpec]


def workflow_records() -> List[PvSpec]:
    """Beamline workflow records, always present
    (reference records.py:49-62)."""
    return [
        PvSpec('Acquire', 'Acquire', 'Acquire', 'bool_command', 'rw', 0,
               'Propagation'),
        PvSpec('AcquireStatus', 'Acquire status', 'AcquireStatus',
               'bool_status', 'ro', 0, 'Propagation'),
        PvSpec('AutoUpdate', 'Auto update', 'AutoUpdate', 'bool_toggle',
               'rw', 1, 'Propagation'),
    ]


def _group_of(fname):
    if fname in ORIENTATION_FIELDS:
        return 'Orientation'
    if fname in SHAPE_FIELDS:
        return 'Shape'
    return 'Properties'


def _ordered_fields(element):
    """The element's fields (:func:`xrt_tpu_torch.beamline._fields`) in
    the reference's order (:data:`FIELD_ORDER`)."""
    from .beamline import _fields
    fields = _fields(element)
    first = [f for f in FIELD_ORDER.get(type(element).__name__, ())
             if f in fields]
    return first + [f for f in fields if f not in first]


def element_records(name: str, element: Any) -> List[PvSpec]:
    """The PVs exposed for one element: every scalar numeric field (the
    tunables the server's ``set`` accepts), 3-vectors split into
    components, plus name/image records (reference records.py:66-133).
    Tensor fields are read on the host, a number each."""
    from .server import _host
    oename = to_valid_var_name(name)
    pvs: List[PvSpec] = [
        PvSpec(f'{oename}:name', 'Name', 'name', 'string', 'ro',
               getattr(element, 'name', name)),
        PvSpec(f'{oename}:flux', 'Flux readback', 'flux', 'number', 'ro',
               0.0, 'Readbacks'),
        PvSpec(f'{oename}:image', 'Footprint image', 'image', 'waveform',
               'ro', None, 'Readbacks',
               {'shape': 'flattened (ybins, xbins) histogram'}),
    ]
    for fname in _ordered_fields(element):
        if fname in ('material', 'material2', 'figure_error',
                     'createArgs'):
            continue
        v = getattr(element, fname, None)
        if v is None or isinstance(v, (str, bool, dict)):
            continue
        if not isinstance(v, (torch.Tensor, np.ndarray, int, float, list,
                              tuple)):
            continue
        arr = _host(v)
        if not np.issubdtype(arr.dtype, np.number):
            continue
        group = _group_of(fname)
        egu = units.unit_of(fname)
        meta = {'egu': egu} if egu else {}
        if arr.ndim == 0:
            pvs.append(PvSpec(f'{oename}:{fname}', fname, fname, 'number',
                              'rw', float(arr), group, dict(meta)))
        elif arr.ndim == 1 and fname == 'center':
            for i, comp in enumerate('xyz'):
                pvs.append(PvSpec(f'{oename}:center:{comp}',
                                  f'Center {comp}', f'center.{comp}',
                                  'number', 'rw', float(arr[i]),
                                  'Orientation', {'egu': 'mm'}))
        elif arr.ndim == 1 and arr.size == 2 and fname.startswith('lim'):
            for i, comp in enumerate(('lmin', 'lmax')):
                pvs.append(PvSpec(f'{oename}:{fname}:{comp}',
                                  f'{fname} {comp}', f'{fname}.{comp}',
                                  'number', 'rw', float(arr[i]), 'Shape',
                                  dict(meta)))
    return pvs


def categorize_element(element: Any) -> str:
    """BOB output folder (reference records.py:156-180)."""
    if hasattr(element, 'shine'):
        return 'sources'
    if hasattr(element, 'expose'):
        return 'screens'
    if hasattr(element, 'propagate') and not hasattr(element, 'reflect'):
        return 'apertures'
    return 'oes'


def iter_element_specs(bl) -> Iterable[ElementSpec]:
    """Element specs for a BeamLine (or a {name: element} dict)."""
    items = bl._elements.items() if hasattr(bl, '_elements') \
        else dict(bl).items()
    for name, el in items:
        yield ElementSpec(
            name=name, valid_name=to_valid_var_name(name),
            class_name=f'{type(el).__module__}.{type(el).__name__}',
            category=categorize_element(el),
            pvs=element_records(name, el))


# ---------------------------------------------------------------------------
# Phoebus .bob screens
# ---------------------------------------------------------------------------

_ROW_H, _LBL_W, _VAL_W, _MARGIN = 24, 180, 180, 10


class BobWriter:
    """Phoebus Display Builder screens from PV specs, XML-only (the
    reference uses phoebusgen when importable, plain XML otherwise,
    generate_bob.py:33-203)."""

    def write(self, file_name, title: str, pvs: List[PvSpec],
              prefix_macro: str = '$(P)'):
        root = ET.Element('display', version='2.0.0')
        ET.SubElement(root, 'name').text = title
        ET.SubElement(root, 'width').text = str(
            2 * _MARGIN + _LBL_W + _VAL_W)
        ET.SubElement(root, 'height').text = str(
            2 * _MARGIN + _ROW_H * (len(pvs) + 2))
        y = _MARGIN
        group = None
        for pv in pvs:
            if pv.group != group:
                group = pv.group
                lab = ET.SubElement(root, 'widget', type='label',
                                    version='2.0.0')
                ET.SubElement(lab, 'name').text = f'grp_{group}'
                ET.SubElement(lab, 'text').text = group
                self._geom(lab, _MARGIN, y, _LBL_W + _VAL_W, _ROW_H)
                y += _ROW_H
            lab = ET.SubElement(root, 'widget', type='label',
                                version='2.0.0')
            ET.SubElement(lab, 'name').text = f'lbl_{pv.record}'
            ET.SubElement(lab, 'text').text = pv.label
            self._geom(lab, _MARGIN, y, _LBL_W, _ROW_H)
            wtype = 'textupdate' if pv.access == 'ro' else 'textentry'
            if pv.kind.startswith('bool') and pv.access == 'rw':
                wtype = 'action_button' if pv.kind == 'bool_command' \
                    else 'checkbox'
            w = ET.SubElement(root, 'widget', type=wtype, version='2.0.0')
            ET.SubElement(w, 'name').text = pv.record
            ET.SubElement(w, 'pv_name').text = f'{prefix_macro}{pv.record}'
            self._geom(w, _MARGIN + _LBL_W, y, _VAL_W, _ROW_H)
            y += _ROW_H
        text = minidom.parseString(
            ET.tostring(root)).toprettyxml(indent='  ')
        with open(file_name, 'w') as f:
            f.write(text)
        return file_name

    @staticmethod
    def _geom(widget, x, y, w, h):
        ET.SubElement(widget, 'x').text = str(x)
        ET.SubElement(widget, 'y').text = str(y)
        ET.SubElement(widget, 'width').text = str(w)
        ET.SubElement(widget, 'height').text = str(h)


def generate_bob_screens(bl, output_dir, prefix_macro='$(P)'):
    """One .bob per element (grouped in per-category folders) plus the
    workflow screen: the analog of epics/generate_bob.py.  Returns the
    list of written files."""
    writer = BobWriter()
    written = []
    for spec in iter_element_specs(bl):
        d = os.path.join(output_dir, spec.category)
        os.makedirs(d, exist_ok=True)
        fn = os.path.join(d, f'{spec.valid_name}.bob')
        writer.write(fn, f'{spec.name} ({spec.class_name})', spec.pvs,
                     prefix_macro)
        written.append(fn)
    fn = os.path.join(output_dir, 'workflow.bob')
    writer.write(fn, 'Beamline workflow', workflow_records(), prefix_macro)
    written.append(fn)
    return written


# ---------------------------------------------------------------------------
# optional softioc-backed IOC
# ---------------------------------------------------------------------------

def _component_value(cur, idx, value):
    """The vector parameter *cur* (a tensor or a tuple) with component
    *idx* set to *value*: a tensor stays a tensor of its dtype on its
    device."""
    if isinstance(cur, torch.Tensor):
        new = cur.detach().clone()
        new[idx] = float(value)
        return new
    vals = list(cur)
    vals[idx] = float(value)
    return tuple(vals) if isinstance(cur, tuple) else vals


class EpicsIOC:
    """An EPICS IOC over the beamline, when ``softioc`` is installed.

    Builds one record per :func:`element_records` PV: ``ao`` for writable
    numbers (with an on-write callback that replaces the element field and
    runs the trace function, like the TCP server's ``set``),
    ``ai``/``stringin`` for readbacks, ``WaveformIn`` for histogram images,
    and the Acquire/AutoUpdate workflow records.  *trace_fn(bl)* returns
    ``{element name: {'flux': number, 'image': array or tensor}}``; an
    image tensor is copied to the host as float32.  The fallback without
    softioc is :class:`xrt_tpu_torch.server.BeamLineServer` (same
    addressing)."""

    def __init__(self, bl, prefix='XRT:', trace_fn=None):
        try:
            from softioc import builder, softioc  # noqa
        except ImportError as e:
            raise ImportError(
                'softioc is not installed; use xrt_tpu_torch.server.'
                'BeamLineServer (TCP JSON lines) which serves the same '
                'element:field parameters, or install softioc for real '
                'PVs') from e
        self._builder = builder
        self._softioc = softioc
        self.bl = bl
        self.trace_fn = trace_fn
        self.records = {}
        builder.SetDeviceName(prefix.rstrip(':'))
        for spec in iter_element_specs(bl):
            for pv in spec.pvs:
                self._make_record(spec, pv)
        for pv in workflow_records():
            if pv.kind == 'bool_command':
                self.records[pv.record] = builder.boolOut(
                    pv.record, on_update=lambda v: self._acquire())
            elif pv.access == 'ro':
                self.records[pv.record] = builder.boolIn(pv.record)
            else:
                self.records[pv.record] = builder.boolOut(
                    pv.record, initial_value=bool(pv.initial_value))
        builder.LoadDatabase()

    def _make_record(self, spec, pv):
        b = self._builder
        if pv.kind == 'waveform':
            self.records[pv.record] = b.WaveformIn(
                pv.record, initial_value=np.zeros(128 * 128, np.float32))
        elif pv.kind == 'string':
            self.records[pv.record] = b.stringIn(
                pv.record, initial_value=str(pv.initial_value))
        elif pv.access == 'ro':
            self.records[pv.record] = b.aIn(
                pv.record, initial_value=float(pv.initial_value or 0.0))
        else:
            def on_update(value, name=spec.name, path=pv.property_path):
                self._set(name, path, value)
            self.records[pv.record] = b.aOut(
                pv.record, initial_value=float(pv.initial_value or 0.0),
                on_update=on_update)

    def _set(self, elname, path, value):
        from .server import _value_like
        el = self.bl[elname]
        if '.' in path:     # center.x / limPhysX.lmin
            fname, comp = path.split('.')
            idx = {'x': 0, 'y': 1, 'z': 2, 'lmin': 0, 'lmax': 1}[comp]
            el = el.replace(**{fname: _component_value(
                getattr(el, fname), idx, value)})
        else:
            el = el.replace(**{path: _value_like(getattr(el, path),
                                                 value)})
        self.bl.update(elname, el)
        auto = self.records.get('AutoUpdate')
        if auto is None or auto.get():
            self._acquire()

    def _acquire(self):
        if self.trace_fn is None:
            return
        st = self.records.get('AcquireStatus')
        if st is not None:
            st.set(1)
        try:
            results = self.trace_fn(self.bl)
            for name, data in (results or {}).items():
                rec = self.records.get(f'{to_valid_var_name(name)}:flux')
                if rec is not None and 'flux' in data:
                    rec.set(float(data['flux']))
                img = self.records.get(f'{to_valid_var_name(name)}:image')
                if img is not None and 'image' in data:
                    im = data['image']
                    if isinstance(im, torch.Tensor):
                        im = im.detach().float().cpu().numpy()
                    img.set(np.asarray(im, np.float32).ravel())
        finally:
            if st is not None:
                st.set(0)

    def run(self):
        """Start cothread dispatching and interactive IOC shell."""
        from softioc import softioc
        import cothread
        self._softioc.iocInit()
        softioc.interactive_ioc(globals())
        cothread.WaitForQuit()
