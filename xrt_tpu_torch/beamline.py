"""BeamLine: a host-side container of beamline elements that places them
along the optical axis.

Port of the core of the reference package's ``beamline.py``: the element
registry (``add``, ``__getitem__``), the default flow it records, and
``place``, which builds an element on the current optical axis: its centre
at a distance along the axis, its pitch from a crystal's Bragg angle at
``alignE`` ('auto'), the extra angles that turn its frame into a deflected
beam's frame (``_axis_extra_angles``), the axis deflected by a mirror and
moved by a fixed-exit monochromator's offset.  All of it is host float64
numpy, as in the reference; the elements it builds run on their own
device.

Running the flow (``propagate_flow``), the 3D view (``glow``), alarms, XML
and JSON layouts and ``remove`` / ``reorder`` / ``update`` come with
ROADMAP A11 and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from . import config
from .transforms import rotate_xyz

_A11 = ('is not ported yet: ROADMAP A11 (the host-side layers: flows, '
        'views, layouts)')


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
        self._elements: Dict[str, Any] = {}
        # the optical axis of the placement: a point and a direction, and
        # its state after each element (a branch resumes from it)
        self._axis_point = np.zeros(3)
        self._axis_dir = np.array([0.0, 1.0, 0.0])
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
            if hasattr(element, 'double_reflect'):
                method = 'double_reflect'
        self.flow.append((name, kind, method, methodKwargs))
        return element

    def __getitem__(self, name):
        return self._elements[name]

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
        element = element_cls.create(center=tuple(center), **kwargs)
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
    def remove(self, name):
        raise NotImplementedError(f'BeamLine.remove {_A11}')

    def reorder(self, names):
        raise NotImplementedError(f'BeamLine.reorder {_A11}')

    def update(self, name, element):
        raise NotImplementedError(f'BeamLine.update {_A11}')

    def propagate_flow(self, *args, **kwargs):
        raise NotImplementedError(f'BeamLine.propagate_flow {_A11}')

    def glow(self, *args, **kwargs):
        raise NotImplementedError(f'BeamLine.glow {_A11}')

    def check_alarms(self, *args, **kwargs):
        raise NotImplementedError(f'BeamLine.check_alarms {_A11}')

    def export_to_xml(self, *args, **kwargs):
        raise NotImplementedError(f'BeamLine.export_to_xml {_A11}')

    def export_to_json(self, *args, **kwargs):
        raise NotImplementedError(f'BeamLine.export_to_json {_A11}')

    @classmethod
    def load_from_xml(cls, *args, **kwargs):
        raise NotImplementedError(f'BeamLine.load_from_xml {_A11}')

    @classmethod
    def load_from_json(cls, *args, **kwargs):
        raise NotImplementedError(f'BeamLine.load_from_json {_A11}')
