"""Automatic flow capture and restart-from-element replay.

Port of the reference package's ``flow.py``.  The reference xrt records
every ``shine``/``reflect``/``propagate``/``expose`` call transparently
through a decorator on the propagation methods
(xrt/backends/raycing/_flow_utils.py:157-211, ``append_to_flow_decorator``)
and re-runs the flow from a modified element on
(xrt/backends/raycing/_flow.py:13, ``propagationProcess``).

Here a recorded step ``(element, method, args, kwargs) -> outputs`` can be
replayed with any element swapped for a ``replace`` copy (the port's
elements are ``config.Replaceable``, and a ``BeamLine`` takes the copy by
``update``): the steps are rerun from the first one whose element or
inputs changed, with the recorded upstream outputs reused.  A
``torch.Generator`` argument is stateful, so each step also records the
state of every generator it was given, and a rerun step draws from a
fresh generator set to that state: a replay is bitwise identical to a full
re-trace with the same draws.

Usage::

    with record_flow(bl) as flow:      # bl optional, provides names
        run_process(bl, generator)     # ANY user code calling the methods

    flow.steps                         # what was captured
    out = flow.replay()                                  # from the cache
    out = flow.replay(replace={'m1': new_mirror})        # from m1 onward
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

#: (module path, class name, method names) — every defining class gets its
#: own wrap so subclass overrides are captured too
_REGISTRY = [
    ('.sources.geometric', 'GeometricSource', ('shine',)),
    ('.sources.gaussian', 'GaussianBeam', ('shine',)),
    ('.sources.gaussian', 'MeshSource', ('shine',)),
    ('.sources.gaussian', 'CollimatedMeshSource', ('shine',)),
    ('.sources.synchrotron', '_SynchrotronBase', ('shine',)),
    ('.sources.undulator', 'Undulator', ('shine', 'shine_wave')),
    ('.oes.base', 'OE', ('reflect', 'multiple_reflect', 'propagate_wave')),
    ('.oes.dcm', 'DCM', ('double_reflect',)),
    ('.oes.refractive', 'Plate', ('double_refract',)),
    ('.apertures', '_ApertureBase', ('propagate', '_to_global')),
    ('.screens', 'Screen', ('expose', 'expose_global')),
]

#: module-level helper functions that derive beams from beams: tracked
#: too, or the dataflow chain breaks across them (an aperture's local beam
#: goes back to global through ``_ApertureBase._to_global``, above, between
#: ``propagate()`` and ``expose()`` in ``propagate_flow``)
_FUNC_REGISTRY = [
    ('.waves', 'wave_to_global'),
]

_STACK: List['Flow'] = []
_instrumented = False


def _wrap(cls, mname):
    orig = cls.__dict__.get(mname)
    if orig is None or getattr(orig, '_flow_wrapped', False):
        return
    import functools

    @functools.wraps(orig)
    def wrapper(self, *args, **kwargs):
        states = _generator_states(args, kwargs) if _STACK else None
        out = orig(self, *args, **kwargs)
        if _STACK:
            _STACK[-1]._record(self, mname, args, kwargs, out, states)
        return out

    wrapper._flow_wrapped = True
    setattr(cls, mname, wrapper)


def _wrap_func(mod, fname):
    orig = getattr(mod, fname, None)
    if orig is None or getattr(orig, '_flow_wrapped', False):
        return
    import functools

    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        states = _generator_states(args, kwargs) if _STACK else None
        out = orig(*args, **kwargs)
        if _STACK:
            _STACK[-1]._record_func(orig, args, kwargs, out, states)
        return out

    wrapper._flow_wrapped = True
    setattr(mod, fname, wrapper)


def _generator_states(args, kwargs):
    """{position: (device, state)} of the generators among a call's
    arguments, taken before the call draws from them."""
    out = {}
    for i, a in enumerate(args):
        if isinstance(a, torch.Generator):
            out[i] = (a.device, a.get_state())
    for k, a in kwargs.items():
        if isinstance(a, torch.Generator):
            out[k] = (a.device, a.get_state())
    return out


def _fresh(device, state):
    g = torch.Generator(device)
    g.set_state(state)
    return g


def instrument():
    """Install the capture wrappers (idempotent, done lazily on the first
    :func:`record_flow`)."""
    global _instrumented
    if _instrumented:
        return
    import importlib
    for modpath, clsname, methods in _REGISTRY:
        mod = importlib.import_module(modpath, __package__)
        cls = getattr(mod, clsname, None)
        if cls is None:
            continue
        for m in methods:
            _wrap(cls, m)
    for modpath, fname in _FUNC_REGISTRY:
        mod = importlib.import_module(modpath, __package__)
        _wrap_func(mod, fname)
    _instrumented = True


@dataclass
class FlowStep:
    name: str
    element: Any
    method: str
    args: tuple
    kwargs: dict
    out: Any
    #: {argument position or keyword: (device, state)} of its generators
    rng: dict = field(default_factory=dict)

    def __repr__(self):
        return f'FlowStep({self.name}.{self.method})'


class Flow:
    """A recorded propagation flow (see module doc)."""

    def __init__(self, bl=None):
        self._names = {}
        if bl is not None:
            for name, el in getattr(bl, '_elements', {}).items():
                self._names[id(el)] = name
        self.steps: List[FlowStep] = []
        self._counter = itertools.count()
        self._recording = False

    # -- recording ------------------------------------------------------
    def __enter__(self):
        instrument()
        _STACK.append(self)
        self._recording = True
        return self

    def __exit__(self, *exc):
        _STACK.remove(self)
        self._recording = False
        return False

    def _name_of(self, element):
        nm = self._names.get(id(element))
        if nm is None:
            nm = f'{type(element).__name__}_{next(self._counter)}'
            self._names[id(element)] = nm
        return nm

    def _record(self, element, method, args, kwargs, out, rng):
        self.steps.append(FlowStep(self._name_of(element), element,
                                   method, args, kwargs, out, rng))

    def _record_func(self, fn, args, kwargs, out, rng):
        # a derived-beam helper: replayed by calling the function itself;
        # method=None marks it (names are '~'-prefixed, never replaceable)
        self.steps.append(FlowStep(f'~{fn.__name__}', fn, None, args,
                                   kwargs, out, rng))

    # -- introspection ---------------------------------------------------
    @property
    def beams(self) -> Dict[str, Any]:
        """Recorded outputs keyed ``name.method`` (last call wins)."""
        return {(s.name if s.method is None else f'{s.name}.{s.method}'):
                s.out for s in self.steps}

    def index_of(self, name) -> int:
        for i, s in enumerate(self.steps):
            if s.name == name:
                return i
        raise KeyError(f'no recorded step for element {name!r}')

    # -- replay -----------------------------------------------------------
    def replay(self, replace: Optional[Dict[str, Any]] = None,
               startFrom='auto') -> Dict[str, Any]:
        """Re-run the flow and return ``{name.method: outputs}``.

        *replace* maps element names to modified elements; *startFrom* is
        an element name, a step index, or 'auto' (= the earliest replaced
        element).  Steps before the start return their cached outputs;
        steps after run live, with any beam argument that was produced by
        an earlier step substituted by that step's replayed value, and
        every generator argument by a fresh one in the state it had when
        the step was recorded: bitwise identical to a full re-trace with
        the same draws.
        """
        replace = replace or {}
        unknown = set(replace) - {s.name for s in self.steps}
        if unknown:
            raise KeyError(f'replace names not in flow: {sorted(unknown)}')
        if startFrom == 'auto':
            # nothing forced: dataflow dirtiness decides — only the steps
            # reachable from a replaced element re-run (with no replace
            # this replays everything from the cache)
            start = len(self.steps) if replace else 0
        elif isinstance(startFrom, str):
            start = self.index_of(startFrom)
        else:
            start = int(startFrom)

        # map object ids of recorded outputs -> (step index, position)
        produced: Dict[int, Tuple[int, Optional[int]]] = {}
        for i, s in enumerate(self.steps):
            if isinstance(s.out, tuple):
                for j, o in enumerate(s.out):
                    produced[id(o)] = (i, j)
            else:
                produced[id(s.out)] = (i, None)
        # replaced element objects, for element args inside derived helpers
        el_map: Dict[int, Any] = {}
        for s in self.steps:
            if s.name in replace:
                el_map[id(s.element)] = replace[s.name]

        new_out: List[Any] = []
        results: Dict[str, Any] = {}

        def resolve(v):
            hit = produced.get(id(v))
            if hit is not None:
                i, j = hit
                o = new_out[i]
                return o if j is None else o[j]
            return el_map.get(id(v), v)

        def inputs_dirty(s):
            """True when any beam/element argument of *s* resolves to a
            value different from the recorded one."""
            for a in list(s.args) + list(s.kwargs.values()):
                if resolve(a) is not a:
                    return True
            return False

        for i, s in enumerate(self.steps):
            rerun = i >= start or s.name in replace or inputs_dirty(s)
            if not rerun:
                new_out.append(s.out)
            else:
                args = [resolve(a) for a in s.args]
                kwargs = {k: resolve(v) for k, v in s.kwargs.items()}
                for pos, (dev, state) in s.rng.items():
                    if isinstance(pos, int):
                        args[pos] = _fresh(dev, state)
                    else:
                        kwargs[pos] = _fresh(dev, state)
                if s.method is None:      # derived-beam helper function
                    new_out.append(s.element(*args, **kwargs))
                else:
                    el = replace.get(s.name, s.element)
                    new_out.append(getattr(el, s.method)(*args, **kwargs))
            key = s.name if s.method is None else f'{s.name}.{s.method}'
            results[key] = new_out[-1]
        return results


def record_flow(bl=None) -> Flow:
    """Context manager capturing every propagation-method call into a
    :class:`Flow` (cf. reference xrt's append_to_flow_decorator,
    _flow_utils.py:185)."""
    return Flow(bl)
