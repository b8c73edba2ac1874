"""Named stages: wall time and call counts in a registry, with nesting, a
one-line-per-stage report and a context / decorator API; while tracing,
spans and counters on the device trace's clock.

Port of the reference package's ``profiler.py``.  PyTorch returns before
the card finishes, so a stage that ends without waiting measures the
launches only.  A stage asked to block (``block=`` a CUDA tensor, a tuple,
list or dict of them, or a device) records CUDA events at its start and
end and ends in ``torch.cuda.synchronize(device)``: its host time then
covers the device's work, and its device time (``device_total``, the
events' elapsed time read after the synchronize) is reported beside it.
The decorator form blocks on the function's return value.

**Tracing.**  Tracing is on while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``) or inside :func:`tracing`
(``run_ray_tracing(verbose=True)`` enters it).  While it is on, every
stage, blocking or not, also

* opens a ``torch.profiler.record_function`` under its own short name, so
  that it lands in the profiler's trace beside the kernels it launched,
  and
* appends a :class:`Span` to the registry: its id, name, parent id (the
  innermost span open around it), the pass id (:func:`next_pass`, which
  ``run_ray_tracing`` advances once an iteration, so that the spans and
  counters of one pass share it), host start and end
  (``time.perf_counter_ns``), ``ok`` (false when the stage exits on an
  exception) and, for a stage given ``device=`` (a tensor or a device),
  its device time (:attr:`Span.device_ns`): on the CPU its host time; on
  a card the elapsed time between the stage's start and end CUDA events,
  recorded on the current stream with no synchronize.  A stage has one
  such pair, shared with ``block=``'s device total.  Once a blocking
  stage on that card has synchronized, the registry reads the times of
  the spans closed before it and lets their events go; a span read
  before that needs its caller to synchronize first.

:func:`count` adds to a named counter of the current pass, while tracing
is on only.  :func:`spans` and :func:`counters` return the records;
:func:`reset` clears them with the aggregates.  The records grow with
every traced stage until then, so a caller that traces for a long time
(a server, a long scan) resets between runs.  With tracing off a stage
costs one check more than its aggregates, and a counter one check: no
event, no host read, no synchronize.

Usage::

    from xrt_tpu_torch.profiler import stage, report, reset

    with stage('shine'):
        beam = src.shine(generator)
    with stage('reflect', block=beam.x.device):
        glo, loc = mirror.reflect(beam, generator=generator)
    print(report())

    with tracing():
        with stage('reflect', device=beam.x):
            count('rays', beam.x.numel())
            glo, loc = mirror.reflect(beam, generator=generator)
    torch.cuda.synchronize()
    for s in spans():
        print(s.name, s.parent, s.pass_id, s.device_ns)
    print(counters())
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from contextlib import ContextDecorator, contextmanager
from typing import Dict

import torch


class StageStats:
    __slots__ = ('calls', 'total', 'best', 'worst', 'device_total')

    def __init__(self):
        self.calls = 0
        self.total = 0.0
        self.best = float('inf')
        self.worst = 0.0
        self.device_total = None

    def add(self, dt, device_dt=None):
        self.calls += 1
        self.total += dt
        self.best = min(self.best, dt)
        self.worst = max(self.worst, dt)
        if device_dt is not None:
            self.device_total = (self.device_total or 0.0) + device_dt


class Span:
    """One stage's record while tracing.  ``id``; ``name``, the stage's
    short name; ``parent``, the id of the innermost span open around it in
    its thread (None at the top); ``pass_id``; ``t0`` and ``t1``, host
    ``time.perf_counter_ns`` at its start and end (``t1`` None while
    open); ``ok``, false when it exited on an exception."""
    __slots__ = ('id', 'name', 'parent', 'pass_id', 't0', 't1', 'ok',
                 '_events', '_ns', '_rf')

    def __init__(self, id, name, parent, pass_id):
        self.id, self.name, self.parent = id, name, parent
        self.pass_id = pass_id
        self.t0 = self.t1 = self.ok = None
        self._events = self._ns = self._rf = None

    @property
    def device_ns(self):
        """The span's device time in ns, or None (no ``device=``, or still
        open): on the CPU its host time, on a card the elapsed time of its
        stage's CUDA events, whose work has to have finished."""
        if self._ns is None and self._events is not None:
            start, end = self._events
            self._ns = round(start.elapsed_time(end) * 1e6)
            self._events = None
        return self._ns

    def __repr__(self):
        return (f'Span({self.id}, {self.name!r}, parent={self.parent}, '
                f'pass_id={self.pass_id}, ok={self.ok})')


def _as_device(device):
    """The torch.device of a tensor, device or device string; a card's
    with its index."""
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def _cuda_event(device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Profiler:
    """A registry of named stage timings, spans and counters."""

    def __init__(self):
        self.stats: Dict[str, StageStats] = {}
        self._local = threading.local()
        self._lock = threading.Lock()
        self._tracing = 0
        self._clear_records()

    def _clear_records(self):
        self._spans = []
        self._counts = {}
        self._pending = []      # (card, span) with unread CUDA events
        self._ids = itertools.count()
        self.pass_id = 0

    @property
    def _stack(self):
        """This thread's open stages: (dotted name, span or None)."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def reset(self):
        self.stats.clear()
        self._stack.clear()
        with self._lock:
            self._clear_records()

    def add(self, name, dt, device_dt=None):
        self.stats.setdefault(name, StageStats()).add(dt, device_dt)

    def stage(self, name, block=None, device=None):
        return _Stage(self, name, block, device)

    # ---- tracing --------------------------------------------------------
    def is_tracing(self):
        """Whether spans and counters are recorded: inside
        :meth:`tracing` or while a ``torch.profiler`` session records."""
        return self._tracing > 0 or torch.autograd._profiler_enabled()

    @contextmanager
    def tracing(self):
        """Record spans and counters inside the block."""
        with self._lock:
            self._tracing += 1
        try:
            yield self
        finally:
            with self._lock:
                self._tracing -= 1

    def next_pass(self):
        """Advance the pass id that new spans and counters take."""
        with self._lock:
            self.pass_id += 1
            return self.pass_id

    def count(self, name, n=1):
        """Add *n* to the counter *name* of the current pass, while
        tracing only."""
        if self.is_tracing():
            key = (self.pass_id, name)
            with self._lock:
                self._counts[key] = self._counts.get(key, 0) + n

    def spans(self):
        """The spans recorded, in the order they opened."""
        return list(self._spans)

    def counters(self):
        """{pass id: {counter name: total}}."""
        out = {}
        with self._lock:
            for (p, name), n in self._counts.items():
                out.setdefault(p, {})[name] = n
        return out

    def _open(self, name, stack):
        parent = next((s.id for _, s in reversed(stack) if s is not None),
                      None)
        span = Span(next(self._ids), name, parent, self.pass_id)
        span._rf = torch.profiler.record_function(name)
        span._rf.__enter__()
        self._spans.append(span)
        span.t0 = time.perf_counter_ns()
        return span

    def _close(self, span, ok, device, events):
        """Close *span*; *device*, its ``device=`` as a torch.device or
        None, and *events*, its stage's (start, end) CUDA events or None,
        give its device time."""
        span.t1 = time.perf_counter_ns()
        span.ok = ok
        if device is not None:
            if events is None:
                span._ns = span.t1 - span.t0
            else:
                span._events = events
                with self._lock:
                    self._pending.append((device, span))
        rf, span._rf = span._rf, None
        rf.__exit__(None, None, None)

    def _settle(self, devices):
        """Read the device times of the closed spans on *devices*, which a
        blocking stage has just synchronized, and let their events go."""
        devices = {_as_device(d) for d in devices}
        with self._lock:
            done = [s for d, s in self._pending if d in devices]
            self._pending = [(d, s) for d, s in self._pending
                             if d not in devices]
        for span in done:
            span.device_ns

    # ---- the aggregates' report -----------------------------------------
    def report(self, sort='total'):
        """Formatted table of all stages (sorted by total time); blocking
        stages on the card add their device time."""
        if not self.stats:
            return '(no stages recorded)'
        rows = sorted(self.stats.items(),
                      key=lambda kv: -getattr(kv[1], sort, kv[1].total))
        w = max(len(k) for k, _ in rows)
        lines = [f'{"stage":<{w}}  {"calls":>6} {"total":>9} {"mean":>9} '
                 f'{"best":>9} {"worst":>9} {"device":>9}']
        for name, s in rows:
            dev = '' if s.device_total is None else \
                f'{s.device_total:>8.3f}s'
            lines.append(
                f'{name:<{w}}  {s.calls:>6} {s.total:>8.3f}s '
                f'{s.total / s.calls:>8.4f}s {s.best:>8.4f}s '
                f'{s.worst:>8.4f}s {dev:>9}')
        return '\n'.join(lines)

    def as_dict(self):
        return {k: {'calls': s.calls, 'total': s.total, 'best': s.best,
                    'worst': s.worst, 'device_total': s.device_total}
                for k, s in self.stats.items()}


def _cuda_devices(block):
    """The CUDA devices of the tensors (or devices) in *block*."""
    if isinstance(block, (list, tuple)):
        return {d for b in block for d in _cuda_devices(b)}
    if isinstance(block, dict):
        return {d for b in block.values() for d in _cuda_devices(b)}
    if isinstance(block, torch.Tensor):
        block = block.device
    if isinstance(block, str):
        block = torch.device(block)
    if isinstance(block, torch.device) and block.type == 'cuda':
        return {block}
    return set()


class _Stage(ContextDecorator):
    def __init__(self, profiler, name, block=None, device=None):
        self.profiler = profiler
        self.name = name
        self.devices = _cuda_devices(block)
        self.device = device

    def __enter__(self):
        # nested stages get dotted names: 'trace.reflect'
        stack = self.profiler._stack
        self.full = f'{stack[-1][0]}.{self.name}' if stack else self.name
        self.span = self.span_dev = None
        if self.profiler.is_tracing():
            self.span = self.profiler._open(self.name, stack)
            if self.device is not None:
                self.span_dev = _as_device(self.device)
        stack.append((self.full, self.span))
        # one pair of CUDA events: the device total of a blocking stage and
        # the device time of a traced span on a card
        dev = min(self.devices, key=str) if self.devices else self.span_dev
        self.events = None
        if dev is not None and dev.type == 'cuda':
            self.events = (_cuda_event(dev), dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        device_dt = None
        if self.events is not None:
            start, dev = self.events
            self.events = (start, _cuda_event(dev))
        if self.devices:
            for d in self.devices:
                torch.cuda.synchronize(d)
            device_dt = self.events[0].elapsed_time(self.events[1]) * 1e-3
        self.profiler.add(self.full, time.perf_counter() - self.t0,
                          device_dt)
        self.profiler._stack.pop()
        if self.span is not None:
            on_card = self.span_dev is not None and \
                self.span_dev.type == 'cuda'
            self.profiler._close(self.span, exc_type is None, self.span_dev,
                                 self.events if on_card else None)
            if self.devices:
                self.profiler._settle(self.devices)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _Stage(self.profiler, self.name, device=self.device):
                out = fn(*args, **kwargs)
                # block on the result: a stage of a function on the card
                # ends when its work does
                for d in _cuda_devices(out):
                    torch.cuda.synchronize(d)
            return out
        return wrapper


#: the default global profiler
GLOBAL = Profiler()


def stage(name, block=None, device=None):
    """Context manager / decorator recording into the global profiler;
    *device* (a tensor or a device) gives its span a device time."""
    return GLOBAL.stage(name, block, device)


def report(sort='total'):
    return GLOBAL.report(sort)


def reset():
    GLOBAL.reset()


def as_dict():
    return GLOBAL.as_dict()


def tracing():
    """Context manager: record spans and counters in the global profiler
    inside the block."""
    return GLOBAL.tracing()


def is_tracing():
    return GLOBAL.is_tracing()


def next_pass():
    return GLOBAL.next_pass()


def count(name, n=1):
    GLOBAL.count(name, n)


def spans():
    return GLOBAL.spans()


def counters():
    return GLOBAL.counters()
