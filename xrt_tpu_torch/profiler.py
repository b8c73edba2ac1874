"""Named stages: wall time and call counts in a registry, with nesting, a
one-line-per-stage report and a context / decorator API.

Port of the reference package's ``profiler.py``.  PyTorch returns before
the card finishes, so a stage that ends without waiting measures the
launches only.  A stage asked to block (``block=`` a CUDA tensor, a tuple,
list or dict of them, or a device) records CUDA events at its start and
end and ends in ``torch.cuda.synchronize(device)``: its host time then
covers the device's work, and its device time (``device_total``, the
events' elapsed time read after the synchronize) is reported beside it.
The decorator form blocks on the function's return value.

Usage::

    from xrt_tpu_torch.profiler import stage, report, reset

    with stage('shine'):
        beam = src.shine(generator)
    with stage('reflect', block=beam.x.device):
        glo, loc = mirror.reflect(beam, generator=generator)
    print(report())
"""
from __future__ import annotations

import functools
import time
from contextlib import ContextDecorator
from typing import Dict


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


class Profiler:
    """A registry of named stage timings."""

    def __init__(self):
        self.stats: Dict[str, StageStats] = {}
        self._stack = []

    def reset(self):
        self.stats.clear()
        self._stack.clear()

    def add(self, name, dt, device_dt=None):
        self.stats.setdefault(name, StageStats()).add(dt, device_dt)

    def stage(self, name, block=None):
        return _Stage(self, name, block)

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
    import torch
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
    def __init__(self, profiler, name, block=None):
        self.profiler = profiler
        self.name = name
        self.devices = _cuda_devices(block)

    def __enter__(self):
        # nested stages get dotted names: 'trace.reflect'
        parent = self.profiler._stack[-1] if self.profiler._stack else None
        self.full = f'{parent}.{self.name}' if parent else self.name
        self.profiler._stack.append(self.full)
        self.events = None
        if self.devices:
            import torch
            dev = min(self.devices, key=str)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), dev)
            self.events[0].record(torch.cuda.current_stream(dev))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        device_dt = None
        if self.devices:
            import torch
            start, end, dev = self.events
            end.record(torch.cuda.current_stream(dev))
            for d in self.devices:
                torch.cuda.synchronize(d)
            device_dt = start.elapsed_time(end) * 1e-3
        self.profiler.add(self.full, time.perf_counter() - self.t0,
                          device_dt)
        self.profiler._stack.pop()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _Stage(self.profiler, self.name):
                out = fn(*args, **kwargs)
                # block on the result: a stage of a function on the card
                # ends when its work does
                for d in _cuda_devices(out):
                    import torch
                    torch.cuda.synchronize(d)
            return out
        return wrapper


#: the default global profiler
GLOBAL = Profiler()


def stage(name, block=None):
    """Context manager / decorator recording into the global profiler."""
    return GLOBAL.stage(name, block)


def report(sort='total'):
    return GLOBAL.report(sort)


def reset():
    GLOBAL.reset()


def as_dict():
    return GLOBAL.as_dict()
