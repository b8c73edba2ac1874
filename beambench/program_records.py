"""The program's own spans and counters, as the per-layer readers of
``metrics/`` take them.

``xrt_tpu_torch.profiler``, loaded in the run's process, records spans and
counters while a ``torch.profiler`` session records: in a ``--trace 1``
run, the window alone.  A pass counts only when its ``runner.step`` span
closed without an exception, which leaves out the step that the window's
close aborts.  A program that keeps no such records gives None
everywhere, and nothing raises.
"""
import sys


def records():
    """(spans, counters) of the program's profiler, or None."""
    prof = sys.modules.get('xrt_tpu_torch.profiler')
    spans = getattr(prof, 'spans', None)
    counters = getattr(prof, 'counters', None)
    if not callable(spans) or not callable(counters):
        return None
    return spans(), counters()


def ok_passes(spans):
    """The pass ids of the ``runner.step`` spans that closed ok."""
    return {s.pass_id for s in spans if s.name == 'runner.step' and s.ok}


def _outermost(spans, name):
    """The spans named *name* with no span of that name around them."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        if s.name != name:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != name:
            p = by_id.get(p.parent)
        if p is None:
            out.append(s)
    return out


def span_ms(name):
    """The device ms of the outermost *name* spans summed per pass, mean
    over the ok passes; None where none has a device time."""
    rec = records()
    if rec is None:
        return None
    spans = rec[0]
    passes = ok_passes(spans)
    total, found = 0.0, False
    for s in _outermost(spans, name):
        ns = s.device_ns if s.pass_id in passes else None
        if ns is not None:
            total += ns * 1e-6
            found = True
    return total / len(passes) if found else None


def counter_sums(*names):
    """([sum over the ok passes of each counter of *names*, None where no
    ok pass counted it], number of ok passes); None without records or
    ok passes."""
    rec = records()
    if rec is None:
        return None
    spans, counters = rec
    passes = ok_passes(spans)
    if not passes:
        return None
    per_pass = [counters.get(p, {}) for p in passes]
    sums = [sum(c[n] for c in per_pass if n in c)
            if any(n in c for c in per_pass) else None for n in names]
    return sums, len(passes)
