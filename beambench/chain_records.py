"""The program's own spans and counters per chain run, as the readers of the
wave chain's cells (``metrics/chain.*``) take them.

The driver of ``softimax_chain`` advances the program's pass id before
each chain run, so the spans and counters of one run share it; the
program records them while a ``torch.profiler`` session records, in a
``--trace 1`` run the window alone.  The frozen window looks at the clock
only between runs, so every run it starts completes, and a metric here is
a sum over the window divided by its units.  ``program_records.span_ms`` does not serve:
it counts only the passes of a ``runner.step``.  A program that keeps no
such records, or records none of the names asked for, gives None, and
nothing raises.
"""
from program_records import _outermost, records


def span_ms_per_run(run, name):
    """The device ms of the outermost *name* spans that closed ok, over
    the window, per completed chain run; None where none has a device
    time."""
    rec = records()
    nruns = len(run['units'])
    if rec is None or not nruns:
        return None
    times = [s.device_ns for s in _outermost(rec[0], name) if s.ok]
    times = [t for t in times if t is not None]
    return sum(times) * 1e-6 / nruns if times else None


def counter_total(name):
    """The counter *name* summed over every pass; None where no pass
    counted it."""
    rec = records()
    if rec is None:
        return None
    got = [c[name] for c in rec[1].values() if name in c]
    return sum(got) if got else None
