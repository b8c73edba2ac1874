"""trace.runner_self_ms: what the runner adds to a pass on the host clock,
from the program's spans: ``runner.step`` less its ``runner.process``,
plus ``runner.accumulate``, per pass whose ``runner.step`` closed ok,
mean over them.  The program's own counterpart of ``trace.runner_ms``."""
from program_records import ok_passes, records


def read(run):
    rec = records()
    if rec is None:
        return None
    spans = rec[0]
    passes = ok_passes(spans)
    steps = {s.id: s for s in spans
             if s.name == 'runner.step' and s.pass_id in passes}
    if not steps:
        return None
    ns = {s.pass_id: s.t1 - s.t0 for s in steps.values()}
    for s in spans:
        if s.pass_id not in ns or s.t1 is None:
            continue
        if s.name == 'runner.process' and s.parent in steps:
            ns[s.pass_id] -= s.t1 - s.t0
        elif s.name == 'runner.accumulate':
            ns[s.pass_id] += s.t1 - s.t0
    return sum(ns.values()) * 1e-6 / len(ns)
