"""pass_p95_ms: the 95th percentile of the wall time of every pass in the
window (from the start of one pass's ``run_process`` to the start of the
next's)."""
import harness


def read(run):
    units = [u for u in run['units'] if u.get('kind') == 'rays']
    if len(units) < 20:
        return None
    return harness.percentile([1e3 * (u['t1'] - u['t0']) for u in units],
                              95)
