"""trace.runner_ms: what ``run_ray_tracing`` adds to a pass
(``_plot_arrays``, ``hist_plot``, ``_accumulate``): the pass's wall time
less its ``run_process`` span, mean per traced pass."""


def read(run):
    rp = run['spans'].get('run_process')
    units = run['units']
    if not rp or len(rp) != len(units):
        return None
    walls = [1e3 * (u['t1'] - u['t0']) for u in units]
    return sum(w - r for w, r in zip(walls, rp)) / len(units)
