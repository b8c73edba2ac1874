"""trace.search_useful: the share of the intersection search's ray
evaluations spent on rays still active, in %: the program's counters
``search.active`` over ``search.ray_evals`` (every iteration evaluates the
surface on all rays), in the passes whose ``runner.step`` closed ok."""
from program_records import counter_sums


def read(run):
    got = counter_sums('search.active', 'search.ray_evals')
    if got is None or not got[0][1]:
        return None
    active, evals = got[0]
    return 100.0 * (active or 0) / evals
