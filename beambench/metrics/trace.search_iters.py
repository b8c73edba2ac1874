"""trace.search_iters: Illinois iterations per intersection search, from
the program's counters ``search.iterations`` (one host read each) over
``search.calls``, in the passes whose ``runner.step`` closed ok."""
from program_records import counter_sums


def read(run):
    got = counter_sums('search.iterations', 'search.calls')
    if got is None or not got[0][1]:
        return None
    iters, calls = got[0]
    return (iters or 0) / calls
