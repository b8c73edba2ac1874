"""trace.search_fused: the share of intersection searches that the toroid
crystals' search kernel served, in %: the program's counters
``search.fused`` over ``search.calls``, in the passes whose
``runner.step`` closed ok; None where the program counts no
``search.fused`` (a program without the kernel)."""
from program_records import counter_sums


def read(run):
    got = counter_sums('search.fused', 'search.calls')
    if got is None or got[0][0] is None or not got[0][1]:
        return None
    fused, calls = got[0]
    return 100.0 * fused / calls
