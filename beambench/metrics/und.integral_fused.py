"""und.integral_fused: the share of the undulator's ``build_I_map`` calls
whose radiation integral the integral's kernel served, in %: the
program's counters ``integral.fused`` over ``integral.calls``, in the
passes whose ``runner.step`` closed ok; None where the program counts no
``integral.fused`` (a program without the kernel)."""
from program_records import counter_sums


def read(run):
    got = counter_sums('integral.fused', 'integral.calls')
    if got is None or got[0][0] is None or not got[0][1]:
        return None
    fused, calls = got[0]
    return 100.0 * fused / calls
