"""trace.interact_fused: the share of ``OE._interact`` calls that the toroid
crystals' interaction kernel served, in %: the program's counters
``interact.fused`` over ``interact.calls``, in the passes whose
``runner.step`` closed ok; None where the program counts no
``interact.fused`` (a program without the kernel)."""
from program_records import counter_sums


def read(run):
    got = counter_sums('interact.fused', 'interact.calls')
    if got is None or got[0][0] is None or not got[0][1]:
        return None
    fused, calls = got[0]
    return 100.0 * fused / calls
