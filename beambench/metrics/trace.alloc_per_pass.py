"""trace.alloc_per_pass: the caching allocator's ``cudaMalloc`` calls a pass,
from the program's counter ``alloc.segments`` (the change of
``segment.all.allocated`` over ``runner.step``), mean over the passes whose
``runner.step`` closed ok; None where nothing was counted (no card).

Under the analyzer cell's present check these are the kept beams'
allocations: the check keeps one pass's beams a source in device memory,
and every ``cudaMalloc`` of a window falls in the two passes after a pass
it keeps, none in steady state.  The metric waits, with
``trace.reflect_ms``, for the benchmark change that moves the kept beams
to the host."""
from program_records import counter_sums


def read(run):
    got = counter_sums('alloc.segments')
    if got is None or got[0][0] is None:
        return None
    return got[0][0] / got[1]
