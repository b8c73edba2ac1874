"""trace.search_ms: the program's ``oes.search`` spans
(``oes/base.find_intersection_dz``: bracket evaluations, the Illinois loop
with its one host read an iteration, the Newton steps), their device
time summed per pass, mean over the passes whose ``runner.step``
closed ok."""
from program_records import span_ms


def read(run):
    return span_ms('oes.search')
