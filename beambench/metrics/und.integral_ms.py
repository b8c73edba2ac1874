"""und.integral_ms: the undulator's radiation integral, the program's
``sources.integrate`` spans (``Undulator._integrate`` inside each
``build_I_map`` call, one a ray block), their device time summed per
pass, mean over the passes whose ``runner.step`` closed ok."""
from program_records import span_ms


def read(run):
    return span_ms('sources.integrate')
