"""trace.oes_reflect_ms: the program's ``oes.reflect`` spans (``OE.reflect``
with its intersection search and crystal physics), their device time
summed per pass, mean over the passes whose ``runner.step`` closed ok.
The program's own counterpart of ``trace.reflect_ms``."""
from program_records import span_ms


def read(run):
    return span_ms('oes.reflect')
