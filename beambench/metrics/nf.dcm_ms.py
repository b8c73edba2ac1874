"""nf.dcm_ms: the double-crystal monochromator, the program's
``oes.double_reflect`` spans (``DCM.double_reflect``: both crystals'
intersections, reflections and two-beam amplitudes), their device time
summed per pass, mean over the passes whose ``runner.step`` closed ok;
None where the program has no such span."""
from program_records import span_ms


def read(run):
    return span_ms('oes.double_reflect')
