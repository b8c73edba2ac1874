"""trace.interact_ms: the program's ``oes.interact`` spans (``OE._interact``:
the grating vector and the crystal's two-beam amplitudes), their device
time summed per pass, mean over the passes whose ``runner.step``
closed ok."""
from program_records import span_ms


def read(run):
    return span_ms('oes.interact')
