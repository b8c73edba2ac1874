"""chain.shine_ms: the undulator's field on the slit samples, the program's
``sources.shine_wave`` spans (``Undulator.shine_wave``), their device time
per chain run, mean over the traced window's completed runs."""
from chain_records import span_ms_per_run


def read(run):
    return span_ms_per_run(run, 'sources.shine_wave')
