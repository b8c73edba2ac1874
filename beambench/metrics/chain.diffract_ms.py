"""chain.diffract_ms: the Kirchhoff steps, the program's ``waves.diffract``
spans (per-point preparation, tiling, the B1/B2 kernels and the result's
directions and normalization), their device time per chain run, mean over
the traced window's completed runs."""
from chain_records import span_ms_per_run


def read(run):
    return span_ms_per_run(run, 'waves.diffract')
