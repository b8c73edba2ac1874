"""chain.prep_ms: the Kirchhoff steps' work outside the kernel launches, the
program's ``waves.prep`` spans inside ``waves.diffract`` (the per-point
preparation, the tiling, the kernels' source rows, the tiles' sums and the
result's directions and normalization), their device time per chain run,
mean over the traced window's completed runs."""
from chain_records import span_ms_per_run


def read(run):
    return span_ms_per_run(run, 'waves.prep')
