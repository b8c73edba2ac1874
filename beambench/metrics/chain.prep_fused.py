"""chain.prep_fused: the share of the forward Kirchhoff launches whose
per-point preparation ran in the preparation kernel (``csrc/kirchhoff_prep.cu``),
in %: the program's counters ``kirchhoff.prep_fused`` over
``kirchhoff.launches``, over the traced window; None where the program
counts no ``kirchhoff.prep_fused`` (a program without the kernel)."""
from chain_records import counter_total


def read(run):
    fused = counter_total('kirchhoff.prep_fused')
    launches = counter_total('kirchhoff.launches')
    if fused is None or not launches:
        return None
    return 100.0 * fused / launches
