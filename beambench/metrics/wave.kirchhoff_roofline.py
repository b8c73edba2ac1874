"""wave.kirchhoff_roofline: the least time of the traced runs' Kirchhoff
launches (each the larger of its operations over the float32 peak and its
bytes over the memory bandwidth, ``peaks.bound_ms``) over the B1/B2
kernels' device time, in %.  The launches come from the stage modes and
tile maps chosen at build time; they must match the program's launch
counter, or nothing is read."""
import collections

import harness
import peaks


def read(run):
    launches = run.get('launches') or []
    want = collections.Counter(name for name, _, _ in launches)
    have = {k: v for k, v in run['counters'].items()
            if k.startswith('kirchhoff_') and v}
    kern = harness.kernel_ms(run, run.get('kernel_names', ()))
    if not launches or dict(want) != have or kern is None:
        return None
    bound = sum(peaks.bound_ms(name, nd, ns)[0]
                for name, nd, ns in launches)
    return 100.0 * bound / kern
