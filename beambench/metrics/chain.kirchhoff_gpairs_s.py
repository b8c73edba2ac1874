"""chain.kirchhoff_gpairs_s: source x destination pairs summed by the
forward Kirchhoff kernels, in 1e9 a second of their own device time: the
program's counter ``kirchhoff.pairs`` (each B1/B2 launch's destinations x
sources) over the device time of the traced B1/B2 kernels (their pass and
its reduction, the kernels of ``csrc/kirchhoff_fwd.cuh``'s namespace
``xfwd``)."""
import harness
from chain_records import counter_total

#: the traced kernel names of B1 and B2 contain this
KERNELS = ('xfwd::',)


def read(run):
    pairs = counter_total('kirchhoff.pairs')
    kern = harness.kernel_ms(run, KERNELS)
    if not pairs or kern is None:
        return None
    return pairs / (kern * 1e-3) / 1e9
