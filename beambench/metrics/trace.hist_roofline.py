"""trace.hist_roofline: the bytes bound of the traced passes' ``hist_plot``
launches (each plot's ray columns read once, its histograms written once,
over the memory bandwidth) over the device time of the ``hist_plot``
kernels (B4), in %.  The launches must match the program's counter, or
nothing is read."""
import harness
import peaks


def read(run):
    launches = run.get('hist_launches') or []
    have = sum(v for k, v in run['counters'].items()
               if k.startswith('hist_plot:'))
    kern = harness.kernel_ms(run, ('plot_',))
    if not launches or have != len(launches) or kern is None:
        return None
    bound = sum(peaks.hist_plot_bound_ms(*sh) for sh in launches)
    return 100.0 * bound / kern
