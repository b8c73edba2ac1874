"""wave.prep_ms: per chain run, the Kirchhoff steps' StageTimer time
(``waves.diffract``: per-point preparation, tiling and the kernels) less
the device time of the B1/B2 kernels in the trace."""
import harness


def read(run):
    steps = [v for k, v in run['spans'].items()
             if k.startswith('step:') and k != 'step:shine']
    kern = harness.kernel_ms(run, run.get('kernel_names', ()))
    if not steps or kern is None:
        return None
    nruns = len(steps[0])
    return (sum(sum(v) for v in steps) - kern) / nruns
