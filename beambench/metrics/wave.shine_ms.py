"""wave.shine_ms: the undulator's field on the slit samples
(``Undulator.shine_wave``), the 'shine' StageTimer record (CUDA events)
of each traced chain run, mean over the runs."""


def read(run):
    ms = run['spans'].get('step:shine')
    return sum(ms) / len(ms) if ms else None
