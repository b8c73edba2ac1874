"""setup_s: from the start of the process to the first timed unit:
imports, the CUDA context, loading (and on a checkout's first run,
building) the kernels, the beamline's build and the warm-up of the
cell's shapes."""


def read(run):
    return run['setup_s']
