"""trace.reflect_ms: ``DicedJohanssonToroid.reflect`` with its
intersection search, CUDA events around it inside the benchmark's
``run_process``, mean per traced pass."""


def read(run):
    ms = run['spans'].get('reflect')
    return sum(ms) / len(ms) if ms else None
