"""pairs_per_s: Kirchhoff source x destination pairs of every chain run
completed in the window, over the window's wall time.  A run's pairs come
from the configuration's shapes (7 N^2 + 3 N n_scr^2), not from the
program's launches."""
from harness import rate


def read(run):
    return rate(run, 'pairs')
