"""rays_per_s: rays shone by the sources in every pass completed in the
window, over the window's wall time."""
from harness import rate


def read(run):
    return rate(run, 'rays')
