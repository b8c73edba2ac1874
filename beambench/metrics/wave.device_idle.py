"""wave.device_idle: the share of the traced window in which no kernel,
copy or set runs on the card (the union of the device intervals of the
torch.profiler trace), in %."""
from harness import idle


def read(run):
    return idle(run)
