"""The simplest backend: random Gaussian rays for histogram demos.

Port of the reference package's ``dummy.py`` (xrt/backends/dummy.py,
run_process:18): returns (x, y, intensity, energy, nrays) to feed a plot
directly, bypassing ray tracing, drawn from a ``torch.Generator`` on
*device* (the card by default).
"""
from __future__ import annotations

import torch

from . import config

nrays = 25000


def run_process(nrays=nrays, seed=0, device=None, dtype=None):
    nrays = int(nrays)
    dev = config.resolve_device(device)
    dt = config.resolve_dtype(dtype)
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(nrays, generator=g, dtype=dt, device=dev)
    y = torch.randn(nrays, generator=g, dtype=dt, device=dev)
    intensity = torch.ones_like(x)
    energy = x + y * 2.0 + 5000
    return x, y, intensity, energy, nrays
