"""Compute kernels: plain PyTorch versions and their CUDA counterparts."""
from . import dd, kirchhoff
