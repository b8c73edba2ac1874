"""xrt_tpu_torch — the beamline simulator in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the reference package beside it, module for module.  Entry points
take an explicit ``device=`` (``'cuda'`` by default) and ``dtype=``
(``torch.float32`` by default, ``torch.float64`` allowed), and raise when no
card is present unless the caller asks for ``device='cpu'``.
"""
__version__ = '0.1.0'

from . import config, physconsts
from .beam import Beam, new_beam

__all__ = ['config', 'physconsts', 'Beam', 'new_beam', '__version__']
