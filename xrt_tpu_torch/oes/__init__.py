"""Optical elements: the OE base and the stock mirrors of the wave chain."""
from .base import OE
from .mirrors import (ToroidMirror, rmer_from_coddington,
                      rsag_from_coddington)

__all__ = ['OE', 'ToroidMirror', 'rmer_from_coddington',
           'rsag_from_coddington']
