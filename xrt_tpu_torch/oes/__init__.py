"""Optical elements: the OE base and the stock mirrors."""
from .base import OE, find_intersection, find_intersection_dz
from .mirrors import (BentFlatMirror, ConicalMirror, CylindricalMirror,
                      FlatMirror, SimpleVCM, SimpleVFM, SphericalMirror,
                      ToroidMirror, VCM, VFM, rmer_from_coddington,
                      rsag_from_coddington)

__all__ = ['OE', 'find_intersection', 'find_intersection_dz', 'FlatMirror',
           'BentFlatMirror', 'SimpleVCM', 'VCM', 'SphericalMirror',
           'ToroidMirror', 'SimpleVFM', 'VFM', 'CylindricalMirror',
           'ConicalMirror', 'rmer_from_coddington', 'rsag_from_coddington']
