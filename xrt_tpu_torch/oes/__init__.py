"""Optical elements: the OE base, the stock mirrors, the gratings and zone
plates, the parametric elliptical mirror, the double-crystal
monochromators and the bent-crystal analyzers."""
from .base import OE, find_intersection, find_intersection_dz
from .bragg import (DicedJohannToroid, DicedJohanssonToroid, DicedOE,
                    GeneralBraggToroid, JohannCylinder, JohannToroid,
                    JohanssonCylinder, JohanssonToroid)
from .dcm import DCM, DCMOnTripodWithOneXStage, DCMwithSagittalFocusing
from .gratings import (BlazedGrating, GeneralFZPin0YZ, Grating,
                       LaminarGrating, NormalFZP, VLSLaminarGrating)
from .mirrors import (BentFlatMirror, ConicalMirror, CylindricalMirror,
                      FlatMirror, SimpleVCM, SimpleVFM, SphericalMirror,
                      ToroidMirror, VCM, VFM, rmer_from_coddington,
                      rsag_from_coddington)
from .parametric import EllipticalMirror, EllipticalMirrorParam

__all__ = ['OE', 'find_intersection', 'find_intersection_dz', 'FlatMirror',
           'BentFlatMirror', 'SimpleVCM', 'VCM', 'SphericalMirror',
           'ToroidMirror', 'SimpleVFM', 'VFM', 'CylindricalMirror',
           'ConicalMirror', 'rmer_from_coddington', 'rsag_from_coddington',
           'BlazedGrating', 'Grating', 'NormalFZP', 'GeneralFZPin0YZ',
           'LaminarGrating', 'VLSLaminarGrating', 'EllipticalMirrorParam',
           'EllipticalMirror',
           'DCM', 'DCMwithSagittalFocusing', 'DCMOnTripodWithOneXStage',
           'JohannCylinder', 'JohanssonCylinder', 'JohannToroid',
           'JohanssonToroid', 'GeneralBraggToroid', 'DicedOE',
           'DicedJohannToroid', 'DicedJohanssonToroid']
