"""Optical elements: the OE base, the stock mirrors, the gratings and zone
plates, the parametric elliptical mirror, the double-crystal
monochromators, the bent-crystal analyzers, the Laue crystals and the
refractive plates and lenses."""
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
from .laue import (BentLaue2D, BentLaueCylinder, BentLaueSphere,
                   GroundBentLaueCylinder, LauePlate)
from .parametric import EllipticalMirror, EllipticalMirrorParam
from .refractive import (DoubleParabolicCylinderLens, DoubleParaboloidLens,
                         ParabolicCylinderFlatLens, ParaboloidFlatLens, Plate)

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
           'DicedJohannToroid', 'DicedJohanssonToroid', 'LauePlate',
           'BentLaueCylinder', 'GroundBentLaueCylinder', 'BentLaueSphere',
           'BentLaue2D', 'Plate', 'ParaboloidFlatLens',
           'ParabolicCylinderFlatLens', 'DoubleParaboloidLens',
           'DoubleParabolicCylinderLens']
