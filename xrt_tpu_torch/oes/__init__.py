"""Optical elements: the OE base, the stock mirrors, the gratings and zone
plates, the parametric mirrors and capillaries, the double-crystal
monochromators, the bent-crystal analyzers, the Laue crystals, the
refractive plates and lenses, the STL-mesh OE, and a DCM and a mirror
oriented by their stages."""
from .base import OE, find_intersection, find_intersection_dz
from .bragg import (DicedJohannToroid, DicedJohanssonToroid, DicedOE,
                    GeneralBraggToroid, JohannCylinder, JohannToroid,
                    JohanssonCylinder, JohanssonToroid)
from .dcm import DCM, DCMOnTripodWithOneXStage, DCMwithSagittalFocusing
from .gratings import (BlazedGrating, GeneralFZPin0YZ, Grating,
                       LaminarGrating, NormalFZP, VLSLaminarGrating)
from .mirrors import (BentFlatMirror, ConicalMirror, CylindricalMirror,
                      DualVFM, FlatMirror, MirrorOnTripodWithTwoXStages,
                      SimpleVCM, SimpleVFM, SphericalMirror,
                      ToroidMirror, VCM, VFM, rmer_from_coddington,
                      rsag_from_coddington)
from .laue import (BentLaue2D, BentLaueCylinder, BentLaueSphere,
                   GroundBentLaueCylinder, LauePlate)
from .mesh3d import MeshOE, read_stl
from .parametric import (EllipsoidCapillaryMirror, EllipticalMirror,
                         EllipticalMirrorParam, HyperbolicMirror,
                         HyperbolicMirrorParam, HyperboloidCapillaryMirror,
                         ParabolicalMirrorParam, ParabolicMirror,
                         ParaboloidCapillaryMirror, SurfaceOfRevolution)
from .refractive import (DoubleParabolicCylinderLens, DoubleParaboloidLens,
                         ParabolicCylinderFlatLens, ParaboloidFlatLens, Plate)

__all__ = ['OE', 'find_intersection', 'find_intersection_dz', 'FlatMirror',
           'BentFlatMirror', 'SimpleVCM', 'VCM', 'SphericalMirror',
           'ToroidMirror', 'SimpleVFM', 'VFM', 'CylindricalMirror',
           'ConicalMirror', 'DualVFM', 'MirrorOnTripodWithTwoXStages',
           'rmer_from_coddington',
           'rsag_from_coddington',
           'BlazedGrating', 'Grating', 'NormalFZP', 'GeneralFZPin0YZ',
           'LaminarGrating', 'VLSLaminarGrating', 'EllipticalMirrorParam',
           'EllipticalMirror', 'ParabolicalMirrorParam', 'ParabolicMirror',
           'HyperbolicMirrorParam', 'HyperbolicMirror', 'SurfaceOfRevolution',
           'EllipsoidCapillaryMirror', 'ParaboloidCapillaryMirror',
           'HyperboloidCapillaryMirror', 'MeshOE', 'read_stl',
           'DCM', 'DCMwithSagittalFocusing', 'DCMOnTripodWithOneXStage',
           'JohannCylinder', 'JohanssonCylinder', 'JohannToroid',
           'JohanssonToroid', 'GeneralBraggToroid', 'DicedOE',
           'DicedJohannToroid', 'DicedJohanssonToroid', 'LauePlate',
           'BentLaueCylinder', 'GroundBentLaueCylinder', 'BentLaueSphere',
           'BentLaue2D', 'Plate', 'ParaboloidFlatLens',
           'ParabolicCylinderFlatLens', 'DoubleParaboloidLens',
           'DoubleParabolicCylinderLens']
