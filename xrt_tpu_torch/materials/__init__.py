"""Materials: elements, amorphous materials (mirror reflectivity,
transmittivity, grating efficiencies), the empty material, crystals (with
the Takagi-Taupin amplitudes of bent crystals), multilayers and the
multi-reflex materials (powder, crystal harmonics, monocrystal) and the
voxel volume of TXM."""
from .element import Element
from .material import EmptyMaterial, Material
from .crystal import (Crystal, CrystalDiamond, CrystalFcc, CrystalFromCell,
                      CrystalSi)
from .multilayer import Coated, GradedMultilayer, Multilayer
from .polycrystal import CrystalHarmonics, MonoCrystal, Powder
from .volume import TXMMaterial
from . import data
from . import tt

__all__ = ['Element', 'Material', 'EmptyMaterial', 'Crystal', 'CrystalFcc',
           'CrystalDiamond', 'CrystalSi', 'CrystalFromCell', 'Multilayer',
           'GradedMultilayer', 'Coated', 'Powder', 'CrystalHarmonics',
           'MonoCrystal', 'TXMMaterial', 'data', 'tt']
