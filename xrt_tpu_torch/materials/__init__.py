"""Materials: elements, amorphous materials (mirror reflectivity,
transmittivity, grating efficiencies), the empty material and crystals."""
from .element import Element
from .material import EmptyMaterial, Material
from .crystal import (Crystal, CrystalDiamond, CrystalFcc, CrystalFromCell,
                      CrystalSi)
from . import data

__all__ = ['Element', 'Material', 'EmptyMaterial', 'Crystal', 'CrystalFcc',
           'CrystalDiamond', 'CrystalSi', 'CrystalFromCell', 'data']
