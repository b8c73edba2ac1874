"""Materials: elements, amorphous materials (mirror reflectivity) and
crystals."""
from .element import Element
from .material import Material
from .crystal import (Crystal, CrystalDiamond, CrystalFcc, CrystalFromCell,
                      CrystalSi)
from . import data

__all__ = ['Element', 'Material', 'Crystal', 'CrystalFcc', 'CrystalDiamond',
           'CrystalSi', 'CrystalFromCell', 'data']
