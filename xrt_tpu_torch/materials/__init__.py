"""Materials: elements and amorphous materials (mirror reflectivity)."""
from .element import Element
from .material import Material
from . import data

__all__ = ['Element', 'Material', 'data']
