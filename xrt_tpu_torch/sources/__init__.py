"""Sources: the geometric (sampled) source, the analytic Gaussian beam and
the mesh sources, the
synchrotron sources (bending magnet, wiggler, undulator) and the sampling
helpers they use."""
from .geometric import GeometricSource, make_energy, polarization_matrix
from .gaussian import (CollimatedMeshSource, GaussianBeam,
                       HermiteGaussianBeam, LaguerreGaussianBeam, MeshSource,
                       NESWSource, genlaguerre_poly, hermite_poly,
                       shrink_source)
from .synchrotron import BendingMagnet, Wiggler
from .undulator import Undulator, clenshaw_curtis, tanaka_kitamura_Qa2

__all__ = ['GeometricSource', 'make_energy', 'polarization_matrix',
           'GaussianBeam', 'hermite_poly', 'genlaguerre_poly',
           'LaguerreGaussianBeam', 'HermiteGaussianBeam', 'MeshSource',
           'NESWSource', 'CollimatedMeshSource', 'shrink_source',
           'BendingMagnet', 'Wiggler', 'Undulator', 'clenshaw_curtis',
           'tanaka_kitamura_Qa2']
