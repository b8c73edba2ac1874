"""Sources: the geometric (sampled) source, the analytic Gaussian beam, the
synchrotron sources (bending magnet, wiggler, undulator) and the sampling
helpers they use."""
from .geometric import GeometricSource, make_energy, polarization_matrix
from .gaussian import GaussianBeam, hermite_poly, genlaguerre_poly
from .synchrotron import BendingMagnet, Wiggler
from .undulator import Undulator, clenshaw_curtis, tanaka_kitamura_Qa2

__all__ = ['GeometricSource', 'make_energy', 'polarization_matrix',
           'GaussianBeam', 'hermite_poly', 'genlaguerre_poly',
           'BendingMagnet', 'Wiggler', 'Undulator', 'clenshaw_curtis',
           'tanaka_kitamura_Qa2']
