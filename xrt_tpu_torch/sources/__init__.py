"""Sources: the geometric (sampled) source, the analytic Gaussian beam, the
undulator and the sampling helpers they use."""
from .geometric import GeometricSource, make_energy, polarization_matrix
from .gaussian import GaussianBeam, hermite_poly, genlaguerre_poly
from .undulator import Undulator

__all__ = ['GeometricSource', 'make_energy', 'polarization_matrix',
           'GaussianBeam', 'hermite_poly', 'genlaguerre_poly', 'Undulator']
