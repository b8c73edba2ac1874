"""Sources: the analytic Gaussian beam and the sampling helpers it uses."""
from .geometric import make_energy, polarization_matrix
from .gaussian import GaussianBeam, hermite_poly, genlaguerre_poly

__all__ = ['make_energy', 'polarization_matrix', 'GaussianBeam',
           'hermite_poly', 'genlaguerre_poly']
