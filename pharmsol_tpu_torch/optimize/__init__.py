"""Population estimation on top of the psi path and the per-subject batch
(the JAX package's ``optimize/``): NPAG and its weight solve, the
derivative-free optimizers, and the estimation layer (MAP, Laplace/FOCE,
the Laplace information matrix, SAEM)."""

from .effect import find_m0, get_e2
from .fim import FimResult, laplace_standard_errors
from .laplace import LaplaceResult, fit_laplace
from .map import MapResult, fit_map
from .nelder_mead import NelderMeadResult, initial_simplex, nelder_mead
from .npag import PopulationResult, fit_population
from .parameters import ParameterOptimizer
from .saem import SaemResult, fit_saem
from .weights import solve_weights, solve_weights_plain
