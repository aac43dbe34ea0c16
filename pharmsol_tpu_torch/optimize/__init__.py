"""Population estimation on top of the psi path (the part of the JAX
package's ``optimize/`` that the port has)."""

from .effect import find_m0, get_e2
from .nelder_mead import NelderMeadResult, initial_simplex, nelder_mead
from .npag import PopulationResult, fit_population
from .parameters import ParameterOptimizer
from .weights import solve_weights, solve_weights_plain
