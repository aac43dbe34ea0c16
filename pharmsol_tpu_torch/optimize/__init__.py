"""Population estimation on top of the psi path and the per-subject batch
(the JAX package's ``optimize/``): NPAG and its weight solve, the
derivative-free optimizers, the estimation layer (MAP, Laplace/FOCE, the
Laplace information matrix, SAEM) and its replicate layer (bootstrap,
simulation–re-estimation, VPC/NPDE/GOF, likelihood profiles, stepwise
covariate search)."""

from .bootstrap import BootstrapResult, bootstrap, bootstrap_laplace
from .sse import SseResult, sse, sse_laplace
from .diagnostics import GofResult, NpdeResult, VpcResult, gof, npde, vpc
from .effect import find_m0, get_e2
from .fim import FimResult, laplace_standard_errors
from .map import MapResult, fit_map
from .nelder_mead import NelderMeadResult, initial_simplex, nelder_mead
from .laplace import LaplaceResult, fit_laplace
from .npag import PopulationResult, fit_population
from .profile import ProfileParameter, ProfileResult, llp
from .saem import SaemResult, fit_saem
from .scm import ScmResult, ScmStep, scm
from .parameters import ParameterOptimizer
from .weights import solve_weights, solve_weights_plain
