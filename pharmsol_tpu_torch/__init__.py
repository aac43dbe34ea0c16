"""pharmsol_tpu_torch: the PyTorch/CUDA port of pharmsol-tpu.

A second package beside the JAX package ``pharmsol_tpu`` (the reference it is
held against). It ports the population log-likelihood matrix ("psi") of the
closed-form models (with covariates, secondary equations, lag, fa and
init), of ODE models and of SDE models: the data layer (with the Pmetrics
CSV reader and writer, DataRow ingestion, JSON serde and the AUC helpers),
event-grid lowering,
the 12 analytical kernels, the explicit ODE steppers, the Euler-Maruyama
particle filter, the general psi engine, the fused psi paths, whose
kernels are hand-written CUDA for Hopper (``csrc/fused_psi.cu``;
``csrc/fused_ode.cu`` and ``csrc/fused_sde.cu`` with device functions
generated from the model's closures), and the NPAG population fit on top
of psi (``optimize.fit_population``, with the NPML weight solve whose
burn-in runs on the card); and the single-subject API
(``estimate_predictions``, ``estimate_log_likelihood``, ``simulate_subject``)
and the per-subject batch log-likelihood (``log_likelihood_batch``) over the
general engine's segment march; and the authoring surfaces: the runtime
model DSL (``dsl.compile_model``, ``.pkm`` artifacts) and the declarative
API (``ode_model``, ``analytical_model``, ``sde_model``), whose models run
through the same engines and kernels.

The entry points run on the card (``"cuda"``) unless the caller asks for
the CPU with ``set_device("cpu")`` or ``device="cpu"``. The working dtype
defaults to float64 everywhere.
"""

from . import config  # noqa: F401
from .config import device, float_dtype, set_device, set_float_dtype  # noqa: F401
from .data.builder import SubjectBuilder  # noqa: F401
from .data.covariate import Covariate, Covariates  # noqa: F401
from .data.error_model import (  # noqa: F401
    AssayErrorModel,
    AssayErrorModels,
    ErrorPoly,
    Factor,
)
from .data.event import (  # noqa: F401
    AUCMethod,
    BLQRule,
    Bolus,
    Censor,
    Infusion,
    InputLabel,
    Observation,
    OutputLabel,
    Route as AdminRoute,
)
from .data.residual_error import ResidualErrorModel, ResidualErrorModels  # noqa: F401
from .data.serde import from_json, load_json, save_json, to_json  # noqa: F401
from .data.structs import Data, Occasion, Subject  # noqa: F401
from .errors import PharmsolError  # noqa: F401
from .metadata import (  # noqa: F401
    AnalyticalKernel,
    CovariateDecl,
    ModelKind,
    ModelMetadata,
    Route,
    RouteKind,
    ValidatedModelMetadata,
)
from .metadata import new as metadata_new  # noqa: F401
from .models.equation import ODE, Analytical, EquationBase  # noqa: F401
from .models.declarative import analytical_model, ode_model, sde_model  # noqa: F401
from .models.sde import SDE  # noqa: F401
from . import dsl  # noqa: F401
from .engine import analytical as kernels  # noqa: F401
from .engine.analytical import (  # noqa: F401
    one_compartment,
    one_compartment_cl,
    one_compartment_cl_with_absorption,
    one_compartment_with_absorption,
    three_compartments,
    three_compartments_cl,
    three_compartments_cl_with_absorption,
    three_compartments_with_absorption,
    two_compartments,
    two_compartments_cl,
    two_compartments_cl_with_absorption,
    two_compartments_with_absorption,
)
from .likelihood.matrix import (  # noqa: F401
    last_engine_decision,
    log_likelihood_batch,
    log_likelihood_matrix,
)
from . import optimize  # noqa: F401
from .optimize import ParameterOptimizer, get_e2  # noqa: F401
from .parameters import ParameterOrder, Parameters, dense  # noqa: F401

__version__ = "0.1.0"


class metadata:  # noqa: N801 - namespace shim: pharmsol::metadata::new parity
    """``pharmsol_tpu_torch.metadata``: the JAX package's shim (``new``,
    ``Route``, ``CovariateDecl``), with the metadata module's other public
    names as well, so that ``from pharmsol_tpu_torch import metadata``
    reads like the module it shadows."""

    new = staticmethod(metadata_new)
    from .metadata import (  # noqa: F401
        AnalyticalKernel,
        CovariateDecl,
        ModelKind,
        ModelMetadata,
        Route,
        RouteKind,
        ValidatedModelMetadata,
    )

