"""Non-compartmental analysis (sits directly on the data layer).

Rebuild of LAPKB/pharmsol src/nca/* — entry points, options/results, λz
selection, route-specific parameters, sparse sampling, superposition,
bioavailability, and population summaries.
"""

from . import api as _api  # noqa: F401  (attaches .nca methods to data types)
from . import metrics as _metrics  # noqa: F401  (attaches observation metrics)
from .analyze import AnalysisContext, analyze  # noqa: F401
from .api import (  # noqa: F401
    detect_infusion_duration,
    detect_route,
    detect_routes,
    nca,
    nca_all,
    nca_grouped,
    nca_occasion,
    nca_with_dose,
    total_dose,
)
from .bioavailability import (  # noqa: F401
    BioavailabilityResult,
    BioequivalenceResult,
    bioavailability,
    bioequivalence,
    compare,
    metabolite_parent_ratio,
)
from .batch import batch_nca  # noqa: F401
from .batch_device import batch_nca_device  # noqa: F401
from .calc import lambda_z, lambda_z_candidates, tlag_from_raw  # noqa: F401
from .metrics import MetricsError  # noqa: F401
from .observation import NCAError, ObservationProfile  # noqa: F401
from .sparse import SparsePKResult, sparse_auc, sparse_auc_from_data  # noqa: F401
from .summary import (  # noqa: F401
    ParameterSummary,
    PopulationSummary,
    nca_to_csv,
    summarize,
)
from .superposition import (  # noqa: F401
    SuperpositionResult,
    predict_from_nca,
    superposition,
)
from .types import (  # noqa: F401
    C0Method,
    ClearanceParams,
    ExposureParams,
    IVBolusParams,
    IVInfusionParams,
    LambdaZMethod,
    LambdaZOptions,
    MultiDoseParams,
    NCAOptions,
    NCAResult,
    Quality,
    RegressionStats,
    RouteParams,
    Severity,
    SteadyStateParams,
    SubjectNCAResult,
    TerminalParams,
    TmaxRelative,
    Warning_,
)
