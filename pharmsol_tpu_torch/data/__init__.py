from .builder import SubjectBuilder
from .covariate import Covariate, Covariates
from .error_model import AssayErrorModel, AssayErrorModels, ErrorPoly, Factor
from .event import Bolus, Censor, Infusion, Observation
from .residual_error import ResidualErrorModel, ResidualErrorModels
from .serde import from_json, load_json, save_json, to_json
from .structs import Data, Occasion, Subject
