from .builder import SubjectBuilder
from .covariate import Covariate, Covariates
from .error_model import AssayErrorModel, AssayErrorModels, ErrorPoly, Factor
from .event import Bolus, Censor, Infusion, Observation
from .structs import Data, Occasion, Subject
