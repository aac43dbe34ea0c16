"""Model metadata: public names for parameters, states, routes, and outputs.

Parity with LAPKB/pharmsol src/simulator/equation/metadata.rs:

- builder ``ModelMetadata`` -> ``validate()/validate_for(kind)`` ->
  ``ValidatedModelMetadata`` with dense index mappings (metadata.rs:41,112,380);
- routes get per-kind input indices: bolus routes count separately from
  infusion routes, and ``route_input_count = max(n_bolus, n_infusion)``
  (metadata.rs:926-957);
- infusion routes may not declare lag or bioavailability (metadata.rs:959-975);
- particles are required for SDE and forbidden otherwise (metadata.rs:837-858);
- bare numeric labels resolve only through the canonical ``input_<n>`` /
  ``outeq_<n>`` aliases (metadata.rs:240-275), never positionally.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from .errors import MetadataError

NUMERIC_ROUTE_PREFIX = "input_"
NUMERIC_OUTPUT_PREFIX = "outeq_"


class ModelKind(enum.Enum):
    ODE = "ode"
    ANALYTICAL = "analytical"
    SDE = "sde"


class RouteKind(enum.Enum):
    BOLUS = "bolus"
    INFUSION = "infusion"


class RouteInputPolicy(enum.Enum):
    INJECT_TO_DESTINATION = "inject_to_destination"
    EXPLICIT_INPUT_VECTOR = "explicit_input_vector"


class CovariateInterpolation(enum.Enum):
    LINEAR = "linear"
    LOCF = "locf"


class AnalyticalKernel(enum.Enum):
    """The 12 built-in closed-form kernels (pharmsol-dsl analysis.rs:187-272)."""

    ONE_COMPARTMENT = "one_compartment"
    ONE_COMPARTMENT_WITH_ABSORPTION = "one_compartment_with_absorption"
    ONE_COMPARTMENT_CL = "one_compartment_cl"
    ONE_COMPARTMENT_CL_WITH_ABSORPTION = "one_compartment_cl_with_absorption"
    TWO_COMPARTMENTS = "two_compartments"
    TWO_COMPARTMENTS_WITH_ABSORPTION = "two_compartments_with_absorption"
    TWO_COMPARTMENTS_CL = "two_compartments_cl"
    TWO_COMPARTMENTS_CL_WITH_ABSORPTION = "two_compartments_cl_with_absorption"
    THREE_COMPARTMENTS = "three_compartments"
    THREE_COMPARTMENTS_WITH_ABSORPTION = "three_compartments_with_absorption"
    THREE_COMPARTMENTS_CL = "three_compartments_cl"
    THREE_COMPARTMENTS_CL_WITH_ABSORPTION = "three_compartments_cl_with_absorption"


def _is_bare_numeric(label: str) -> bool:
    return len(label) > 0 and label.isdigit()


@dataclass(frozen=True)
class CovariateDecl:
    name: str
    interpolation: Optional[CovariateInterpolation] = None

    @staticmethod
    def continuous(name: str) -> "CovariateDecl":
        return CovariateDecl(name, CovariateInterpolation.LINEAR)

    @staticmethod
    def locf(name: str) -> "CovariateDecl":
        return CovariateDecl(name, CovariateInterpolation.LOCF)


@dataclass
class Route:
    """One named route declaration (builder form)."""

    name: str
    kind: RouteKind
    destination: Optional[str] = None
    has_lag: bool = False
    has_bioavailability: bool = False
    input_policy: Optional[RouteInputPolicy] = None

    @staticmethod
    def bolus(name: str) -> "Route":
        return Route(name, RouteKind.BOLUS)

    @staticmethod
    def infusion(name: str) -> "Route":
        return Route(name, RouteKind.INFUSION)

    def to_state(self, destination: str) -> "Route":
        self.destination = destination
        return self

    def with_lag(self) -> "Route":
        self.has_lag = True
        return self

    def with_bioavailability(self) -> "Route":
        self.has_bioavailability = True
        return self

    def inject_input_to_destination(self) -> "Route":
        self.input_policy = RouteInputPolicy.INJECT_TO_DESTINATION
        return self

    def expect_explicit_input(self) -> "Route":
        self.input_policy = RouteInputPolicy.EXPLICIT_INPUT_VECTOR
        return self


@dataclass(frozen=True)
class ValidatedRoute:
    name: str
    kind: RouteKind
    declaration_index: int
    input_index: int
    destination: str
    destination_index: int
    has_lag: bool
    has_bioavailability: bool
    input_policy: Optional[RouteInputPolicy]


class ModelMetadata:
    """Builder for model metadata. Chain setters, then ``validate()``."""

    def __init__(self, name: str):
        self._name = name
        self._kind: Optional[ModelKind] = None
        self._parameters: List[str] = []
        self._covariates: List[CovariateDecl] = []
        self._states: List[str] = []
        self._routes: List[Route] = []
        self._outputs: List[str] = []
        self._particles: Optional[int] = None
        self._analytical: Optional[AnalyticalKernel] = None

    def kind(self, kind: ModelKind) -> "ModelMetadata":
        self._kind = kind
        return self

    def parameters(self, parameters: Sequence[str]) -> "ModelMetadata":
        self._parameters = [str(p) for p in parameters]
        return self

    def covariates(self, covariates: Sequence) -> "ModelMetadata":
        self._covariates = [
            c if isinstance(c, CovariateDecl) else CovariateDecl(str(c)) for c in covariates
        ]
        return self

    def states(self, states: Sequence[str]) -> "ModelMetadata":
        self._states = [str(s) for s in states]
        return self

    def route(self, route: Route) -> "ModelMetadata":
        self._routes.append(route)
        return self

    def routes(self, routes: Sequence[Route]) -> "ModelMetadata":
        self._routes.extend(routes)
        return self

    def outputs(self, outputs: Sequence[str]) -> "ModelMetadata":
        self._outputs = [str(o) for o in outputs]
        return self

    def particles(self, particles: int) -> "ModelMetadata":
        self._particles = int(particles)
        return self

    def analytical_kernel(self, kernel: AnalyticalKernel) -> "ModelMetadata":
        self._analytical = kernel
        return self

    # -- validation -------------------------------------------------------------
    def validate(self) -> "ValidatedModelMetadata":
        return self._validate(None, None)

    def validate_for(self, kind: ModelKind) -> "ValidatedModelMetadata":
        return self._validate(kind, None)

    def validate_for_with_particles(
        self, kind: ModelKind, fallback_particles: int
    ) -> "ValidatedModelMetadata":
        return self._validate(kind, fallback_particles)

    def _validate(
        self, requested: Optional[ModelKind], fallback_particles: Optional[int]
    ) -> "ValidatedModelMetadata":
        if self._kind is not None and requested is not None and self._kind != requested:
            raise MetadataError(
                f"metadata declares kind {self._kind.value} but was validated for "
                f"{requested.value}"
            )
        kind = self._kind or requested
        if kind is None:
            raise MetadataError("model kind is required (declare .kind(...) or validate_for)")

        for domain, names in (
            ("parameter", self._parameters),
            ("covariate", [c.name for c in self._covariates]),
            ("state", self._states),
            ("output", self._outputs),
        ):
            seen = set()
            for n in names:
                if n in seen:
                    raise MetadataError(f"duplicate {domain} name `{n}`")
                seen.add(n)
        seen_routes = set()
        for r in self._routes:
            key = (r.name, r.kind)
            if key in seen_routes:
                raise MetadataError(f"duplicate route `{r.name}` for kind {r.kind.value}")
            seen_routes.add(key)

        # particles
        particles = self._particles
        if particles is not None and fallback_particles is not None and particles != fallback_particles:
            raise MetadataError(
                f"metadata declares {particles} particles but equation uses "
                f"{fallback_particles}"
            )
        if particles is None:
            particles = fallback_particles
        if kind in (ModelKind.ODE, ModelKind.ANALYTICAL) and particles is not None:
            raise MetadataError(f"particles not allowed for {kind.value} models")
        if kind is ModelKind.SDE and particles is None:
            raise MetadataError("SDE metadata requires a particle count")
        if kind in (ModelKind.ODE, ModelKind.SDE) and self._analytical is not None:
            raise MetadataError(f"analytical kernel not allowed for {kind.value} models")

        # routes: per-kind input counters (metadata.rs:926-957)
        bolus_inputs = 0
        infusion_inputs = 0
        validated_routes: List[ValidatedRoute] = []
        for decl_idx, r in enumerate(self._routes):
            if r.kind is RouteKind.INFUSION and r.has_lag:
                raise MetadataError(f"infusion route `{r.name}` may not declare lag")
            if r.kind is RouteKind.INFUSION and r.has_bioavailability:
                raise MetadataError(
                    f"infusion route `{r.name}` may not declare bioavailability"
                )
            if r.destination is None:
                raise MetadataError(f"route `{r.name}` is missing a destination state")
            try:
                dest_idx = self._states.index(r.destination)
            except ValueError:
                raise MetadataError(
                    f"route `{r.name}` targets unknown state `{r.destination}`"
                )
            if r.kind is RouteKind.BOLUS:
                input_index = bolus_inputs
                bolus_inputs += 1
            else:
                input_index = infusion_inputs
                infusion_inputs += 1
            validated_routes.append(
                ValidatedRoute(
                    name=r.name,
                    kind=r.kind,
                    declaration_index=decl_idx,
                    input_index=input_index,
                    destination=r.destination,
                    destination_index=dest_idx,
                    has_lag=r.has_lag,
                    has_bioavailability=r.has_bioavailability,
                    input_policy=r.input_policy,
                )
            )

        return ValidatedModelMetadata(
            name=self._name,
            model_kind=kind,
            parameter_names=list(self._parameters),
            covariate_decls=list(self._covariates),
            state_names=list(self._states),
            validated_routes=validated_routes,
            route_input_count=max(bolus_inputs, infusion_inputs),
            output_names=list(self._outputs),
            particle_count=particles,
            analytical=self._analytical,
        )


def new(name: str) -> ModelMetadata:
    """Start a metadata builder (parity with ``pharmsol::metadata::new``)."""
    return ModelMetadata(name)


@dataclass
class ValidatedModelMetadata:
    name: str
    model_kind: ModelKind
    parameter_names: List[str]
    covariate_decls: List[CovariateDecl]
    state_names: List[str]
    validated_routes: List[ValidatedRoute]
    route_input_count: int
    output_names: List[str]
    particle_count: Optional[int]
    analytical: Optional[AnalyticalKernel]

    # -- reference-parity accessors ----------------------------------------
    def kind(self) -> ModelKind:
        return self.model_kind

    def parameters(self) -> List[str]:
        return list(self.parameter_names)

    def covariates(self) -> List[CovariateDecl]:
        return list(self.covariate_decls)

    def covariate_names(self) -> List[str]:
        return [c.name for c in self.covariate_decls]

    def states(self) -> List[str]:
        return list(self.state_names)

    def routes(self) -> List[ValidatedRoute]:
        return list(self.validated_routes)

    def route_labels(self) -> List[str]:
        return [r.name for r in self.validated_routes]

    def outputs(self) -> List[str]:
        return list(self.output_names)

    def output_labels(self) -> List[str]:
        return list(self.output_names)

    def particles(self) -> Optional[int]:
        return self.particle_count

    def analytical_kernel(self) -> Optional[AnalyticalKernel]:
        return self.analytical

    def parameter_index(self, name: str) -> Optional[int]:
        try:
            return self.parameter_names.index(name)
        except ValueError:
            return None

    def covariate_index(self, name: str) -> Optional[int]:
        for i, c in enumerate(self.covariate_decls):
            if c.name == name:
                return i
        return None

    def state_index(self, name: str) -> Optional[int]:
        try:
            return self.state_names.index(name)
        except ValueError:
            return None

    def output_index(self, name: str) -> Optional[int]:
        try:
            return self.output_names.index(name)
        except ValueError:
            return None

    def route(self, name: str) -> Optional[ValidatedRoute]:
        for r in self.validated_routes:
            if r.name == name:
                return r
        return None

    def route_by_kind(self, name: str, kind: RouteKind) -> Optional[ValidatedRoute]:
        for r in self.validated_routes:
            if r.name == name and r.kind == kind:
                return r
        return None

    def output(self, name: str) -> Optional[str]:
        return name if name in self.output_names else None

    # -- label resolution (metadata.rs:240-275) ------------------------------
    def route_for_label(self, label: str, kind: RouteKind) -> Optional[ValidatedRoute]:
        r = self.route_by_kind(label, kind)
        if r is not None:
            return r
        if not _is_bare_numeric(label):
            return None
        return self.route_by_kind(f"{NUMERIC_ROUTE_PREFIX}{label}", kind)

    def output_for_label(self, label: str) -> Optional[int]:
        idx = self.output_index(label)
        if idx is not None:
            return idx
        if not _is_bare_numeric(label):
            return None
        return self.output_index(f"{NUMERIC_OUTPUT_PREFIX}{label}")
