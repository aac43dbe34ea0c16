"""DSL runtime: AnalyzedModel -> executable equation objects + artifacts.

The counterpart of the JAX package's ``dsl/runtime.py``. The reference ships
three machine-code backends (Cranelift JIT, cargo-AOT cdylib, WASM —
src/dsl/{jit,aot,wasm_compile}.rs); here the role closures are built by
walking the IR (``dsl/interp.py``), and the port's engines run them: the
general engine through ``torch.func.vmap``, and the fused CUDA kernels
through the code ``ops/rhs_codegen.py`` generates from the same closures (an
ODE's ``dx``, an SDE's drift and diffusion), or, for a closed form, through
the kernel inputs the plan decomposes (``likelihood/plans/decompose.py::
_decompose_kernel_inputs``).

What the generator can trace decides the closures' shape: each returns a
list of per-state scalar expressions, with every route's ``b[j]`` /
``rateiv[j]`` added to its destination as a scalar (no vector arithmetic, no
in-place writes). ``out`` returns a tensor of the state's dtype.

Artifacts: ``save_artifact`` writes the full ExecutionModel (metadata +
statement IR) as a versioned JSON ``.pkm`` file; ``load_runtime_artifact``
reconstructs a runnable model. The format is the JAX package's, so either
package loads what the other wrote.

Route semantics (native.rs RouteInputSemantics): DSL routes always inject to
their declared destination state — boluses add into the destination, and
infusion rates are added to the destination's dx/drift.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..engine.ode import ODEOptions
from ..metadata import (
    AnalyticalKernel,
    CovariateDecl,
    ModelKind,
    ModelMetadata,
    Route,
)
from ..models.declarative import KernelInputAnalytical, stack_like, with_inputs
from ..models.equation import ODE
from ..models.sde import SDE
from .analyze import AnalyzedModel, KernelPlan, analyze_model, analyze_module
from .ast import DslModelKind, DslRouteKind, Expr, RouteDeclAst, Stmt
from .diagnostic import Diagnostic, DslError, Span
from .interp import eval_expr, eval_stmts
from .parser import parse_model, parse_module

ARTIFACT_FORMAT = "pharmsol-tpu-pkm"
ARTIFACT_VERSION = 1


def _build_metadata(am: AnalyzedModel):
    md = ModelMetadata(am.name)
    md.parameters(am.parameters)
    md.states(am.states)
    md.outputs(am.outputs)
    covs = []
    for name, interp in am.covariates:
        if interp in ("locf", "carryforward"):
            covs.append(CovariateDecl.locf(name))
        elif interp == "linear":
            covs.append(CovariateDecl.continuous(name))
        else:
            covs.append(CovariateDecl(name))
    md.covariates(covs)
    for r in am.routes:
        kind = r.kind or DslRouteKind.BOLUS
        route = (
            Route.bolus(r.input) if kind is DslRouteKind.BOLUS else Route.infusion(r.input)
        ).to_state(r.destination)
        route.inject_input_to_destination()
        if r.input in am.route_lag:
            route.with_lag()
        if r.input in am.route_fa:
            route.with_bioavailability()
        md.route(route)
    if am.analytical_kernel:
        md.analytical_kernel(AnalyticalKernel(am.analytical_kernel))
    if am.kind is DslModelKind.SDE:
        md.particles(am.particles)
        return md.validate_for(ModelKind.SDE)
    if am.kind is DslModelKind.ANALYTICAL:
        return md.validate_for(ModelKind.ANALYTICAL)
    return md.validate_for(ModelKind.ODE)


class _RoleBuilder:
    """Builds the role closures shared by all three equation kinds."""

    def __init__(self, am: AnalyzedModel, metadata):
        self.am = am
        self.md = metadata
        self.param_index = {n: i for i, n in enumerate(am.parameters)}
        self.state_index = {n: i for i, n in enumerate(am.states)}
        self.nstates = len(am.states)
        self.ninput = metadata.route_input_count
        self.nout = len(am.outputs)
        # route input/destination tables
        self.bolus_routes = []  # (input_index, dest_state_index, label)
        self.infusion_routes = []
        for r in metadata.validated_routes:
            entry = (r.input_index, r.destination_index, r.name)
            if r.kind.value == "bolus":
                self.bolus_routes.append(entry)
            else:
                self.infusion_routes.append(entry)

    def base_env(self, p, t, cov) -> Dict[str, object]:
        env: Dict[str, object] = {"t": t}
        for name, i in self.param_index.items():
            env[name] = p[i]
        for name, _ in self.am.covariates:
            env[name] = cov(name, t)
        env.update(self.am.constants)
        return env

    def derived_env(self, p, t, cov) -> Dict[str, object]:
        return eval_stmts(self.am.derive_stmts, self.base_env(p, t, cov))

    def with_states(self, env, x):
        env = dict(env)
        for name, j in self.state_index.items():
            env[name] = x[j]
        return env

    def _dx(self, x, p, t, cov) -> list:
        env = self.with_states(self.derived_env(p, t, cov), x)
        env = eval_stmts(self.am.dynamics_stmts, env)
        return [env.get(f"dx:{name}", 0.0) for name in self.am.states]

    # -- role closures -------------------------------------------------------
    def make_dynamics(self):
        def diffeq(x, p, t, b, rateiv, cov):
            dx = with_inputs(self._dx(x, p, t, cov), self.bolus_routes, b)
            return with_inputs(dx, self.infusion_routes, rateiv)

        return diffeq

    def make_drift(self):
        def drift(x, p, t, rateiv, cov):
            return with_inputs(self._dx(x, p, t, cov), self.infusion_routes, rateiv)

        return drift

    def make_diffusion(self):
        am = self.am

        def diffusion(p, t, cov):
            env = eval_stmts(am.diffusion_stmts, self.derived_env(p, t, cov))
            return [env.get(f"noise:{name}", 0.0) for name in am.states]

        return diffusion

    def make_out(self):
        am = self.am

        def out(x, p, t, cov):
            env = self.with_states(self.derived_env(p, t, cov), x)
            env = eval_stmts(am.output_stmts, env)
            return stack_like([env.get(f"out:{name}", 0.0) for name in am.outputs], x)

        return out

    def make_init(self):
        am = self.am
        if not am.init_stmts:
            return None

        def init(p, t, cov):
            env = eval_stmts(am.init_stmts, self.derived_env(p, t, cov))
            return [env.get(f"init:{name}", 0.0) for name in am.states]

        return init

    def _route_table_fn(self, table: Dict[str, Stmt]):
        if not table:
            return None
        # label -> (input_index, expr)
        entries = []
        for input_index, _, label in self.bolus_routes:
            stmt = table.get(label)
            if stmt is not None:
                entries.append((input_index, stmt.value))

        def fn(p, t, cov):
            env = self.derived_env(p, t, cov)
            return {idx: eval_expr(expr, env) for idx, expr in entries}

        return fn

    def make_lag(self):
        return self._route_table_fn(self.am.route_lag)

    def make_fa(self):
        return self._route_table_fn(self.am.route_fa)

    def make_kernel_inputs(self):
        """The kernel-parameter mapping ``kernel_inputs(p, t, cov)`` of a
        closed form: its structure's parameters in kernel order, from the
        primary parameters, the covariates and the derived variables at time
        ``t``. The propagate evaluates it at each segment's end
        (:class:`~..models.declarative.KernelInputAnalytical`); the fused
        plan probes it (``plans/decompose.py::_decompose_kernel_inputs``)."""
        am = self.am
        plan = am.kernel_plan

        def kernel_inputs(p, t, cov):
            env = self.derived_env(p, t, cov)
            vals = []
            for source, index in plan.bindings:
                if source == "primary":
                    vals.append(p[index])
                elif source == "covariate":
                    vals.append(cov(am.covariates[index][0], t))
                else:
                    vals.append(env[am.derived[index]])
            return vals

        return kernel_inputs

    def make_bolus_dest(self) -> List[int]:
        dest = list(range(self.ninput))
        for input_index, d, _ in self.bolus_routes:
            if input_index < self.ninput:
                dest[input_index] = d
        return dest


@dataclass
class CompiledRuntimeModel:
    """Facade over a DSL-compiled model (runtime.rs CompiledRuntimeModel)."""

    model: object  # Analytical | ODE | SDE instance
    analyzed: AnalyzedModel
    source: Optional[str] = None

    @property
    def kind(self) -> str:
        return self.analyzed.kind.value

    def info(self) -> dict:
        """NativeModelInfo-equivalent JSON metadata (model_info.rs:17-100)."""
        md = self.model.metadata()
        return {
            "name": self.analyzed.name,
            "kind": self.kind,
            "parameters": self.analyzed.parameters,
            "covariates": [
                {"name": n, "interpolation": i} for n, i in self.analyzed.covariates
            ],
            "states": self.analyzed.states,
            "routes": [
                {
                    "name": r.name,
                    "kind": r.kind.value,
                    "destination": r.destination,
                    "input_index": r.input_index,
                    "has_lag": r.has_lag,
                    "has_bioavailability": r.has_bioavailability,
                }
                for r in md.validated_routes
            ],
            "outputs": [{"name": n} for n in self.analyzed.outputs],
            "particles": self.analyzed.particles,
            "analytical": self.analyzed.analytical_kernel,
            "state_len": len(self.analyzed.states),
            "route_len": md.route_input_count,
            "derived_len": len(self.analyzed.derived),
            "output_len": len(self.analyzed.outputs),
        }

    # delegate the Equation surface
    def estimate_predictions(self, subject, parameters, device=None):
        return self.model.estimate_predictions(subject, parameters, device=device)

    def estimate_log_likelihood(self, subject, parameters, error_models, device=None):
        return self.model.estimate_log_likelihood(subject, parameters, error_models,
                                                  device=device)

    def simulate_subject(self, subject, parameters, error_models=None, device=None):
        return self.model.simulate_subject(subject, parameters, error_models, device=device)

    def save_artifact(self, path: str) -> None:
        save_artifact(self, path)


def build_runtime_model(am: AnalyzedModel, source: Optional[str] = None,
                        ode_options: Optional[ODEOptions] = None) -> CompiledRuntimeModel:
    metadata = _build_metadata(am)
    builder = _RoleBuilder(am, metadata)
    if am.kind is DslModelKind.ANALYTICAL:
        model = KernelInputAnalytical(
            am.analytical_kernel, builder.make_kernel_inputs(), builder.make_bolus_dest(),
            out=builder.make_out(),
            init=builder.make_init(),
            lag=builder.make_lag(),
            fa=builder.make_fa(),
            nstates=builder.nstates,
            ndrugs=builder.ninput,
            nout=builder.nout,
        )
        model._metadata = metadata
    elif am.kind is DslModelKind.ODE:
        model = ODE(
            builder.make_dynamics(),
            lag=builder.make_lag(),
            fa=builder.make_fa(),
            init=builder.make_init(),
            out=builder.make_out(),
            nstates=builder.nstates,
            ndrugs=builder.ninput,
            nout=builder.nout,
        )
        if ode_options is not None:
            model._opts = ode_options
        model._metadata = metadata
    else:
        model = SDE(
            drift=builder.make_drift(),
            diffusion=builder.make_diffusion(),
            lag=builder.make_lag(),
            fa=builder.make_fa(),
            init=builder.make_init(),
            out=builder.make_out(),
            nparticles=am.particles,
            nstates=builder.nstates,
            ndrugs=builder.ninput,
            nout=builder.nout,
        )
        model._metadata = metadata
    return CompiledRuntimeModel(model=model, analyzed=am, source=source)


# -- pipeline entry points (pipeline.rs / runtime.rs parity) ------------------------


def compile_model(src: str, ode_options: Optional[ODEOptions] = None) -> CompiledRuntimeModel:
    """parse -> analyze -> build runtime (one model)."""
    ast = parse_model(src)
    am = analyze_model(ast)
    return build_runtime_model(am, source=src, ode_options=ode_options)


def compile_module(src: str) -> List[CompiledRuntimeModel]:
    module = parse_module(src)
    return [build_runtime_model(am, source=src) for am in analyze_module(module)]


def compile_module_source_to_runtime(
    src: str, name: Optional[str] = None, callback=None
) -> CompiledRuntimeModel:
    """runtime.rs:334 parity: compile source, optionally select a model by name."""
    if callback:
        callback("parse", "parsing module source")
    models = compile_module(src)
    if callback:
        callback("compile", f"compiled {len(models)} model(s)")
    if name is None:
        return models[0]
    for m in models:
        if m.analyzed.name == name:
            return m
    raise DslError(
        Diagnostic.error(
            "DSL4001",
            f"module does not contain a model named `{name}` "
            f"(have: {', '.join(m.analyzed.name for m in models)})",
        )
    )


# -- artifacts: the AOT/.pkm equivalent -----------------------------------------------


def _am_to_json(am: AnalyzedModel) -> dict:
    return {
        "name": am.name,
        "kind": am.kind.value,
        "parameters": am.parameters,
        "covariates": [[n, i] for n, i in am.covariates],
        "states": am.states,
        "state_arrays": am.state_arrays,
        "derived": am.derived,
        "outputs": am.outputs,
        "constants": am.constants,
        "routes": [
            {
                "input": r.input,
                "destination": r.destination,
                "kind": (r.kind or DslRouteKind.BOLUS).value,
            }
            for r in am.routes
        ],
        "route_lag": {k: v.to_json() for k, v in am.route_lag.items()},
        "route_fa": {k: v.to_json() for k, v in am.route_fa.items()},
        "derive": [s.to_json() for s in am.derive_stmts],
        "dynamics": [s.to_json() for s in am.dynamics_stmts],
        "outputs_stmts": [s.to_json() for s in am.output_stmts],
        "init": [s.to_json() for s in am.init_stmts],
        "diffusion": [s.to_json() for s in am.diffusion_stmts],
        "output_annotations": {
            k: [v[0], [e.to_json() for e in v[1]]] for k, v in am.output_annotations.items()
        },
        "analytical": am.analytical_kernel,
        "kernel_plan": (
            {"kernel": am.kernel_plan.kernel, "bindings": am.kernel_plan.bindings}
            if am.kernel_plan
            else None
        ),
        "particles": am.particles,
    }


def _am_from_json(data: dict) -> AnalyzedModel:
    plan = None
    if data.get("kernel_plan"):
        plan = KernelPlan(
            kernel=data["kernel_plan"]["kernel"],
            bindings=[tuple(b) for b in data["kernel_plan"]["bindings"]],
        )
    return AnalyzedModel(
        name=data["name"],
        kind=DslModelKind(data["kind"]),
        parameters=data["parameters"],
        covariates=[tuple(c) for c in data["covariates"]],
        states=data["states"],
        state_arrays={k: int(v) for k, v in data.get("state_arrays", {}).items()},
        derived=data["derived"],
        outputs=data["outputs"],
        constants=data["constants"],
        routes=[
            RouteDeclAst(r["input"], r["destination"], DslRouteKind(r["kind"]))
            for r in data["routes"]
        ],
        route_lag={k: Stmt.from_json(v) for k, v in data["route_lag"].items()},
        route_fa={k: Stmt.from_json(v) for k, v in data["route_fa"].items()},
        derive_stmts=[Stmt.from_json(s) for s in data["derive"]],
        dynamics_stmts=[Stmt.from_json(s) for s in data["dynamics"]],
        output_stmts=[Stmt.from_json(s) for s in data["outputs_stmts"]],
        init_stmts=[Stmt.from_json(s) for s in data["init"]],
        diffusion_stmts=[Stmt.from_json(s) for s in data["diffusion"]],
        output_annotations={
            k: (v[0], [Expr.from_json(e) for e in v[1]])
            for k, v in data.get("output_annotations", {}).items()
        },
        analytical_kernel=data.get("analytical"),
        kernel_plan=plan,
        particles=data.get("particles"),
    )


def save_artifact(runtime: CompiledRuntimeModel, path: str) -> None:
    """Serialize the compiled model IR to a versioned .pkm JSON artifact."""
    payload = {
        "format": ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "model": _am_to_json(runtime.analyzed),
        "info": runtime.info(),
        "source": runtime.source,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def artifact_schema() -> dict:
    """The published JSON Schema for the .pkm artifact (``schemas/pkm-v1.json``
    at the repository root, shared with the JAX package).

    Counterpart of the reference's schemas/model-v2.json (:1-40 — editor
    tooling validation surface); here the schema pins the compiled IR
    that every `.pkm` host consumes.
    """
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with open(os.path.join(root, "schemas", "pkm-v1.json")) as f:
        return json.load(f)


def validate_artifact(payload) -> None:
    """Validate a .pkm payload (dict or path) against schemas/pkm-v1.json.

    Raises DslError DSL4004 with the schema path on failure. Needs the
    optional ``jsonschema`` package; without it the check is skipped.
    """
    if isinstance(payload, str):
        with open(payload) as f:
            payload = json.load(f)
    try:
        import jsonschema
    except ImportError:  # validation is optional tooling, not a core dep
        return
    try:
        jsonschema.validate(payload, artifact_schema())
    except jsonschema.ValidationError as e:
        raise DslError(
            Diagnostic.error(
                "DSL4004",
                f"artifact does not match schemas/pkm-v1.json at "
                f"{'/'.join(str(x) for x in e.absolute_path) or '<root>'}: "
                f"{e.message}",
                Span.empty(),
            )
        )


def load_runtime_artifact(path: str, validate: bool = False) -> CompiledRuntimeModel:
    """Load a .pkm artifact back into a runnable model (aot.rs:316 parity).

    ``validate=True`` checks the payload against the published JSON
    Schema (schemas/pkm-v1.json) before building, turning malformed
    hand-edited artifacts into a located DSL4004 diagnostic instead of a
    KeyError deep in IR reconstruction.
    """
    with open(path) as f:
        payload = json.load(f)
    if validate:
        validate_artifact(payload)
    if payload.get("format") != ARTIFACT_FORMAT:
        raise DslError(
            Diagnostic.error(
                "DSL4002", f"`{path}` is not a pharmsol-tpu artifact",
                Span.empty(),
            )
        )
    if payload.get("version", 0) > ARTIFACT_VERSION:
        raise DslError(
            Diagnostic.error(
                "DSL4003",
                f"artifact version {payload['version']} is newer than supported "
                f"({ARTIFACT_VERSION})",
                Span.empty(),
            )
        )
    am = _am_from_json(payload["model"])
    return build_runtime_model(am, source=payload.get("source"))
