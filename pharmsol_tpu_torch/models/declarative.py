"""Declarative Python model API — the proc-macro surface equivalent.

The counterpart of the JAX package's ``models/declarative.py``. The
reference's ``ode!/analytical!/sde!`` macros (pharmsol-macros) let users
write models with symbolic state/parameter/covariate names that are rewritten
to dense indices at compile time. The Python equivalent needs no
metaprogramming: user callbacks receive attribute namespaces, return dicts
keyed by declared names, and routes inject doses into their destination
states exactly like the DSL.

Example::

    model = ode_model(
        name="one_cmt_oral",
        parameters=["ka", "ke", "v", "tlag"],
        states=["depot", "central"],
        outputs=["cp"],
        routes=[Route.bolus("oral").to_state("depot")],
        dynamics=lambda s, p, t, cov: {
            "depot": -p.ka * s.depot,
            "central": p.ka * s.depot - p.ke * s.central,
        },
        out=lambda s, p, t, cov: {"cp": s.central / p.v},
        lag=lambda p, t, cov: {"oral": p.tlag},
    )

Covariates are read as ``cov.wt`` (interpolated at the callback's time).
Callbacks use torch operations (``torch.exp``, ``torch.minimum``, ...) on
the values they are handed.

The closures built here have the DSL runtime's shape (``dsl/runtime.py``):
the dynamics, drift, diffusion and init return lists of per-state scalar
expressions with each route's input added as a scalar, so that the CUDA
generator (``ops/rhs_codegen.py``) traces them into the fused ODE and SDE
kernels; a closed form keeps its kernel-input mapping, which the fused
closed-form plan decomposes into kernel K1a/K1b's inputs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..engine.sim import ModelSpec, as_vector
from ..errors import PharmsolError
from ..metadata import (
    AnalyticalKernel,
    CovariateDecl,
    ModelKind,
    ModelMetadata,
    Route,
    RouteKind,
)
from .equation import ODE, Analytical
from .sde import SDE


def stack_like(values, like: torch.Tensor) -> torch.Tensor:
    """Scalar expressions as one vector of ``like``'s dtype and device (the
    JAX package's ``jnp.stack([v + 0.0 * x[0] ...])``)."""
    return torch.stack([torch.as_tensor(v, dtype=like.dtype, device=like.device)
                        + 0.0 * like[0] for v in values])


def with_inputs(dx: list, routes, u) -> list:
    """``dx`` with each route's input ``u[j]`` added to its destination
    state, component by component (``routes``: (input, destination, label))."""
    dx = list(dx)
    for input_index, dest, _ in routes:
        dx[dest] = dx[dest] + u[input_index]
    return dx


class Names:
    """Attribute namespace over named traced values."""

    __slots__ = ("_values",)

    def __init__(self, values: Dict[str, object]):
        object.__setattr__(self, "_values", values)

    def __getattr__(self, name):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(
                f"unknown name `{name}` (have: {', '.join(self._values)})"
            )

    def __getitem__(self, name):
        return self._values[name]


class CovNames:
    """Attribute access over covariates bound to a time point."""

    __slots__ = ("_view", "_t")

    def __init__(self, view, t):
        object.__setattr__(self, "_view", view)
        object.__setattr__(self, "_t", t)

    def __getattr__(self, name):
        return self._view.value(name, self._t)

    def __getitem__(self, name):
        return self._view.value(name, self._t)

    def at(self, name, t):
        """Interpolate a covariate at an explicit time."""
        return self._view.value(name, t)


def _metadata_for(
    kind: ModelKind,
    name: str,
    parameters: Sequence[str],
    states: Sequence[str],
    outputs: Sequence[str],
    routes: Sequence[Route],
    covariates: Sequence = (),
    particles: Optional[int] = None,
    analytical: Optional[str] = None,
    lag_routes: Sequence[str] = (),
    fa_routes: Sequence[str] = (),
):
    md = ModelMetadata(name)
    md.parameters(list(parameters))
    md.states(list(states))
    md.outputs(list(outputs))
    md.covariates(
        [c if isinstance(c, CovariateDecl) else CovariateDecl(str(c)) for c in covariates]
    )
    for r in routes:
        r.inject_input_to_destination()
        if r.name in lag_routes:
            r.with_lag()
        if r.name in fa_routes:
            r.with_bioavailability()
        md.route(r)
    if analytical:
        md.analytical_kernel(AnalyticalKernel(analytical))
    if particles is not None:
        md.particles(particles)
        return md.validate_for(ModelKind.SDE)
    return md.validate_for(kind)


def _route_tables(metadata):
    bolus = [
        (r.input_index, r.destination_index, r.name)
        for r in metadata.validated_routes
        if r.kind is RouteKind.BOLUS
    ]
    infusion = [
        (r.input_index, r.destination_index, r.name)
        for r in metadata.validated_routes
        if r.kind is RouteKind.INFUSION
    ]
    return bolus, infusion


def _bolus_routes_if(fn, routes) -> List[str]:
    return [r.name for r in routes if r.kind is RouteKind.BOLUS] if fn else []


def _wrap_route_fn(fn: Optional[Callable], metadata, parameters, kind: str):
    """User fn (p, t, cov) -> {route_label: value} into engine {input_idx: value}."""
    if fn is None:
        return None
    label_to_input = {
        r.name: r.input_index
        for r in metadata.validated_routes
        if r.kind is RouteKind.BOLUS
    }
    pnames = list(parameters)

    def wrapped(p, t, cov):
        table = fn(Names({n: p[i] for i, n in enumerate(pnames)}), t, CovNames(cov, t))
        out = {}
        for label, value in table.items():
            if label not in label_to_input:
                raise PharmsolError(f"{kind}() names unknown bolus route `{label}`")
            out[label_to_input[label]] = value
        return out

    return wrapped


def _dx_from_dict(d: Dict[str, object], states: List[str]) -> list:
    missing = [s for s in states if s not in d]
    if missing:
        raise PharmsolError(f"dynamics is missing states {missing}")
    return [d[s] for s in states]


def _out_fn(out: Callable, states, parameters, outputs):
    def out_fn(x, p, t, cov):
        s = Names({n: x[i] for i, n in enumerate(states)})
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        d = out(s, pn, t, CovNames(cov, t))
        return stack_like([d.get(o, 0.0) for o in outputs], x)

    return out_fn


def _init_fn(init: Optional[Callable], states, parameters):
    if init is None:
        return None

    def init_fn(p, t, cov):
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        d = init(pn, t, CovNames(cov, t))
        return [d.get(s_, 0.0) for s_ in states]

    return init_fn


def ode_model(
    *,
    name: str = "model",
    parameters: Sequence[str],
    states: Sequence[str],
    outputs: Sequence[str],
    routes: Sequence[Route] = (),
    covariates: Sequence = (),
    dynamics: Callable,
    out: Callable,
    init: Optional[Callable] = None,
    lag: Optional[Callable] = None,
    fa: Optional[Callable] = None,
) -> ODE:
    """Build an ODE model from named callbacks (ode! macro equivalent).

    ``dynamics(s, p, t, cov) -> {state: dx}`` (dose terms auto-injected from
    routes); ``out(s, p, t, cov) -> {output: value}``;
    ``init(p, t, cov) -> {state: value}``;
    ``lag/fa(p, t, cov) -> {route_label: value}``.
    """
    parameters = list(parameters)
    states = list(states)
    outputs = list(outputs)
    metadata = _metadata_for(
        ModelKind.ODE, name, parameters, states, outputs, list(routes), covariates,
        lag_routes=_bolus_routes_if(lag, routes), fa_routes=_bolus_routes_if(fa, routes),
    )
    bolus_routes, infusion_routes = _route_tables(metadata)

    def diffeq(x, p, t, b, rateiv, cov):
        s = Names({n: x[i] for i, n in enumerate(states)})
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        dx = _dx_from_dict(dynamics(s, pn, t, CovNames(cov, t)), states)
        dx = with_inputs(dx, bolus_routes, b)
        return with_inputs(dx, infusion_routes, rateiv)

    model = ODE(
        diffeq,
        lag=_wrap_route_fn(lag, metadata, parameters, "lag"),
        fa=_wrap_route_fn(fa, metadata, parameters, "fa"),
        init=_init_fn(init, states, parameters),
        out=_out_fn(out, states, parameters, outputs),
        nstates=len(states),
        ndrugs=max(metadata.route_input_count, 1),
        nout=len(outputs),
    )
    model._metadata = metadata
    return model


class KernelInputAnalytical(Analytical):
    """A closed form over a built-in structure whose kernel inputs come from
    a mapping of the declared parameters, ``kernel_inputs(p, t, cov)``
    (the declarative API's derive, the DSL's kernel plan), re-derived at
    each segment's end; boluses land in their routes' destinations
    (``bolus_dest``, one state per input). ``_fused_structure``,
    ``_kernel_inputs`` and ``_bolus_dest`` are the fused plan's hooks
    (``likelihood/plans/analytical.py::_FusedPsiPlan``)."""

    def __init__(self, structure: str, kernel_inputs: Callable, bolus_dest: List[int],
                 **kwargs):
        super().__init__(eq=None, **kwargs)
        self._fused_structure = structure
        self._kernel_inputs = kernel_inputs
        self._bolus_dest = list(bolus_dest)

    def _build_spec(self) -> ModelSpec:
        from ..engine.analytical import KERNELS

        kernel_fn = KERNELS[self._fused_structure][0]
        kernel_inputs = self._kernel_inputs
        dest, nstates = self._bolus_dest, self._nstates

        def propagate(x, p, dt, rateiv, t0, cov):
            # kernel inputs advance to the segment END, matching the engine
            # seq path and the reference (analytical/mod.rs:360
            # seq_eq(parameters, next_t))
            kp = as_vector(kernel_inputs(p, t0 + dt, cov), x)
            return kernel_fn(x, kp, dt, rateiv, cov).to(x.dtype)

        def apply_bolus(x, bvec, p, t, rateiv, cov):
            # input i adds into state dest[i] (one-hot rows: runs under vmap)
            onehot = torch.zeros((len(dest), nstates), dtype=x.dtype, device=x.device)
            onehot[torch.arange(len(dest)), torch.as_tensor(dest)] = 1.0
            return x + bvec.to(x.dtype) @ onehot

        return ModelSpec(
            nstates=self._nstates,
            ninput=self._ndrugs,
            nout=self._nout,
            propagate=propagate,
            out=self._out,
            init=self._init,
            lag=self._lag,
            fa=self._fa,
            seq=None,
            apply_bolus=apply_bolus,
        )


def analytical_model(
    *,
    name: str = "model",
    structure: str,
    parameters: Sequence[str],
    states: Sequence[str],
    outputs: Sequence[str],
    routes: Sequence[Route] = (),
    covariates: Sequence = (),
    out: Callable,
    derive: Optional[Callable] = None,
    init: Optional[Callable] = None,
    lag: Optional[Callable] = None,
    fa: Optional[Callable] = None,
) -> Analytical:
    """Analytical model over a built-in kernel (analytical! macro parity).

    ``structure`` names one of the 12 closed-form kernels; its required
    parameter names are looked up among ``parameters`` or in the dict
    returned by ``derive(p, t, cov)``.
    """
    from ..dsl.analyze import KERNEL_REQUIRED_NAMES
    from ..engine.analytical import KERNELS

    if structure not in KERNELS:
        raise PharmsolError(
            f"unknown analytical structure `{structure}` (have {sorted(KERNELS)})"
        )
    _, kernel_states, _ = KERNELS[structure]
    parameters = list(parameters)
    states = list(states)
    outputs = list(outputs)
    if len(states) != kernel_states:
        raise PharmsolError(
            f"structure `{structure}` has {kernel_states} states, model declares "
            f"{len(states)}"
        )
    required = KERNEL_REQUIRED_NAMES[structure]

    metadata = _metadata_for(
        ModelKind.ANALYTICAL, name, parameters, states, outputs, list(routes),
        covariates, analytical=structure,
        lag_routes=_bolus_routes_if(lag, routes), fa_routes=_bolus_routes_if(fa, routes),
    )
    bolus_routes, _ = _route_tables(metadata)
    dest = [i for i in range(max(metadata.route_input_count, 1))]
    for input_index, d, _ in bolus_routes:
        if input_index < len(dest):
            dest[input_index] = d

    def kernel_inputs(p, t, cov):
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        derived = derive(pn, t, CovNames(cov, t)) if derive else {}
        vals = []
        for req in required:
            if req in derived:
                vals.append(derived[req])
            elif req in parameters:
                vals.append(p[parameters.index(req)])
            else:
                raise PharmsolError(
                    f"structure `{structure}` requires parameter `{req}` "
                    f"(declare it or return it from derive)"
                )
        return vals

    model = KernelInputAnalytical(
        structure, kernel_inputs, dest,
        out=_out_fn(out, states, parameters, outputs),
        init=_init_fn(init, states, parameters),
        lag=_wrap_route_fn(lag, metadata, parameters, "lag"),
        fa=_wrap_route_fn(fa, metadata, parameters, "fa"),
        nstates=len(states),
        ndrugs=max(metadata.route_input_count, 1),
        nout=len(outputs),
    )
    model._metadata = metadata
    return model


def sde_model(
    *,
    name: str = "model",
    parameters: Sequence[str],
    states: Sequence[str],
    outputs: Sequence[str],
    routes: Sequence[Route] = (),
    covariates: Sequence = (),
    drift: Callable,
    diffusion: Callable,
    out: Callable,
    init: Optional[Callable] = None,
    lag: Optional[Callable] = None,
    fa: Optional[Callable] = None,
    nparticles: int = 100,
    seed: int = 0,
) -> SDE:
    """SDE model from named callbacks (sde! macro equivalent).

    ``drift(s, p, t, cov) -> {state: dx}``;
    ``diffusion(p, t, cov) -> {state: noise_sd}`` (absent states get 0).
    """
    parameters = list(parameters)
    states = list(states)
    outputs = list(outputs)
    metadata = _metadata_for(
        ModelKind.SDE, name, parameters, states, outputs, list(routes), covariates,
        particles=nparticles,
        lag_routes=_bolus_routes_if(lag, routes), fa_routes=_bolus_routes_if(fa, routes),
    )
    _, infusion_routes = _route_tables(metadata)

    def drift_fn(x, p, t, rateiv, cov):
        s = Names({n: x[i] for i, n in enumerate(states)})
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        dx = _dx_from_dict(drift(s, pn, t, CovNames(cov, t)), states)
        return with_inputs(dx, infusion_routes, rateiv)

    def diffusion_fn(p, t, cov):
        pn = Names({n: p[i] for i, n in enumerate(parameters)})
        d = diffusion(pn, t, CovNames(cov, t))
        return [d.get(s_, 0.0) for s_ in states]

    model = SDE(
        drift=drift_fn,
        diffusion=diffusion_fn,
        lag=_wrap_route_fn(lag, metadata, parameters, "lag"),
        fa=_wrap_route_fn(fa, metadata, parameters, "fa"),
        init=_init_fn(init, states, parameters),
        out=_out_fn(out, states, parameters, outputs),
        nparticles=nparticles,
        nstates=len(states),
        ndrugs=max(metadata.route_input_count, 1),
        nout=len(outputs),
        seed=seed,
    )
    model._metadata = metadata
    return model
