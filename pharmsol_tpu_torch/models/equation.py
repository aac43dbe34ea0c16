"""Equation families of the PyTorch port: Analytical and ODE.

Public surface parity with the JAX package's ``models/equation.py`` (and the
reference ``Equation`` trait, equation/mod.rs:377-577):

- ``estimate_predictions(subject, parameters)`` -> SubjectPredictions
- ``estimate_log_likelihood(subject, parameters, error_models)`` -> float
- ``estimate_likelihood`` (deprecated, = exp(log_likelihood))
- ``simulate_subject(subject, parameters, error_models)`` -> (preds, lik)
- the builder methods ``with_nstates/with_ndrugs/with_nout/with_metadata``,
  the accessors, label resolution, the host lowering cache, and the
  single-subject cache (``with_cache_capacity/enable_cache/clear_cache/
  disable_cache``, simulator/cache.rs).

Each single-subject call runs the general engine's segment march
(``engine/sim.py``) on one row per occasion, on the card unless the caller
passes ``device="cpu"`` or has called ``set_device("cpu")``; the results
come back to the host as Python floats. The differentiable surface of the
JAX package (``log_likelihood_fn``) is not ported.

Label resolution parity (equation/mod.rs:195-273): with metadata attached,
route/output labels resolve by name (with ``input_<n>``/``outeq_<n>`` numeric
aliases); without metadata, bare numeric labels become dense indices.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import float_dtype, resolve_device
from ..data.error_model import AssayErrorModels
from ..data.structs import Subject
from ..engine.grid import OccasionArrays, PopulationGrid, lower_population
from ..engine.ode import ODEOptions, make_ode_propagate, make_ode_propagate_carry
from ..engine.sim import (
    ModelSpec,
    OccasionSim,
    default_apply_bolus,
    rhs_difference_apply_bolus,
    simulate_occasion,
    simulate_occasion_ll,
)
from ..errors import (
    InputOutOfRangeError,
    PharmsolError,
    SolverError,
    unknown_input_label,
    unknown_output_label,
)
from ..likelihood.prediction import Prediction, SubjectPredictions
from ..metadata import ModelKind, ModelMetadata, RouteKind, ValidatedModelMetadata
from ..utils.cache import DEFAULT_CACHE_SIZE, LruCache


def _as_dense_params(parameters) -> np.ndarray:
    # +0.0 normalizes -0.0 so both hash to the same cache key (the reference
    # normalizes the sign bit in parameters_hash, equation/mod.rs:600-609)
    if isinstance(parameters, torch.Tensor):
        parameters = parameters.detach().cpu().numpy()
    return np.asarray(parameters, dtype=np.float64).reshape(-1) + 0.0


class EquationBase:
    """Shared simulation, likelihood, lowering and label machinery for the
    equation families."""

    kind: str = "base"

    def __init__(self, nstates: int = 5, ndrugs: int = 5, nout: int = 5):
        self._nstates = nstates
        self._ndrugs = ndrugs
        self._nout = nout
        self._metadata: Optional[ValidatedModelMetadata] = None
        self._lower_cache: Dict[tuple, PopulationGrid] = {}
        self._spec_cache: Optional[ModelSpec] = None
        # (subject hash, parameter bytes[, error-model hash], device, dtype)
        # -> result, for the single-subject API (cache.rs parity)
        self._pred_cache: Optional[LruCache] = LruCache(DEFAULT_CACHE_SIZE)

    # -- builder API ----------------------------------------------------------
    def with_nstates(self, nstates: int):
        self._nstates = int(nstates)
        self._invalidate()
        return self

    def with_ndrugs(self, ndrugs: int):
        self._ndrugs = int(ndrugs)
        self._invalidate()
        return self

    def with_nout(self, nout: int):
        self._nout = int(nout)
        self._invalidate()
        return self

    def with_metadata(self, metadata: ModelMetadata):
        validated = (
            metadata
            if isinstance(metadata, ValidatedModelMetadata)
            else metadata.validate_for(self._model_kind())
        )
        self._validate_metadata_dimensions(validated)
        self._metadata = validated
        self._invalidate()
        return self

    def _validate_metadata_dimensions(self, md: ValidatedModelMetadata) -> None:
        if len(md.state_names) != self._nstates:
            raise PharmsolError(
                f"metadata declares {len(md.state_names)} states but model has "
                f"{self._nstates}"
            )
        if md.route_input_count != self._ndrugs:
            raise PharmsolError(
                f"metadata declares {md.route_input_count} route inputs but model "
                f"has {self._ndrugs}"
            )
        if len(md.output_names) != self._nout:
            raise PharmsolError(
                f"metadata declares {len(md.output_names)} outputs but model has "
                f"{self._nout}"
            )

    def _invalidate(self):
        self._lower_cache.clear()
        self._spec_cache = None
        if self._pred_cache is not None:
            self._pred_cache.invalidate_all()

    def _model_kind(self) -> ModelKind:
        raise NotImplementedError

    # -- reference-parity accessors ---------------------------------------------
    def metadata(self) -> Optional[ValidatedModelMetadata]:
        return self._metadata

    def nstates(self) -> int:
        return self._nstates

    def nouteqs(self) -> int:
        return self._nout

    def ndrugs(self) -> int:
        return self._ndrugs

    def parameter_index(self, name: str) -> Optional[int]:
        return self._metadata.parameter_index(name) if self._metadata else None

    def covariate_index(self, name: str) -> Optional[int]:
        return self._metadata.covariate_index(name) if self._metadata else None

    def state_index(self, name: str) -> Optional[int]:
        return self._metadata.state_index(name) if self._metadata else None

    def assay_error_models(self) -> AssayErrorModels:
        if self._metadata is not None:
            return AssayErrorModels.with_output_names(self._metadata.output_names)
        return AssayErrorModels.empty()

    # -- label resolution (equation/mod.rs:195-245) -------------------------------
    def resolve_input_label(self, label, kind: str) -> int:
        label_s = str(label)
        if self._metadata is not None:
            rk = RouteKind.BOLUS if kind == "bolus" else RouteKind.INFUSION
            route = self._metadata.route_for_label(label_s, rk)
            if route is None:
                other = RouteKind.INFUSION if rk is RouteKind.BOLUS else RouteKind.BOLUS
                if self._metadata.route_for_label(label_s, other) is not None:
                    raise PharmsolError(
                        f"route `{label_s}` does not support {kind} dosing"
                    )
                raise unknown_input_label(label_s, self._metadata.route_labels())
            idx = route.input_index
        else:
            if not label_s.isdigit():
                raise unknown_input_label(label_s)
            idx = int(label_s)
        if idx >= self._ndrugs:
            raise InputOutOfRangeError(idx, self._ndrugs)
        return idx

    def resolve_output_label(self, label) -> int:
        label_s = str(label)
        if self._metadata is not None:
            idx = self._metadata.output_for_label(label_s)
            if idx is None:
                raise unknown_output_label(label_s, self._metadata.output_labels())
            return idx
        if not label_s.isdigit():
            raise unknown_output_label(label_s)
        idx = int(label_s)
        if idx >= self._nout:
            raise unknown_output_label(
                label_s, [str(i) for i in range(self._nout)]
            )
        return idx

    # -- lowering ------------------------------------------------------------------
    def _cov_names(self, subjects: Sequence[Subject]) -> List[str]:
        if self._metadata is not None and self._metadata.covariate_decls:
            return self._metadata.covariate_names()
        names = set()
        for s in subjects:
            for occ in s.occasions():
                names.update(occ.covariates.names())
        return sorted(names)

    def lower(self, subjects: Sequence[Subject]) -> PopulationGrid:
        """Host lowering of ``subjects``, cached by their content hashes."""
        key = tuple(s.hash() for s in subjects)
        grid = self._lower_cache.get(key)
        if grid is None:
            grid = lower_population(
                subjects,
                self.resolve_input_label,
                self.resolve_output_label,
                self._cov_names(subjects),
            )
            if len(self._lower_cache) > 64:
                self._lower_cache.clear()
            self._lower_cache[key] = grid
        return grid

    # -- spec ---------------------------------------------------------------------
    def _build_spec(self) -> ModelSpec:
        raise NotImplementedError

    @property
    def spec(self) -> ModelSpec:
        if self._spec_cache is None:
            self._spec_cache = self._build_spec()
        return self._spec_cache

    # -- the rows' marches (the SDE family overrides them) ---------------------------
    def _sim_rows(self, rows: OccasionArrays, p: torch.Tensor, cov_names) -> OccasionSim:
        """The prediction march of every row at every support point ``p``
        [S, n_params]: results over [S, R, NO]."""
        return simulate_occasion(self.spec, rows, p, cov_names)

    def _ll_rows(self, rows: OccasionArrays, p: torch.Tensor, em_kind, em_factor,
                 em_poly, cov_names) -> torch.Tensor:
        """The log-likelihood [S, R] of every row at every support point."""
        return simulate_occasion_ll(self.spec, rows, p, em_kind, em_factor, em_poly,
                                    cov_names)

    def _batch_predictions(self, rows: OccasionArrays, p_rows: torch.Tensor,
                           cov_names) -> torch.Tensor:
        """The predictions [R, NO] of every row under its own parameter row
        (``p_rows`` [R, n_params]), one cell per row."""
        return simulate_occasion(self.spec, rows, p_rows, cov_names, per_row=True).pred[0]

    # -- device-level entry points ---------------------------------------------------
    def sim_population(self, grid: PopulationGrid, parameters, device=None):
        """The prediction march of every row of ``grid`` under one parameter
        vector, on ``device`` (default: the card): the march's results with
        a leading row axis ([R, NO], as the JAX package's)."""
        from ..likelihood.matrix import _device_rows

        dev, fd = resolve_device(device), float_dtype()
        p = torch.as_tensor(_as_dense_params(parameters), dtype=fd, device=dev)
        sim = self._sim_rows(_device_rows(grid, dev, fd), p[None], grid.cov_names)
        return type(sim)(*(a[0] for a in sim))

    def ll_population(self, grid: PopulationGrid, parameters, lowered_em,
                      device=None) -> torch.Tensor:
        """The log-likelihood [R] of every row of ``grid`` under one
        parameter vector, with the lowered assay error models."""
        from ..likelihood.matrix import _device_rows, lowered_tensors

        dev, fd = resolve_device(device), float_dtype()
        p = torch.as_tensor(_as_dense_params(parameters), dtype=fd, device=dev)
        em = lowered_tensors(lowered_em, dev, fd)
        return self._ll_rows(_device_rows(grid, dev, fd), p[None], *em, grid.cov_names)[0]

    # -- public API (reference Equation trait) ------------------------------------------
    def _cache_key(self, *parts, device) -> Optional[tuple]:
        if self._pred_cache is None:
            return None
        return parts + (str(device), str(float_dtype()))

    def estimate_predictions(self, subject: Subject, parameters,
                             device=None) -> SubjectPredictions:
        """The subject's predictions at ``parameters`` (dense, model order),
        computed on ``device`` (default: the card). Raises SolverError with
        the subject's id and the parameters when a prediction is not
        finite (error/mod.rs:82-110): the population paths degrade to -inf
        instead."""
        dev = resolve_device(device)
        dense = _as_dense_params(parameters)
        key = self._cache_key("pred", subject.hash(), dense.tobytes(), device=dev)
        if key is not None:
            cached = self._pred_cache.get(key)
            if cached is not None:
                return cached
        grid = self.lower([subject])
        sim = self.sim_population(grid, dense, device=dev)
        result = self._assemble_subject_predictions(subject, grid, sim)
        if any(not np.isfinite(p.prediction) for p in result.predictions()):
            raise SolverError(
                "simulation produced non-finite predictions",
                subject_id=subject.id,
                parameters=list(map(float, dense)),
            )
        if key is not None:
            self._pred_cache.insert(key, result)
        return result

    def simulate_subject(
        self, subject: Subject, parameters,
        error_models: Optional[AssayErrorModels] = None, device=None,
    ) -> Tuple[SubjectPredictions, Optional[float]]:
        preds = self.estimate_predictions(subject, parameters, device=device)
        lik = None
        if error_models is not None:
            lik = float(np.exp(self.estimate_log_likelihood(
                subject, parameters, error_models, device=device)))
        return preds, lik

    def estimate_log_likelihood(self, subject: Subject, parameters,
                                error_models: AssayErrorModels, device=None) -> float:
        """The subject's log-likelihood at ``parameters`` with observation-
        based sigma (the psi cell of this subject and support point),
        computed on ``device`` (default: the card)."""
        from ..likelihood.matrix import check_error_model_coverage

        dev = resolve_device(device)
        dense = _as_dense_params(parameters)
        key = self._cache_key("ll", subject.hash(), dense.tobytes(),
                              error_models.content_hash(), device=dev)
        if key is not None:
            cached = self._pred_cache.get(key)
            if cached is not None:
                return cached
        grid = self.lower([subject])
        lowered = error_models.lower(self.resolve_output_label, self._nout)
        check_error_model_coverage(grid, lowered)
        result = float(self.ll_population(grid, dense, lowered, device=dev).sum())
        if key is not None:
            self._pred_cache.insert(key, result)
        return result

    def estimate_likelihood(self, subject: Subject, parameters,
                            error_models: AssayErrorModels, device=None) -> float:
        """Deprecated: exp(estimate_log_likelihood)."""
        return float(np.exp(self.estimate_log_likelihood(subject, parameters, error_models,
                                                         device=device)))

    # -- host assembly ---------------------------------------------------------------------
    def _assemble_subject_predictions(self, subject: Subject, grid: PopulationGrid,
                                      sim) -> SubjectPredictions:
        return self._assemble(subject, sim.pred, sim.state)

    def _assemble(self, subject: Subject, pred: torch.Tensor,
                  state: torch.Tensor) -> SubjectPredictions:
        """One Prediction per observation of the subject, from the march's
        predictions [R, NO] and states [R, NO, nstates] (one row per
        occasion)."""
        pred = pred.detach().cpu().numpy()
        state = state.detach().cpu().numpy()
        out = SubjectPredictions()
        for row, occ in enumerate(subject.occasions()):
            for i, obs in enumerate(occ.observations()):
                out.add_prediction(
                    Prediction(
                        time=obs.time,
                        observation=obs.value,
                        prediction=float(pred[row, i]),
                        outeq=self.resolve_output_label(obs.outeq),
                        errorpoly=obs.errorpoly,
                        state=[float(v) for v in state[row, i]],
                        occasion=occ.index,
                        censoring=obs.censoring,
                    )
                )
        return out

    # -- cache API (simulator/cache.rs parity) ----------------------------------------
    def with_cache_capacity(self, size: int):
        self._pred_cache = LruCache(size)
        return self

    def enable_cache(self):
        self._pred_cache = LruCache(DEFAULT_CACHE_SIZE)
        return self

    def clear_cache(self):
        self._lower_cache.clear()
        if self._pred_cache is not None:
            self._pred_cache.invalidate_all()

    def disable_cache(self):
        self._pred_cache = None
        return self


class Analytical(EquationBase):
    """Closed-form analytical equation family.

    Parity: analytical/mod.rs and the JAX package's ``Analytical``
    (``models/equation.py:531-623``). ``eq(x, p, dt, rateiv, cov) -> x``
    advances one smooth segment; ``out(x, p, t, cov) -> y`` maps the state to
    the outputs. ``seq_eq(p, t, cov) -> p`` (secondary equations) accumulates
    within an inter-event span and resets at events; ``lag`` and ``fa``
    ``(p, t, cov) -> {input: value}`` (or a [ninput] vector) shift and scale
    boluses; ``init(p, t, cov) -> x0`` sets the state of occasion 0. Every
    closure reads covariates through ``cov(name, t)``.
    """

    kind = "analytical"

    def __init__(
        self,
        eq: Callable,
        seq_eq: Optional[Callable] = None,
        lag: Optional[Callable] = None,
        fa: Optional[Callable] = None,
        init: Optional[Callable] = None,
        out: Optional[Callable] = None,
        nstates: int = 5,
        ndrugs: int = 5,
        nout: int = 5,
    ):
        super().__init__(nstates, ndrugs, nout)
        self._eq = eq
        self._seq = seq_eq
        self._lag = lag
        self._fa = fa
        self._init = init
        self._out = out

    def _model_kind(self) -> ModelKind:
        return ModelKind.ANALYTICAL

    def _build_spec(self) -> ModelSpec:
        eq = self._eq

        def propagate(x, p, dt, rateiv, t0, cov):
            return eq(x, p, dt, rateiv, cov)

        # built-in kernels without secondary equations use the hoisted
        # prepare/apply split: eigen decompositions leave the segment march
        prepare = propagate_prepared = None
        from ..engine.analytical import PREPARED_BY_FN

        pair = PREPARED_BY_FN.get(eq) if self._seq is None else None
        if pair is not None:
            prepare, apply_fn = pair

            def propagate_prepared(aux, x, dt, rateiv, t0, cov):
                return apply_fn(aux, x, dt, rateiv)

        out = self._out or (lambda x, p, t, cov: x[: self._nout])
        return ModelSpec(
            nstates=self._nstates,
            ninput=self._ndrugs,
            nout=self._nout,
            propagate=propagate,
            out=out,
            init=self._init,
            lag=self._lag,
            fa=self._fa,
            seq=self._seq,
            apply_bolus=default_apply_bolus(self._nstates),
            prepare=prepare,
            propagate_prepared=propagate_prepared,
        )


class ODE(EquationBase):
    """Numerically integrated ODE equation family.

    Parity: ode/mod.rs and the JAX package's ``ODE``.
    ``diffeq(x, p, t, b, rateiv, cov) -> dx`` (the reference closure writes
    into ``dx``; here it is returned, e.g. as ``torch.stack([...])``).
    Boluses are applied by the RHS difference (ode/mod.rs:644-687); segment
    boundaries replace the solver's left/right-continuity machinery.

    Solvers: dopri5 (default) and tsit5. ``lag(p, t, cov)`` and ``fa(p, t,
    cov)`` shift and scale each bolus per support point ({input: value} or a
    vector over the inputs), ``init(p, t, cov)`` gives the occasion-0 state
    at t = 0; closures read covariates through ``cov(name, t)``.
    """

    kind = "ode"

    def __init__(
        self,
        diffeq: Callable,
        lag: Optional[Callable] = None,
        fa: Optional[Callable] = None,
        init: Optional[Callable] = None,
        out: Optional[Callable] = None,
        nstates: int = 5,
        ndrugs: int = 5,
        nout: int = 5,
    ):
        super().__init__(nstates, ndrugs, nout)
        self._diffeq = diffeq
        self._lag = lag
        self._fa = fa
        self._init = init
        self._out = out
        self._opts = ODEOptions(solver="dopri5")
        # generated CUDA right-hand sides, by (support columns, inputs,
        # covariate names, covariate modes)
        self._rhs_cache: Dict[tuple, object] = {}

    def _model_kind(self) -> ModelKind:
        return ModelKind.ODE

    def _invalidate(self):
        super()._invalidate()
        self._rhs_cache = {}

    # -- solver configuration (ode/mod.rs:135-166) ------------------------------
    def with_solver(self, solver: str):
        self._opts = self._opts._replace(solver=str(solver))
        self._invalidate()
        return self

    def with_tolerances(self, rtol: float, atol: float):
        self._opts = self._opts._replace(rtol=float(rtol), atol=float(atol))
        self._invalidate()
        return self

    def with_max_steps(self, max_steps: int):
        self._opts = self._opts._replace(max_steps=int(max_steps))
        self._invalidate()
        return self

    def with_h0(self, h0: float):
        self._opts = self._opts._replace(h0=float(h0))
        self._invalidate()
        return self

    def with_newton_iters(self, n: int):
        self._opts = self._opts._replace(newton_iters=int(n))
        self._invalidate()
        return self

    def _build_spec(self) -> ModelSpec:
        diffeq = self._diffeq
        n, ninput = self._nstates, self._ndrugs
        out = self._out or (lambda x, p, t, cov: x[: self._nout])
        return ModelSpec(
            nstates=n,
            ninput=ninput,
            nout=self._nout,
            propagate=make_ode_propagate(diffeq, n, ninput, self._opts),
            out=out,
            init=self._init,
            lag=self._lag,
            fa=self._fa,
            apply_bolus=rhs_difference_apply_bolus(diffeq),
            propagate_carry=make_ode_propagate_carry(diffeq, n, ninput,
                                                     self._opts),
        )
