"""Carry state across from the JAX package, so both compute on equal inputs.

Duck-typed: nothing here imports jax or ``pharmsol_tpu``. Events are told
apart by their class names, error models by their public attributes.
Support points are the same numpy ``[S, n_params]`` array in both packages;
an ODE model's solver options and an SDE model's particle-filter options are
their only other state (their closures are written once per framework from
the same formula).
"""

from __future__ import annotations

import numpy as np

from .config import float_dtype, resolve_device
from .data.covariate import Covariate, Covariates
from .data.error_model import AssayErrorModel, AssayErrorModels, ErrorPoly, Factor
from .data.event import Bolus, Censor, Infusion, Observation
from .data.residual_error import ResidualErrorModel, ResidualErrorModels, ResidualKind
from .data.structs import Data, Occasion, Subject
from .engine.grid import OccasionArrays, to_tensors
from .engine.ode import ODEOptions


def _event_from_reference(e):
    name = type(e).__name__
    if name == "Bolus":
        return Bolus(float(e.time), float(e.amount), str(e.input), e.occasion)
    if name == "Infusion":
        return Infusion(float(e.time), float(e.amount), str(e.input),
                        float(e.duration), e.occasion)
    if name == "Observation":
        return Observation(
            float(e.time), None if e.value is None else float(e.value),
            str(e.outeq), e.errorpoly, e.occasion, Censor(e.censoring.value),
        )
    raise TypeError(f"not an event of the JAX package: {e!r}")


def _occasion_from_reference(occ) -> Occasion:
    out = Occasion(int(occ.index))
    out.events = [_event_from_reference(e) for e in occ.events]
    out.sort()
    covs = Covariates()
    for name, cov in occ.covariates.items():
        covs.add_covariate(
            name, Covariate(cov.name, cov.fixed, cov.observations()))
    out.covariates = covs
    out._version += 1
    return out


def data_from_reference(data) -> Data:
    """The port's Data for a JAX package ``Data`` (or list of Subjects)."""
    subjects = data.subjects() if hasattr(data, "subjects") else list(data)
    return Data([
        Subject(s.id, [_occasion_from_reference(o) for o in s.occasions()])
        for s in subjects
    ])


def error_models_from_reference(ems) -> AssayErrorModels:
    """The port's AssayErrorModels for a JAX package ``AssayErrorModels``."""
    out = AssayErrorModels()
    for label, m in ems.items():
        fp = m.factor_param
        factor = None if fp is None else Factor(float(fp.value), bool(fp.fixed))
        poly = None if m.poly is None else ErrorPoly(*m.poly.coefficients())
        out.add(label, AssayErrorModel(int(m.kind), factor, poly))
    return out


def residual_error_models_from_reference(rems) -> ResidualErrorModels:
    """The port's ResidualErrorModels for a JAX package
    ``ResidualErrorModels`` (kind by its value, ``a`` and ``b``)."""
    out = ResidualErrorModels()
    for label in rems.labels():
        m = rems.get(label)
        out.add(label, ResidualErrorModel(ResidualKind(m.kind.value), float(m.a),
                                          float(m.b)))
    return out


def rows_from_reference(rows, device=None, dtype=None) -> OccasionArrays:
    """The JAX package's stacked OccasionArrays (numpy or jax arrays) as the
    port's OccasionArrays of tensors on ``device`` in ``dtype``."""
    host = OccasionArrays(*(np.asarray(getattr(rows, f))
                            for f in OccasionArrays._fields))
    return to_tensors(host, resolve_device(device), dtype or float_dtype())


def ode_options_from_reference(opts) -> ODEOptions:
    """The port's ODEOptions for a JAX package ``ODEOptions`` (solver,
    tolerances, h0, step budget; the JAX-only ``unroll`` is dropped)."""
    return ODEOptions(rtol=float(opts.rtol), atol=float(opts.atol),
                      h0=float(opts.h0), max_steps=int(opts.max_steps),
                      solver=str(opts.solver),
                      newton_iters=int(opts.newton_iters))


def sde_options_from_reference(sde) -> dict:
    """The keyword options of the port's ``SDE`` for a JAX package ``SDE``:
    particle count, seed, noise mode, resampling scheme and EM step control,
    and its lag and fa closures (plain arithmetic on ``p``, ``t`` and
    ``cov``, which runs in either framework: the drift and diffusion are
    written once per framework)."""
    return dict(nparticles=int(sde.nparticles()), seed=int(sde._seed),
                noise=str(sde._noise), resampling=str(sde._resampling),
                em_control=str(sde._em_control), lag=sde._lag, fa=sde._fa)
