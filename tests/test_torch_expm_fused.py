"""Kernel K2d's plain twin and plan for linear ODE models with
``.with_solver("expm")`` (float64 on the CPU; the general engine's side is
``tests/test_torch_expm.py``).

The twin, through the plan, against the JAX kernel in interpret mode on the
models of the JAX package's ``tests/test_pallas_ode.py:189-292`` (8 x 128,
the JAX tile): within 1e-9. Against the port's general engine on every case
of ``EXPM_CASES``: the same chain, to rounding. The wrapper's checks, the
``ode_expm`` float32 row, and a population fit over the 1-cmt oral model
written as an expm ODE, which lands where the fit over its closed form
lands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.engine import ode as ode_engine
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood import matrix
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
from pharmsol_tpu_torch.ops import fused_ode
from pharmsol_tpu_torch.utils.f32_budget import (
    EXPM_CASES, F32_BUDGET, POPULATION_RANGES, expm_case, f32_error, ode_case,
    population_10k_case, population_models,
)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _both(name, R, S, seed):
    """The case built in both packages from the same draws."""
    return (expm_case(name, R, S, seed=seed, lib=pst, stack=jnp.stack),
            expm_case(name, R, S, seed=seed))


def _same_where_lost(got, want):
    lost = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), lost)
    assert np.isfinite(got[~lost]).all()
    return ~lost


@pytest.mark.parametrize("name", ["two_cmt", "lag_fa", "step_covariate", "init_two_outputs"])
def test_twin_matches_the_jax_kernel_in_interpret_mode(name):
    """The models of the JAX package's test_pallas_ode.py:189-292 at one JAX
    tile: the twin ran (CPU tensors: no launch is counted)."""
    (jm, jdata, sp, jems), (tm, tdata, _, tems) = _both(name, 8, 128, seed=5)
    want = np.asarray(jax_psi(jm, jdata, sp, jems, engine="pallas"))
    before = fused_ode.EXPM_LAUNCHES
    got = pt.log_likelihood_matrix(tm, tdata, sp, tems, engine="fused").numpy()
    assert fused_ode.EXPM_LAUNCHES == before
    assert got.shape == (8, 128) and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-9


@pytest.mark.parametrize("name", list(EXPM_CASES))
def test_twin_matches_the_general_engine(name):
    """Twin and general engine run the same chain (A by tangents at zero, the
    Taylor-13 Horner rounds, each lane's squarings), so they agree to
    rounding, lost cells included; the plan never merges runs."""
    model, data, sp, ems = expm_case(name, 7, 9, seed=11)
    grid = model.lower(data.subjects())
    plan = _FusedOdePsiPlan(model, grid, sp, ems.lower(model.resolve_output_label,
                                                         model.nouteqs()),
                            torch.device("cpu"), torch.float64)
    assert plan.solver == "expm" and plan.merge_runs is None and plan.rhs.jacobian
    assert "rhs_jvp" in plan.rhs.source
    assert fused_ode.dense_P_for("expm") is None
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    fin = _same_where_lost(got, want)
    assert _rel(got[fin], want[fin]) <= 1e-12
    counts = {}
    fused_ode.psi_ode_plain(*plan.streams, plan.support, plan.rhs, counts=counts,
                            **plan.kernel_kwargs())
    assert counts["passes"] > 0 and counts["squarings"] >= 0 and "steps" not in counts


def test_wrapper_checks_for_expm():
    model, data, sp, ems = ode_case("ode_expm")
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    plan = _FusedOdePsiPlan(model, grid, sp, lowered, torch.device("cpu"), torch.float64)
    kw = plan.kernel_kwargs()
    with pytest.raises(ValueError, match="never merges"):
        fused_ode.psi_ode(*plan.streams, plan.support, plan.rhs,
                          **dict(kw, merge_runs=[(0, plan.streams[0].shape[1])]))
    explicit = _FusedOdePsiPlan(model.with_solver("dopri5"), grid, sp, lowered,
                                torch.device("cpu"), torch.float64)
    assert not explicit.rhs.jacobian and explicit.rhs.key != plan.rhs.key
    with pytest.raises(ValueError, match="jacobian=True"):
        fused_ode.psi_ode(*plan.streams, plan.support, explicit.rhs, **kw)
    assert fused_ode.SOLVER_CODES["expm"] == 2


@pytest.mark.parametrize("name", list(EXPM_CASES) + ["ode_expm"])
def test_twin_float32_within_the_expm_budget(name):
    """The float32 twin against the float64 twin within the ``ode_expm`` row
    (5e-5), on the row's own case and on every K2d case (the card holds the
    kernel to the same row)."""
    model, data, sp, ems = ode_case(name) if name == "ode_expm" else expm_case(
        name, 16, 24, seed=9)
    golden = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    pt.set_float_dtype(torch.float32)
    try:
        got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    finally:
        pt.set_float_dtype(torch.float64)
    assert got.dtype == torch.float32
    fin = _same_where_lost(got.numpy(), golden)
    assert f32_error(got.numpy()[fin], golden[fin]) <= F32_BUDGET["ode_expm"]


@pytest.mark.parametrize("engine", ["general", "fused"])
def test_fit_over_the_expm_ode_lands_on_the_closed_form_fit(engine):
    """The 1-cmt oral model written as a linear ODE with expm is exact, so
    ``fit_population`` over it is the fit over the closed-form model."""
    data, ems, _ = population_10k_case(40)
    closed, ode = population_models()
    kw = dict(ranges=POPULATION_RANGES, init_points=48, max_cycles=5)
    want = pt.optimize.fit_population(closed, data, ems, engine="general", **kw)
    got = pt.optimize.fit_population(ode, data, ems, engine=engine, **kw)
    assert got.cycles == want.cycles and got.support.shape == want.support.shape
    assert abs(got.log_likelihood - want.log_likelihood) <= 1e-8 * abs(want.log_likelihood)
    np.testing.assert_allclose(got.support, want.support, rtol=1e-8)
    np.testing.assert_allclose(got.weights, want.weights, atol=1e-7)
