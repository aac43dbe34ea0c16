"""Linear ODE models with ``.with_solver("expm")``: the exact propagation in
the port's general engine, in the fused twin (kernel K2d's plain version) and
in the plan, against the JAX package (float64 on the CPU).

The cases are those of ``utils/f32_budget.py::EXPM_CASES`` (the models of the
JAX package's ``tests/test_pallas_ode.py:189-292``, ``tests/test_solvers.py:
101`` and ``examples/expm_linear_ode.py``), built once per package from the
same numpy draws. The general engine computes the JAX ``engine='xla'`` chain
lane by lane: within 1e-10 relative. The twin, through the plan, against the
JAX kernel in interpret mode (8 x 128, the JAX tile): within 1e-9. The plan's
three refusals raise under ``engine='fused'`` and are recorded under
``auto``. A population fit over the 1-cmt oral model written as an expm ODE
lands where the fit over its closed form lands.
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


@pytest.mark.parametrize("name", [n for n in EXPM_CASES if n != "transit"])
def test_general_engine_matches_jax_xla(name):
    """Every case but the 5-state one, whose XLA program alone compiles for
    over a minute here; the twin is held against the general engine on it
    (tests/test_torch_expm_fused.py) and the kernel against both on the
    card."""
    (jm, jdata, sp, jems), (tm, tdata, sp_t, tems) = _both(name, 6, 12, seed=3)
    np.testing.assert_array_equal(sp, sp_t)
    want = np.asarray(jax_psi(jm, jdata, sp, jems, engine="xla"))
    got = pt.log_likelihood_matrix(tm, tdata, sp, tems, engine="general").numpy()
    fin = _same_where_lost(got, want)
    assert fin.all() == (name != "poison") and fin.any()
    assert _rel(got[fin], want[fin]) <= 1e-10


def test_expm_is_exact_on_linear_models():
    """tests/test_solvers.py:101 through psi: the 2-cmt oral model as an expm
    ODE against its closed form, bolus and infusion, in every engine."""
    model, data, sp, ems = expm_case("short", 6, 12, seed=2)
    closed = pt.Analytical(pt.two_compartments_with_absorption,
                           out=lambda x, p, t, cov: x[1:2] / p[4],
                           nstates=3, ndrugs=1, nout=1)
    want = pt.log_likelihood_matrix(closed, data, sp, ems, engine="general").numpy()
    for engine in ("general", "fused"):
        got = pt.log_likelihood_matrix(model, data, sp, ems, engine=engine).numpy()
        assert _rel(got, want) <= 1e-10
    # and the adaptive solver only to its tolerance
    loose = pt.log_likelihood_matrix(model.with_solver("dopri5"), data, sp, ems,
                                     engine="general").numpy()
    assert 1e-9 < _rel(loose, want) < 1e-3


def test_expm_rolled_is_an_alias():
    model, data, sp, ems = expm_case("two_cmt", 4, 6, seed=1)
    assert ode_engine.check_solver("expm_rolled") is None
    for engine in ("general", "fused"):
        a = pt.log_likelihood_matrix(model, data, sp, ems, engine=engine)
        b = pt.log_likelihood_matrix(model.with_solver("expm_rolled"), data, sp, ems,
                                     engine=engine)
        assert torch.equal(a, b)
    assert "expm" not in ode_engine.UNPORTED_SOLVERS
    assert ode_engine._EXPM_SQUARINGS == 16 and ode_engine._EXPM_TAYLOR == 13


def test_squaring_budget_poisons_the_lane():
    """A scaled norm past 2^16 is NaN in ``expm_segment`` (and only there)."""
    A = torch.tensor([[-1.0, 0.0], [1.0, -0.5]], dtype=torch.float64)
    f = lambda x, t: x @ A.T  # noqa: E731
    jac = lambda x, t: A.expand(x.shape[0], 2, 2)  # noqa: E731
    x0 = torch.tensor([[100.0, 0.0]] * 3, dtype=torch.float64)
    t1 = torch.tensor([1.0, 2.0 ** 16 / 1.5 * 1.01, 0.0], dtype=torch.float64)
    out = ode_engine.expm_segment(f, jac, x0, torch.zeros(3, dtype=torch.float64), t1)
    want = torch.linalg.matrix_exp(A) @ x0[0]
    torch.testing.assert_close(out[0], want, rtol=1e-12, atol=1e-12)
    assert torch.isnan(out[1]).all()
    torch.testing.assert_close(out[2], x0[2], rtol=0, atol=0)  # a zero span


def _rejected(kind):
    """The three refusals of the JAX package's test_pallas_ode.py:294-342."""
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    b = pt.Subject.builder("s0").bolus(0.0, 100.0, 0)
    if kind == "nonlinear":
        rhs = lambda x, p, t, b, r, cov: torch.stack([  # noqa: E731
            -p[0] * x[0] / (p[1] + x[0]) + b[0]])
        sp, out = np.array([[10.0, 15.0, 30.0]]), (lambda x, p, t, cov: x[0:1] / p[2])
    elif kind == "time_dependent":
        rhs = lambda x, p, t, b, r, cov: torch.stack([  # noqa: E731
            -p[0] * (1.0 + 0.1 * t) * x[0] + b[0]])
        sp, out = np.array([[0.3, 20.0]]), (lambda x, p, t, cov: x[0:1] / p[1])
    else:
        rhs = lambda x, p, t, b, r, cov: torch.stack([  # noqa: E731
            -p[0] * (cov("wt", t) / 70.0) * x[0] + b[0]])
        sp, out = np.array([[0.3, 20.0]]), (lambda x, p, t, cov: x[0:1] / p[1])
        b = b.covariate("wt", 0.0, 60.0).covariate("wt", 2.0, 80.0)
    for t in (1.0, 2.0, 4.0):
        b = b.observation(t, 1.0, 0)
    model = pt.ODE(rhs, out=out, nstates=1, ndrugs=1, nout=1).with_solver("expm")
    return model, pt.Data([b.build()]), sp, ems


@pytest.mark.parametrize("kind, reason", [
    ("nonlinear", "AFFINE"),
    ("time_dependent", "autonomous"),
    ("linear_covariate", "constant within segments"),
])
def test_plan_refusals_raise_and_auto_records_them(kind, reason, monkeypatch):
    model, data, sp, ems = _rejected(kind)
    with pytest.raises(PharmsolError, match=reason):
        pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    # auto with the fused route (forced, as on a CUDA device) takes the
    # general engine, which poisons the lane by its own runtime probes
    monkeypatch.setattr(matrix, "_auto_engine", lambda device: ("fused", "forced for the test"))
    psi = pt.log_likelihood_matrix(model, data, sp, ems)
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general"
    assert "fused plan rejected the model" in decision["reason"] and reason in decision["reason"]
    assert torch.isneginf(psi).all()


def test_a_jacobian_the_generator_cannot_write_is_a_refusal(monkeypatch):
    """``p ** x`` traces, but its state derivative has no rule: the plan
    raises with the reason and ``auto`` records it."""
    model, data, sp, ems = _rejected("nonlinear")
    sp = np.array([[0.5, 15.0, 30.0]])
    bad = pt.ODE(lambda x, p, t, b, r, cov: torch.stack([-(p[0] ** x[0]) + b[0]]),
                 out=lambda x, p, t, cov: x[0:1] / p[2], nstates=1, ndrugs=1,
                 nout=1).with_solver("expm")
    with pytest.raises(PharmsolError, match="no Jacobian in the CUDA kernel"):
        pt.log_likelihood_matrix(bad, data, sp, ems, engine="fused")
    monkeypatch.setattr(matrix, "_auto_engine", lambda device: ("fused", "forced for the test"))
    pt.log_likelihood_matrix(bad, data, sp, ems)
    decision = pt.last_engine_decision(bad)
    assert decision["engine"] == "general" and "no derivative rule" in decision["reason"]
    # the explicit tier needs no Jacobian and takes the same closure
    explicit = bad.with_solver("dopri5")
    assert torch.isfinite(pt.log_likelihood_matrix(explicit, data, sp, ems,
                                                   engine="fused")).all()
