"""Stiff ODE models in the port's general engine: trbdf2, kvaerno3 (=
esdirk34), kvaerno5 and bdf (float64 on the CPU; the fused side is
``tests/test_torch_stiff_fused.py``).

Each model of ``utils/f32_budget.py::STIFF_CASES`` (the models of the JAX
package's ``tests/test_pallas_ode.py:452-499, :725-774``, ``tests/
test_stiff.py:21-83`` and ``benches/stiff_bench.py:45-72``) is built once per
package from the same numpy draws and run through ``log_likelihood_matrix``
with JAX ``engine='xla'`` and the port's ``engine='general'``. The port runs
the JAX loop step for step on every lane (Newton with a fresh Jacobian per
iteration, the same controller), so the two agree within 1e-10 relative on
every case but the stiffest ones (``tmdd``, ``poison``: 1e-8, where a
rounding difference in the batched n x n solve is amplified by the Newton
iteration), lost cells included. Each case runs under one solver here. Then the port's counterparts of the JAX
package's ``tests/test_solvers.py:16-63, :78-98`` and
``tests/test_stiff.py:107-118, :139-181`` on the population path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.engine import ode as jax_ode
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.engine import ode as ode_engine
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.utils.f32_budget import (
    MM_CENTRE, STIFF_CASES, TMDD_CENTRE, stiff_case,
)

STIFF_SOLVERS = ("trbdf2", "kvaerno3", "esdirk34", "kvaerno5", "bdf")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")
    # lanes of a few dozen cells under a Python loop: torch's intra-op pool
    # only costs here (2-3x on the implicit solvers' small batched solves)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


# every case once, every solver name at least once (three of them also run on
# two more models in tests/test_torch_ode_engine.py)
GENERAL_CASES = [
    ("two_cmt", "kvaerno5"), ("binding_init", "trbdf2"), ("separated_rates", "bdf"),
    ("lag_infusion", "kvaerno3"), ("michaelis_menten", "bdf"), ("tmdd", "bdf"),
    ("cov_affine", "trbdf2"), ("two_outputs_cens", "esdirk34"), ("poison", "bdf"),
]
TOLERANCE = {"tmdd": 1e-8, "poison": 1e-8}


def test_every_stiff_case_and_solver_is_covered():
    assert {c for c, _ in GENERAL_CASES} == set(STIFF_CASES)
    assert {s for _, s in GENERAL_CASES} == set(STIFF_SOLVERS)
    assert ode_engine.UNPORTED_SOLVERS == ()


@pytest.mark.parametrize("name, solver", GENERAL_CASES)
def test_general_engine_matches_jax_xla(name, solver):
    jm, jdata, sp, jems = stiff_case(name, 3, 4, seed=3, lib=pst, stack=jnp.stack,
                                     solver=solver)
    tm, tdata, _, tems = stiff_case(name, 3, 4, seed=3, solver=solver)
    want = np.asarray(jax_psi(jm, jdata, sp, jems, engine="xla"))
    got = pt.log_likelihood_matrix(tm, tdata, sp, tems, engine="general")
    assert got.dtype == torch.float64 and got.shape == want.shape == (3, 4)
    got = got.numpy()
    lost = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), lost)
    assert lost.any() == (name == "poison") and not lost.all()
    assert np.isfinite(got[~lost]).all()
    assert _rel(got[~lost], want[~lost]) <= TOLERANCE.get(name, 1e-10)


def test_newton_iters_reaches_the_implicit_stages():
    """``with_newton_iters`` changes the implicit solvers' arithmetic, in the
    port as in the JAX package."""
    out = {}
    for n in (2, 6):
        jm, jdata, sp, jems = stiff_case("binding_init", 2, 3, seed=4, lib=pst,
                                         stack=jnp.stack, solver="trbdf2")
        tm, tdata, _, tems = stiff_case("binding_init", 2, 3, seed=4, solver="trbdf2")
        want = np.asarray(jax_psi(jm.with_newton_iters(n), jdata, sp, jems, engine="xla"))
        got = pt.log_likelihood_matrix(tm.with_newton_iters(n), tdata, sp, tems,
                                       engine="general").numpy()
        assert _rel(got, want) <= 1e-10
        out[n] = got
    assert not np.array_equal(out[2], out[6])


# -- the port's own tableaus and constants -----------------------------------


def test_kvaerno_tableaus_satisfy_order_conditions():
    tabs = ode_engine.SDIRK_TABLEAUS
    for name, order in (("kvaerno3", 3), ("kvaerno5", 4)):
        A, B, BHAT, C = (tabs[name][k] for k in ("A", "B", "BHAT", "C"))
        for i, row in enumerate(A):  # stage consistency: row sums equal c
            assert abs(sum(row) - C[i]) < 1e-10, (name, i)
        assert abs(sum(B) - 1.0) < 1e-10
        assert abs(sum(b * c for b, c in zip(B, C)) - 0.5) < 1e-10
        assert abs(sum(b * c * c for b, c in zip(B, C)) - 1.0 / 3.0) < 1e-9
        assert abs(sum(BHAT) - 1.0) < 1e-10  # the embedded method: order 2 at least
        assert abs(sum(b * c for b, c in zip(BHAT, C)) - 0.5) < 1e-9
    assert tabs["esdirk34"] is tabs["kvaerno3"]


def test_tsit5_trbdf2_tableau_order_conditions():
    A, B, E, C = ode_engine.TABLEAUS["tsit5"]
    for i, row in enumerate(A):
        assert abs(sum(row) - C[i]) < 1e-12, i
    assert abs(sum(B) - 1.0) < 1e-12
    assert abs(sum(b * c for b, c in zip(B, C)) - 0.5) < 1e-12
    assert abs(sum(b * c * c for b, c in zip(B, C)) - 1.0 / 3.0) < 1e-9
    assert abs(sum(E)) < 1e-12
    t = ode_engine.SDIRK_TABLEAUS["trbdf2"]
    for i, row in enumerate(t["A"]):
        assert abs(sum(row) - t["C"][i]) < 1e-12
    for w, order3 in ((t["B"], False), (t["BHAT"], True)):
        assert abs(sum(w) - 1.0) < 1e-12
        assert abs(sum(b * c for b, c in zip(w, t["C"])) - 0.5) < 1e-12
        if order3:
            assert abs(sum(b * c * c for b, c in zip(w, t["C"])) - 1.0 / 3.0) < 1e-12


def test_constants_equal_the_jax_packages():
    """The port keeps its own copy of the tableaus and the BDF constants:
    each equals the JAX package's, bit for bit."""
    for name, prefix in (("kvaerno3", "_KV3"), ("kvaerno5", "_KV5"), ("trbdf2", "_TRBDF2")):
        t = ode_engine.SDIRK_TABLEAUS[name]
        for key in ("A", "B", "BHAT", "C"):
            assert t[key] == getattr(jax_ode, f"{prefix}_{key}"), (name, key)
    assert ode_engine.SDIRK_TABLEAUS["trbdf2"]["gamma"] == jax_ode._TRBDF2_D
    assert ode_engine.SDIRK_TABLEAUS["kvaerno3"]["gamma"] == jax_ode._KV3_GAMMA
    assert ode_engine.SDIRK_TABLEAUS["kvaerno5"]["gamma"] == jax_ode._KV5_GAMMA
    for mine, theirs in ((ode_engine._BDF_KAPPA, jax_ode._BDF_KAPPA),
                         (ode_engine._BDF_GAMMA, jax_ode._BDF_GAMMA),
                         (ode_engine._BDF_ALPHA, jax_ode._BDF_ALPHA),
                         (ode_engine._BDF_ERROR_CONST, jax_ode._BDF_ERROR_CONST)):
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs))
    assert ode_engine.BDF_MAX_ORDER == jax_ode._BDF_MAX_ORDER == 5
    assert set(STIFF_SOLVERS) | {"dopri5", "tsit5", "expm", "expm_rolled"} \
        == set(jax_ode._SEGMENT_SOLVERS)


@pytest.mark.parametrize(
    "solver", ["dopri5", "tsit5", "kvaerno3", "kvaerno5", "bdf", "esdirk34", "trbdf2"])
def test_all_solver_names_agree(solver):
    """Every named solver integrates the 1-compartment bolus + infusion model
    to the closed form, here through psi (the port has no single-subject
    API)."""
    sb = pt.Subject.builder("s").bolus(0.0, 100.0, 0).infusion(4.0, 80.0, 0, 2.0)
    for t, v in ((1.0, 60.0), (5.0, 40.0), (10.0, 9.0)):
        sb = sb.observation(t, v, 0)
    data = pt.Data([sb.build()])
    ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    closed = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[:1],
                           nstates=1, ndrugs=1, nout=1)
    ode = pt.ODE(lambda x, p, t, b, r, cov: torch.stack([-p[0] * x[0] + b[0] + r[0]]),
                 out=lambda x, p, t, cov: x[:1], nstates=1, ndrugs=1,
                 nout=1).with_solver(solver).with_tolerances(1e-6, 1e-6)
    sp = np.array([[0.35], [0.2]])
    want = pt.log_likelihood_matrix(closed, data, sp, ems, engine="general").numpy()
    got = pt.log_likelihood_matrix(ode, data, sp, ems, engine="general").numpy()
    # (1e-6, 1e-6) and 1e-4, where the JAX test runs (1e-9, 1e-9) and 1e-6: an
    # order-3 pair at 1e-9 takes two minutes in the port's Python loop
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_unknown_solver_rejected():
    with pytest.raises(PharmsolError, match="unknown ODE solver"):
        ode_engine.check_solver("rk99")
    assert ode_engine.check_solver("bdf") is None
    assert ode_engine.check_solver("esdirk34") is ode_engine.SDIRK_TABLEAUS["kvaerno3"]


@pytest.mark.parametrize("solver", ["dopri5", "bdf", "kvaerno3"])
def test_f32_runaway_lane_poisons_fast(solver):
    """A lane whose dynamics overflow float32 must poison (NaN), not spin:
    the stall guard (t + h == t) ends it long before the step budget. The
    segment starts at t = 1: at t = 0 the guard cannot fire in either
    package (h is floored at 1e-14), and the lane runs out its budget."""
    calls = []

    def f(x, t):
        calls.append(1)
        return x * x  # finite-time blow-up, overflows float32 at once

    def jac(x, t):
        return (2.0 * x)[..., None]

    x0 = torch.tensor([[[1e20]]], dtype=torch.float32)
    t0 = torch.ones((1, 1), dtype=torch.float32)
    t1 = torch.full((1, 1), 11.0, dtype=torch.float32)
    opts = ode_engine.ODEOptions()
    if solver == "dopri5":
        out, _ = ode_engine._erk_segment(f, x0, t0, t1, opts, *ode_engine.TABLEAUS[solver])
    elif solver == "bdf":
        out, _ = ode_engine._bdf_segment(f, jac, x0, t0, t1, opts)
    else:
        out, _ = ode_engine._esdirk_segment(f, jac, x0, t0, t1, opts,
                                            **ode_engine.SDIRK_TABLEAUS[solver])
    assert torch.isnan(out).all()
    assert len(calls) < 2000  # the budget is 10 000 steps of several calls each


# -- the stiff corpus on the population path ---------------------------------
#
# The references are tight-tolerance integrations by the JAX package (compiled:
# seconds); the port's side runs at looser tolerances than the JAX tests' own,
# because its masked Python loop takes about a millisecond per step.


def _one_subject(name, solver, sp_centre, lib=pt, stack=None, times=None):
    model, data, _, ems = stiff_case(name, 1, 1, seed=0, lib=lib, stack=stack, solver=solver)
    if times is not None:  # a shorter profile of the same regimen's first dose
        sb = lib.Subject.builder("short").bolus(0.0, 500.0, 0)
        for t in times:
            sb = sb.observation(t, float(40.0 * np.exp(-0.15 * t)), 0)
        data = lib.Data([sb.build()])
    return model, data, np.asarray([sp_centre], dtype=np.float64), ems


MM_TIMES = (0.5, 1.0, 2.0, 4.0, 8.0)


@pytest.fixture(scope="module")
def mm_reference():
    """dopri5 at (1e-10, 1e-12) on the Michaelis-Menten bolus, km far below
    the concentrations."""
    model, data, sp, ems = _one_subject("michaelis_menten", "dopri5", MM_CENTRE, pst,
                                        jnp.stack, MM_TIMES)
    model = model.with_tolerances(1e-10, 1e-12).with_max_steps(300_000)
    want = np.asarray(jax_psi(model, data, sp, ems, engine="xla"))
    assert np.isfinite(want).all()
    return want


@pytest.mark.parametrize("solver", ["bdf", "trbdf2", "kvaerno3", "kvaerno5"])
def test_mm_stiff_solvers_match_tight_explicit(solver, mm_reference):
    """Every stiff solver at (1e-5, 1e-7) lands on the tight explicit
    reference (psi within 2e-4 relative)."""
    model, data, sp, ems = _one_subject("michaelis_menten", solver, MM_CENTRE,
                                        times=MM_TIMES)
    model = model.with_tolerances(1e-5, 1e-7).with_max_steps(100_000)
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    np.testing.assert_allclose(got, mm_reference, rtol=2e-4, atol=1e-8)


@pytest.fixture(scope="module")
def tmdd_reference():
    """kvaerno3 at a tight tolerance: explicit methods need ~1e6 steps here."""
    model, data, sp, ems = _one_subject("tmdd", "kvaerno3", TMDD_CENTRE, pst, jnp.stack)
    model = model.with_tolerances(1e-10, 1e-12).with_max_steps(300_000)
    want = np.asarray(jax_psi(model, data, sp, ems, engine="xla"))
    assert np.isfinite(want).all()
    return want


@pytest.mark.parametrize("solver, tols, rtol", [("bdf", (1e-6, 1e-8), 5e-5),
                                                ("kvaerno5", (1e-4, 1e-4), 5e-3)])
def test_tmdd_stiff_solvers_match_tight_explicit(solver, tols, rtol, tmdd_reference):
    model, data, sp, ems = _one_subject("tmdd", solver, TMDD_CENTRE)
    model = model.with_tolerances(*tols).with_max_steps(100_000)
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    np.testing.assert_allclose(got, tmdd_reference, rtol=rtol, atol=1e-8)


def test_tmdd_default_tolerance_accuracy(tmdd_reference):
    """bdf at the default rtol = atol = 1e-4 stays within 5e-3 relative."""
    model, data, sp, ems = _one_subject("tmdd", "bdf", TMDD_CENTRE)
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    assert _rel(got, tmdd_reference) < 5e-3


def test_step_exhaustion_poisons_instead_of_truncating():
    """An explicit solver given too few steps for a stiff problem gives a
    -inf cell, never a half-integrated state; bdf integrates the same cell."""
    model, data, sp, ems = _one_subject("tmdd", "dopri5", TMDD_CENTRE)
    psi = pt.log_likelihood_matrix(model.with_max_steps(200), data, sp, ems, engine="general")
    assert torch.isneginf(psi[0, 0])
    stiff, _, _, _ = _one_subject("tmdd", "bdf", TMDD_CENTRE)
    assert torch.isfinite(pt.log_likelihood_matrix(stiff, data, sp, ems, engine="general")).all()


def test_bdf_runs_over_support_points():
    """The BDF carry (difference array, order, step) is per lane."""
    model, data, _, ems = stiff_case("michaelis_menten", 1, 1, seed=0, solver="bdf")
    sp = np.array([[80.0, 0.05, 10.0], [60.0, 0.10, 12.0], [90.0, 0.02, 9.0]])
    psi = pt.log_likelihood_matrix(model, data, sp, ems, engine="general")
    assert psi.shape == (1, 3) and torch.isfinite(psi).all()
    for j in range(3):  # each lane alone gives the same cell
        alone = pt.log_likelihood_matrix(model, data, sp[j:j + 1], ems, engine="general")
        np.testing.assert_allclose(alone.numpy()[0, 0], psi.numpy()[0, j], rtol=1e-12)


def test_bdf_order_ramps_on_smooth_problem():
    """On a smooth linear problem the variable-order machinery must reach a
    high order: an order-1 method at this tolerance would need more than 1e5
    steps (the budget is 2000)."""
    def f(x, t):
        return -0.5 * x

    def jac(x, t):
        return torch.full(x.shape + (1,), -0.5, dtype=x.dtype)

    opts = ode_engine.ODEOptions(rtol=1e-6, atol=1e-9, max_steps=2000)
    x0 = torch.tensor([[[100.0]]], dtype=torch.float64)
    t0 = torch.zeros((1, 1), dtype=torch.float64)
    out, _ = ode_engine._bdf_segment(f, jac, x0, t0, t0 + 10.0, opts)
    exact = 100.0 * np.exp(-5.0)
    assert abs(float(out[0, 0, 0]) - exact) / exact < 1e-4
