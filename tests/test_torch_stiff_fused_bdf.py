"""The plain twin of kernel K2c (the BDF tier) and the fused ODE plan with
bdf (float64 on the CPU; the general engine's side is
``tests/test_torch_stiff.py``, the SDIRK tier's twin
``tests/test_torch_stiff_fused_sdirk.py``).

The twin, through the plan, against the JAX kernel in interpret mode
(``engine='pallas'`` on the CPU, one 8 x 128 JAX tile) on the cases of
``utils/f32_budget.py::STIFF_CASES`` that bdf takes (the list the two files
share, ``KERNEL_CASES``): within 1e-9, the BDF order capped at 3 as the JAX
kernel caps it, lost cells equal. Twin against the port's general engine at
the larger of the JAX tests' own tolerances (1e-3: bdf's kernel has three
controller rules more). The order cap and the twin's tally of trials and
rescalings, the wrapper's checks, the kernel's constant tables, the float32
twin within the ``ode_bdf`` row, and a population fit over a bdf model.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
from pharmsol_tpu_torch.ops import _build, fused_ode
from pharmsol_tpu_torch.utils.f32_budget import (
    F32_BUDGET, POPULATION_RANGES, f32_error, ode_case, population_10k_case, stiff_case,
)


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


def _plan(model, data, sp, ems, **kw):
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedOdePsiPlan(model, grid, sp, lowered, torch.device("cpu"),
                            torch.float64, **kw)


def _same_where_lost(got, want):
    lost = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), lost)
    assert np.isfinite(got[~lost]).all()
    return ~lost


# every case once, every solver name at least once; trbdf2 and kvaerno3 merge
# runs on the cases without lag
KERNEL_CASES = [
    ("two_cmt", "kvaerno5"), ("binding_init", "trbdf2"), ("separated_rates", "bdf"),
    ("lag_infusion", "kvaerno3"), ("michaelis_menten", "kvaerno3"), ("tmdd", "bdf"),
    ("cov_affine", "esdirk34"), ("two_outputs_cens", "trbdf2"), ("poison", "kvaerno3"),
]
# the censored observation: the port's log-CDF is exact, the TPU kernel's
# approximate (about 6e-5 absolute a term), a deliberate divergence
KERNEL_TOLERANCE = {"two_outputs_cens": 1e-6}


# Every case but ``poison`` and ``tmdd`` (below), bdf and the SDIRK solvers in
# turn. The JAX tests hold their kernel to their engine within 5e-4
# on smooth models and 1e-3 on stiff ones, on their own supports
# (tests/test_pallas_ode.py:452-499, :696-774); these cases spread theirs
# wider, so every one is held to 1e-3.
ENGINE_CASES = [
    ("two_cmt", "bdf"), ("two_cmt", "kvaerno5"), ("binding_init", "trbdf2"),
    ("separated_rates", "kvaerno3"), ("lag_infusion", "bdf"), ("michaelis_menten", "bdf"),
    ("michaelis_menten", "trbdf2"), ("cov_affine", "esdirk34"), ("two_outputs_cens", "bdf"),
]


# the TMDD corpus against the general engine, under every stiff solver
TMDD_SOLVERS = ["bdf", "kvaerno3", "trbdf2", "kvaerno5"]


# the float32 cases: the row's own case under every stiff solver and two
# stiff cases
F32_CASES = [
    ("ode_bdf", "bdf"), ("ode_bdf", "trbdf2"), ("ode_bdf", "kvaerno3"), ("ode_bdf", "kvaerno5"),
    ("tmdd", "bdf"), ("tmdd", "trbdf2"), ("two_cmt", "kvaerno3")]


@pytest.mark.parametrize("name, solver", [c for c in KERNEL_CASES if c[1] == "bdf"])
def test_twin_matches_the_jax_kernel_in_interpret_mode(name, solver):
    """One JAX tile, 8 x 128. The JAX plan merges what the port's plan
    merges; no launch is counted (CPU tensors: the twin ran)."""
    jm, jdata, sp, jems = stiff_case(name, 8, 128, seed=5, lib=pst, stack=jnp.stack,
                                     solver=solver)
    tm, tdata, _, tems = stiff_case(name, 8, 128, seed=5, solver=solver)
    want = np.asarray(jax_psi(jm, jdata, sp, jems, engine="pallas"))
    before = (fused_ode.SDIRK_LAUNCHES, fused_ode.BDF_LAUNCHES)
    got = pt.log_likelihood_matrix(tm, tdata, sp, tems, engine="fused").numpy()
    assert (fused_ode.SDIRK_LAUNCHES, fused_ode.BDF_LAUNCHES) == before
    assert got.shape == (8, 128)
    fin = _same_where_lost(got, want)
    assert fin.all() != (name == "poison") and fin.any()
    assert _rel(got[fin], want[fin]) <= KERNEL_TOLERANCE.get(name, 1e-9)


@pytest.mark.parametrize("name, solver", [c for c in ENGINE_CASES if c[1] == "bdf"])
def test_twin_matches_the_general_engine(name, solver):
    """Accuracy-level agreement at the default tolerances: the kernel freezes
    the Jacobian per step where the engine renews it per Newton round, and
    bdf's kernel has three controller rules the engine lacks. ``poison`` is
    held cell by cell against the JAX kernel instead, and ``tmdd`` below on
    the JAX test's own supports. Not held: kvaerno5 on ``michaelis_menten``,
    where the frozen-Jacobian march of the reference's kernel lands on a wrong
    solution branch below km in some cells (twin and JAX kernel alike; the
    engine does not)."""
    model, data, sp, ems = stiff_case(name, 3, 5, seed=7, solver=solver)
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-3


@pytest.mark.parametrize("solver", [s for s in TMDD_SOLVERS if s == "bdf"])
def test_tmdd_twin_matches_the_general_engine(solver):
    """The JAX package's tests/test_stiff.py:212-238 on the port: the fused
    stiff tiers on the TMDD corpus against the implicit general engine at the
    default tolerances, 1e-3."""
    model, _, _, ems = stiff_case("tmdd", 1, 1, solver=solver)
    b = pt.Subject.builder("tmdd").bolus(0.0, 100.0, 0)
    for t in (0.1, 0.5, 1.0, 2.0, 5.0, 10.0):
        b = b.observation(t, float(10 * np.exp(-0.2 * t)), 0)
    data = pt.Data([b.build()])
    rng = np.random.default_rng(13)
    sp = np.abs(np.array([0.1, 100.0, 0.1, 1.0, 0.1, 0.5, 5.0])[None, :]
                * (1.0 + 0.1 * rng.standard_normal((6, 7))))
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    assert _rel(got, want) < 1e-3


def test_bdf_order_cap_changes_the_march_and_keeps_the_answer():
    model, data, sp, ems = stiff_case("tmdd", 3, 4, seed=2, solver="bdf")
    plan3, plan5 = _plan(model, data, sp, ems), _plan(model, data, sp, ems, bdf_max_order=5)
    c3, c5 = {}, {}
    psi3 = fused_ode.psi_ode_plain(*plan3.streams, plan3.support, plan3.rhs, counts=c3,
                                   **plan3.kernel_kwargs())
    psi5 = fused_ode.psi_ode_plain(*plan5.streams, plan5.support, plan5.rhs, counts=c5,
                                   **plan5.kernel_kwargs())
    assert c3["steps"] > 0 and c5["steps"] > 0 and c3["steps"] != c5["steps"]
    assert torch.isfinite(psi3).all() and torch.isfinite(psi5).all()
    assert _rel(psi5.numpy(), psi3.numpy()) <= 1e-3
    with pytest.raises(ValueError, match="bdf_max_order"):
        fused_ode.psi_ode_plain(*plan3.streams, plan3.support, plan3.rhs,
                                **dict(plan3.kernel_kwargs(), bdf_max_order=6))


@pytest.mark.parametrize("cap", [3, 5])
def test_bdf_twin_tallies_trials_and_rescalings_by_order(cap):
    """``counts["bdf_by_row"]``: per row and order the trials, accepts,
    adaptations and the rescalings the kernel performs (clip < 1, factor
    != 1); its trials are the attempts, no order passes the cap, and a
    counted run gives the same psi as an uncounted one."""
    model, data, sp, ems = stiff_case("tmdd", 3, 4, seed=2, solver="bdf")
    plan = _plan(model, data, sp, ems, bdf_max_order=cap)
    counts = {}
    psi = fused_ode.psi_ode_plain(*plan.streams, plan.support, plan.rhs, counts=counts,
                                  **plan.kernel_kwargs())
    plain = fused_ode.psi_ode_plain(*plan.streams, plan.support, plan.rhs,
                                    **plan.kernel_kwargs())
    assert torch.equal(psi, plain)
    tally = counts["bdf_by_row"]
    assert tuple(tally.shape) == (3, 5, 6) and tally.dtype == torch.int64
    assert torch.equal(tally[:, 0].sum(dim=1), counts["steps_by_row"])
    assert int(tally[:, :, 0].sum()) == 0 and int(tally[:, :, cap + 1:].sum()) == 0
    trials, accepts, adapts, clips, refacs = (tally[:, k].sum(dim=0) for k in range(5))
    assert bool((accepts <= trials).all()) and bool((adapts <= accepts).all())
    assert bool((clips <= trials).all()) and int(refacs.sum()) <= int(trials.sum())
    assert 0 < int(clips.sum()) < int(trials.sum()) and 0 < int(refacs.sum())
    assert int(trials[2:].sum()) > 0  # the march leaves order 1


def test_wrapper_checks_for_the_stiff_tiers():
    model, data, sp, ems = stiff_case("two_cmt", 4, 3, seed=1, solver="bdf")
    plan = _plan(model, data, sp, ems)
    kw = plan.kernel_kwargs()
    M = plan.streams[0].shape[1]
    with pytest.raises(ValueError, match="bdf never merges"):
        fused_ode.psi_ode(*plan.streams, plan.support, plan.rhs,
                          **dict(kw, merge_runs=[(0, M)]))
    with pytest.raises(ValueError, match="kvaerno5 never merges"):
        fused_ode.psi_ode(*plan.streams, plan.support, plan.rhs,
                          **dict(kw, solver="kvaerno5", merge_runs=[(0, M)]))
    explicit = _plan(model.with_solver("dopri5"), data, sp, ems)
    with pytest.raises(ValueError, match="jacobian=True"):
        fused_ode.psi_ode(*plan.streams, plan.support, explicit.rhs, **kw)
    assert fused_ode.SOLVER_CODES["kvaerno3"] == fused_ode.SOLVER_CODES["esdirk34"] == 4
    assert [fused_ode.SOLVER_CODES[s] for s in ("trbdf2", "kvaerno5", "bdf")] == [3, 5, 6]


def test_kernel_tables_equal_the_twins():
    """The constant tables written into csrc/fused_ode.cu are the twin's:
    U = R(1) and the BDF constants, literal for literal."""
    src = (Path(_build.CSRC_DIR) / "fused_ode.cu").read_text()

    def table(name):
        body = re.search(name + r"(?:\[\d+\])+ = \{(.*?)\};", src, re.S).group(1)
        return np.array([float(v) for v in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", body)])

    np.testing.assert_array_equal(table("BDF_U").reshape(6, 6), fused_ode.bdf_U())
    np.testing.assert_array_equal(table("BDF_ALPHA"), np.asarray(fused_ode._BDF_ALPHA))
    np.testing.assert_array_equal(table("BDF_GAMMA"), np.asarray(fused_ode._BDF_GAMMA))
    np.testing.assert_array_equal(table("BDF_ERROR_CONST"),
                                  np.asarray(fused_ode._BDF_ERROR_CONST))
    from pharmsol_tpu.ops.pallas_ode import _bdf_U as jax_bdf_U

    np.testing.assert_array_equal(fused_ode.bdf_U(), jax_bdf_U())


@pytest.mark.parametrize("name, solver", [c for c in F32_CASES if c[1] == "bdf"])
def test_twin_float32_within_the_bdf_budget(name, solver):
    """The float32 twin against the float64 twin within the ``ode_bdf`` row
    (2e-3), on the row's own case for every stiff solver and on two stiff
    cases (the JAX package has no SDIRK row: the port holds them to this
    one; the card holds the kernels to it too, on every case)."""
    if name == "ode_bdf":
        model, data, sp, ems = ode_case("ode_bdf")
        model = model.with_solver(solver)
    else:
        model, data, sp, ems = stiff_case(name, 4, 6, seed=9, solver=solver)
    golden = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    pt.set_float_dtype(torch.float32)
    try:
        got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    finally:
        pt.set_float_dtype(torch.float64)
    assert got.dtype == torch.float32 and np.isfinite(golden).all()
    assert f32_error(got.numpy(), golden) <= F32_BUDGET["ode_bdf"]


def test_fit_population_over_a_stiff_model():
    """``fit_population`` needs no change: the fit over the 1-cmt oral ODE
    with bdf through the fused engine lands where the fit over the same ODE
    with dopri5 lands (the solvers differ by their tolerance, 1e-4)."""
    data, ems, _ = population_10k_case(16)
    rhs = lambda x, p, t, b, r, cov: torch.stack([  # noqa: E731
        -p[0] * x[0] + b[0], p[0] * x[0] - p[1] * x[1]])
    out = lambda x, p, t, cov: x[1:2] / p[2]  # noqa: E731
    kw = dict(ranges=POPULATION_RANGES, init_points=16, max_cycles=2)
    fits = {}
    for solver, engine in (("dopri5", "general"), ("bdf", "fused")):
        model = pt.ODE(rhs, out=out, nstates=2, ndrugs=1, nout=1).with_solver(solver)
        fits[solver] = pt.optimize.fit_population(model, data, ems, engine=engine, **kw)
    assert fits["bdf"].cycles == fits["dopri5"].cycles
    assert abs(fits["bdf"].log_likelihood - fits["dopri5"].log_likelihood) <= 0.5
