"""The plain twin of kernel K2b (the SDIRK tier: trbdf2, kvaerno3 =
esdirk34, kvaerno5) and the fused ODE plan for those solvers (float64 on
the CPU; the general engine's side is ``tests/test_torch_stiff.py``, the BDF
tier's twin ``tests/test_torch_stiff_fused_bdf.py``).

The twin, through the plan, against the JAX kernel in interpret mode
(``engine='pallas'`` on the CPU, one 8 x 128 JAX tile) on the cases of
``utils/f32_budget.py::STIFF_CASES`` that the SDIRK solvers take (the list
the two files share, ``KERNEL_CASES``, covers every case and solver): within
1e-9, merged and segment by segment where the plan merges (trbdf2, kvaerno3
= esdirk34), lost cells equal (1e-6 on the case with a censored observation:
the port's log-CDF is exact). Twin against the port's general engine at the
larger of the JAX tests' own tolerances (1e-3: the kernel freezes the
Jacobian per step, the engine renews it per Newton round). The merged march
against a tight-tolerance integration (``tests/test_pallas_ode_merge.py:
255``), the plan's choices, the libraries per solver, ``auto``, and the
float32 twin within the ``ode_bdf`` row.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood import matrix
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
from pharmsol_tpu_torch.ops import _build, fused_ode
from pharmsol_tpu_torch.utils.f32_budget import (
    F32_BUDGET, STIFF_CASES, f32_error, ode_case, stiff_case,
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


def test_every_stiff_case_and_solver_is_covered():
    assert {c for c, _ in KERNEL_CASES} == set(STIFF_CASES)
    assert {s for _, s in KERNEL_CASES} == {"trbdf2", "kvaerno3", "esdirk34",
                                            "kvaerno5", "bdf"}


@pytest.mark.parametrize("name, solver", [c for c in KERNEL_CASES if c[1] != "bdf"])
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


@pytest.mark.parametrize("solver", ["trbdf2"])
def test_per_segment_twin_matches_the_jax_kernel_without_merging(solver, monkeypatch):
    """The same comparison segment by segment: the JAX plan's switch and the
    port's ``kernel_kwargs(merge=False)``."""
    jm, jdata, sp, jems = stiff_case("two_cmt", 8, 128, seed=6, lib=pst, stack=jnp.stack,
                                     solver=solver)
    tm, tdata, _, tems = stiff_case("two_cmt", 8, 128, seed=6, solver=solver)
    monkeypatch.setenv("PHARMSOL_ODE_NO_MERGE", "1")
    want = np.asarray(jax_psi(jm, jdata, sp, jems, engine="pallas"))
    plan = _plan(tm, tdata, sp, tems)
    assert plan.merge_runs is not None
    rows = fused_ode.psi_ode(*plan.streams, plan.support, plan.rhs,
                             **plan.kernel_kwargs(merge=False))
    got = plan.finalize(rows).numpy()
    assert _rel(got, want) <= 1e-9
    merged = plan.run().numpy()
    assert not np.array_equal(merged, got) and _rel(merged, got) <= 5e-4


@pytest.mark.parametrize("name, solver", [c for c in ENGINE_CASES if c[1] != "bdf"])
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


@pytest.mark.parametrize("solver", [s for s in TMDD_SOLVERS if s != "bdf"])
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


def test_merged_march_sdirk_hermite_capture():
    """The SDIRK tier merges: interior observations are captured by cubic
    Hermite, within 1e-3 of a tight-tolerance integration (by the JAX
    package's compiled engine: seconds)."""
    def build(lib, stack):
        model = lib.ODE(lambda x, p, t, b, r, cov: stack([
            -p[0] * x[0] + b[0], p[0] * x[0] - p[1] * x[1]]),
            out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1,
            nout=1).with_solver("kvaerno3")
        subjects = []
        for i in range(4):
            sb = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
            for t in (0.5, 1.0, 2.0, 4.0, 8.0, 12.0):
                sb = sb.observation(t, float(4 * np.exp(-0.25 * t) + 0.1 * i), 0)
            subjects.append(sb.build())
        ems = lib.AssayErrorModels().add(
            0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))
        return model, lib.Data(subjects), ems

    rng = np.random.default_rng(11)
    sp = np.column_stack([rng.uniform(0.5, 2.0, 8), rng.uniform(0.05, 0.5, 8),
                          rng.uniform(30, 90, 8)])
    model, data, ems = build(pt, torch.stack)
    plan = _plan(model, data, sp, ems)
    assert plan.merge_runs is not None and any(b - a > 1 for a, b in plan.merge_runs)
    merged = plan.run().numpy()
    jm, jdata, jems = build(pst, jnp.stack)
    want = np.asarray(jax_psi(jm.with_tolerances(1e-7, 1e-7), jdata, sp, jems, engine="xla"))
    assert _rel(merged, want) < 1e-3


def test_plan_choices_per_solver():
    """trbdf2 and kvaerno3/esdirk34 merge runs, kvaerno5 and bdf never do, lag
    never does; every stiff solver asks the generator for the Jacobian
    columns; newton_iters and the BDF order cap reach the kernel's arguments."""
    merged = {}
    for solver in ("dopri5", "trbdf2", "kvaerno3", "esdirk34", "kvaerno5", "bdf"):
        model, data, sp, ems = stiff_case("two_cmt", 4, 3, seed=1, solver=solver)
        plan = _plan(model.with_newton_iters(5), data, sp, ems)
        merged[solver] = plan.merge_runs
        kw = plan.kernel_kwargs()
        assert kw["solver"] == solver and kw["newton_iters"] == 5
        assert kw["bdf_max_order"] == fused_ode.BDF_DEFAULT_MAX_ORDER == 3
        assert plan.rhs.jacobian == (solver != "dopri5")
        assert ("rhs_jvp" in plan.rhs.source) == (solver != "dopri5")
    assert merged["dopri5"] is not None
    assert merged["trbdf2"] == merged["kvaerno3"] == merged["esdirk34"] == merged["dopri5"]
    assert merged["kvaerno5"] is None and merged["bdf"] is None
    for solver in ("trbdf2", "bdf"):
        model, data, sp, ems = stiff_case("lag_infusion", 4, 3, seed=1, solver=solver)
        assert _plan(model, data, sp, ems).merge_runs is None
    model, data, sp, ems = stiff_case("two_cmt", 4, 3, seed=1, solver="bdf")
    assert _plan(model, data, sp, ems, bdf_max_order=5).kernel_kwargs()["bdf_max_order"] == 5


def test_each_stiff_solver_builds_a_library_of_its_own():
    """One nvcc command per tier: the implicit solvers name theirs with
    PHARMSOL_ODE_SOLVER and round every operation on its own; dopri5, tsit5
    and expm keep the command they had."""
    model, data, sp, ems = stiff_case("two_cmt", 4, 3, seed=1, solver="bdf")
    rhs = _plan(model, data, sp, ems).rhs
    paths = set()
    for solver, code in (("trbdf2", 3), ("kvaerno3", 4), ("esdirk34", 4), ("kvaerno5", 5),
                         ("bdf", 6)):
        kind = _build.ode_kind(solver)
        cmd = _build.generated_nvcc_command(kind, rhs, Path("out.so"))
        assert f"-DPHARMSOL_ODE_SOLVER={code}" in cmd and "-fmad=false" in cmd
        paths.add(_build.generated_library_path(kind, rhs))
    assert len(paths) == 4  # esdirk34 is kvaerno3's library
    for solver in ("dopri5", "tsit5", "expm"):
        assert _build.ode_kind(solver) is _build.ODE
    plain = _build.generated_nvcc_command(_build.ODE, rhs, Path("out.so"))
    assert not any("PHARMSOL_ODE_SOLVER" in c or "fmad" in c for c in plain)
    assert _build.generated_library_path(_build.ODE, rhs) not in paths


def test_auto_takes_the_fused_engine_for_a_stiff_solver(monkeypatch):
    """``auto`` on a card (forced here) takes the fused plan for every stiff
    solver; an RHS with ``p ** x`` has no Jacobian rule: the plan refuses it
    with the reason, ``auto`` records it and takes the general engine."""
    monkeypatch.setattr(matrix, "_auto_engine", lambda device: ("fused", "forced for the test"))
    for solver in ("trbdf2", "kvaerno3", "esdirk34", "kvaerno5", "bdf"):
        model, data, sp, ems = stiff_case("michaelis_menten", 2, 3, seed=1, solver=solver)
        auto = pt.log_likelihood_matrix(model, data, sp, ems).numpy()
        assert pt.last_engine_decision(model)["engine"] == "fused"
        fused = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
        np.testing.assert_array_equal(auto, fused)
    _, data, _, ems = stiff_case("michaelis_menten", 2, 3, seed=1)
    sp = np.array([[0.5, 15.0, 30.0]])
    bad = pt.ODE(lambda x, p, t, b, r, cov: torch.stack([-(p[0] ** x[0]) + b[0] + r[0]]),
                 out=lambda x, p, t, cov: x[0:1] / p[2], nstates=1, ndrugs=1,
                 nout=1).with_solver("bdf")
    with pytest.raises(PharmsolError, match="no Jacobian in the CUDA kernel"):
        pt.log_likelihood_matrix(bad, data, sp, ems, engine="fused")
    psi = pt.log_likelihood_matrix(bad, data, sp, ems)
    decision = pt.last_engine_decision(bad)
    assert decision["engine"] == "general" and "no derivative rule" in decision["reason"]
    np.testing.assert_array_equal(
        psi.numpy(), pt.log_likelihood_matrix(bad, data, sp, ems, engine="general").numpy())


@pytest.mark.parametrize("name, solver", [c for c in F32_CASES if c[1] != "bdf"])
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
