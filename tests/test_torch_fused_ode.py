"""The fused ODE path: its plain twin against the JAX package's ODE kernel.

``psi_ode_plain`` (through ``_FusedOdePsiPlan``) runs the explicit tier of
the JAX kernel ``ops/pallas_ode.py::psi_ode`` step for step, so against that
kernel in interpret mode (float64, 8 x 128, the JAX tile) the two agree to
rounding: within 1e-9 relative. Against the port's general engine, which
stops at every breakpoint and starts its step differently, they agree at the
controller's error level: within 1e-4 (the bound of the JAX package's own
``test_pallas_ode.py:82``). The merged-run lowering is held against the JAX
function it copies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi
from pharmsol_tpu.likelihood.plans.ode import _ode_merge_runs as jax_merge_runs
from pharmsol_tpu.ops.pallas_psi import streams_from_grid as jax_streams

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan, _ode_merge_runs
from pharmsol_tpu_torch.ops import fused_ode
from pharmsol_tpu_torch.ops.fused_psi import streams_from_grid
from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, ODE_CASES, f32_error, ode_case


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


R_TILE, S_TILE = 8, 128


def _bolus_infusion(xp):
    return lambda x, p, t, b, r, cov: xp.stack([
        -p[0] * x[0] + b[0],
        p[0] * x[0] - p[1] * x[1] + r[0],
    ])


def _multi_input(xp):
    return lambda x, p, t, b, r, cov: xp.stack([
        -p[0] * x[0] + b[0] + r[1],
        -p[1] * x[1] + b[1],
        p[0] * x[0] + p[1] * x[1] - p[2] * x[2] + r[0],
    ])


def _ems():
    return pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1), 1.0))


def _bolus_infusion_case(times=(0.5, 1.0, 2.0, 4.0, 8.0)):
    """8 subjects (a bolus, an infusion on every third, 5 observations) x 128
    supports, as the JAX package's test_pallas_ode.py:41-69."""
    subjects = []
    for i in range(R_TILE):
        sb = pst.SubjectBuilder(f"s{i}").bolus(0.0, 100.0, 0)
        if i % 3 == 0:
            sb = sb.infusion(2.0, 50.0, 0, 1.0)
        for t in times:
            sb = sb.observation(t, float(5 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subjects.append(sb.build())
    rng = np.random.default_rng(0)
    sp = np.column_stack([rng.uniform(0.5, 2.0, S_TILE),
                          rng.uniform(0.05, 0.5, S_TILE),
                          rng.uniform(30, 90, S_TILE)])
    out = lambda x, p, t, cov: x[1:2] / p[2]  # noqa: E731
    return (pst.ODE(_bolus_infusion(jnp), out=out, nstates=2, ndrugs=1, nout=1),
            pt.ODE(_bolus_infusion(torch), out=out, nstates=2, ndrugs=1, nout=1),
            pst.Data(subjects), sp)


def _multi_input_case():
    """The ode_multi_input budget case (two inputs) widened to 128 supports."""
    rng = np.random.RandomState(47)
    subjects = []
    for i in range(R_TILE):
        b = (pst.SubjectBuilder(f"m{i}").bolus(0.0, 100.0, 0)
             .bolus(1.0, 60.0, 1).infusion(2.0, 40.0, 1, 1.5))
        for t in (0.5, 1.5, 3.0, 5.0, 8.0, 12.0):
            b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
        subjects.append(b.build())
    sp = np.column_stack([rng.uniform(0.5, 2.0, S_TILE), rng.uniform(0.3, 1.2, S_TILE),
                          rng.uniform(0.05, 0.5, S_TILE), rng.uniform(8, 14, S_TILE)])
    out = lambda x, p, t, cov: x[2:3] / p[3]  # noqa: E731
    return (pst.ODE(_multi_input(jnp), out=out, nstates=3, ndrugs=2, nout=1),
            pt.ODE(_multi_input(torch), out=out, nstates=3, ndrugs=2, nout=1),
            pst.Data(subjects), sp)


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


@pytest.mark.parametrize("case, solver, merged", [
    ("bolus_infusion", "dopri5", True),
    ("bolus_infusion", "dopri5", False),
    ("bolus_infusion", "tsit5", True),
    ("bolus_infusion", "tsit5", False),
    ("multi_input", "dopri5", True),
    ("zero_offset", "dopri5", True),
])
def test_twin_matches_the_jax_kernel(case, solver, merged, monkeypatch):
    """``zero_offset``: an observation at the infusion's end (3 h) opens a
    merged run at offset 0 and is read from the run's start state; the one
    at the infusion's start (2 h) closes the run before it. Per segment:
    the JAX plan's switch, and the port plan's ``merge=False``."""
    if not merged:
        monkeypatch.setenv("PHARMSOL_ODE_NO_MERGE", "1")
    jm, tm, data, sp = {
        "bolus_infusion": _bolus_infusion_case,
        "multi_input": _multi_input_case,
        "zero_offset": lambda: _bolus_infusion_case((0.5, 1.0, 2.0, 3.0, 4.0, 8.0)),
    }[case]()
    jm, tm = jm.with_solver(solver), tm.with_solver(solver)
    want = np.asarray(jax_psi(jm, data, sp, _ems(), engine="pallas"))
    pdata, pems = convert.data_from_reference(data), convert.error_models_from_reference(_ems())
    before = fused_ode.LAUNCHES
    if merged:
        got = pt.log_likelihood_matrix(tm, pdata, sp, pems, engine="fused").numpy()
    else:
        plan = _plan(tm, pdata, sp, pems)
        got = plan.finalize(fused_ode.psi_ode(
            *plan.streams, plan.support, plan.rhs,
            **plan.kernel_kwargs(merge=False))).numpy()
    assert fused_ode.LAUNCHES == before  # the twin ran: CPU tensors
    assert got.shape == (R_TILE, S_TILE) and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-9
    general = pt.log_likelihood_matrix(tm, pdata, sp, pems, engine="general").numpy()
    assert _rel(got, general) <= 1e-4


def test_exhausted_step_budget_matches_the_jax_kernel():
    jm, tm, data, sp = _bolus_infusion_case()
    jm, tm = jm.with_max_steps(10), tm.with_max_steps(10)
    want = np.asarray(jax_psi(jm, data, sp[:16], _ems(), engine="pallas"))
    got = pt.log_likelihood_matrix(tm, convert.data_from_reference(data), sp[:16],
                                   convert.error_models_from_reference(_ems()),
                                   engine="fused").numpy()
    assert np.isneginf(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert _rel(got[fin], want[fin]) <= 1e-9


def _plan(model, data, sp, ems):
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedOdePsiPlan(model, grid, sp, lowered, torch.device("cpu"), torch.float64)


@pytest.mark.parametrize("name", list(ODE_CASES))
@pytest.mark.parametrize("merged", [True, False])
def test_twin_against_general_engine_on_budget_cases(name, merged):
    """Censored (BLOQ + ALOQ), multi-input, lag + fa and time-varying
    covariate cases: the fused twin agrees with the general engine at the
    controller's error level (lag marches segment by segment; expm and bdf
    never merge; bdf's kernel has three controller rules the engine lacks:
    5e-4, the JAX tests' tolerance for it)."""
    model, data, sp, ems = ode_case(name)
    plan = _plan(model, data, sp, ems)
    assert (plan.merge_runs is None) == (name in ("ode_lag_fa", "ode_expm", "ode_bdf"))
    got = plan.finalize(fused_ode.psi_ode(*plan.streams, plan.support, plan.rhs,
                                          **plan.kernel_kwargs(merged))).numpy()
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) <= (5e-4 if name == "ode_bdf" else 1e-4)


@pytest.mark.parametrize("name", list(ODE_CASES))
def test_twin_float32_within_the_ode_budget(name):
    """The float32 twin against the float64 twin on each budget row's own
    case (the card holds the kernel to the same rows)."""
    model, data, sp, ems = ode_case(name)
    golden = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    pt.set_float_dtype(torch.float32)
    try:
        got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    finally:
        pt.set_float_dtype(torch.float64)
    assert got.dtype == torch.float32
    assert f32_error(got.numpy(), golden.numpy()) <= F32_BUDGET[name]


def test_two_outputs_with_bias_against_general_engine():
    model = pt.ODE(
        lambda x, p, t, b, r, cov: torch.stack([-p[0] * x[0] + b[0],
                                                p[0] * x[0] - p[1] * x[1]]),
        out=lambda x, p, t, cov: torch.stack([x[0] / p[2], x[1] / p[2] + 0.1 * p[2]]),
        nstates=2, ndrugs=1, nout=2)
    subjects = []
    for i in range(6):
        b = pt.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for k, t in enumerate((0.0, 0.5, 1.5, 3.0, 6.0)):
            b = b.observation(t, float(3 * np.exp(-0.3 * t) + 0.1 * k), k % 2)
        b = b.censored_observation(8.0, 0.1, 0, pt.Censor.BLOQ)
        subjects.append(b.build())
    ems = (pt.AssayErrorModels()
           .add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
           .add(1, pt.AssayErrorModel.proportional(pt.ErrorPoly(0.0, 0.2), 1.0)))
    rng = np.random.default_rng(9)
    sp = np.column_stack([rng.uniform(0.5, 2.0, 12), rng.uniform(0.05, 0.5, 12),
                          rng.uniform(30, 90, 12)])
    data = pt.Data(subjects)
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("case", ["bolus_infusion", "multi_input"])
def test_per_input_streams_match_jax(case):
    jm, tm, data, sp = (_bolus_infusion_case() if case == "bolus_infusion"
                        else _multi_input_case())
    jgrid = jm.lower(data.subjects())
    lowered = _ems().lower(jm.resolve_output_label, jm.nouteqs())
    ninput = jm.ndrugs()
    want = jax_streams(jgrid.rows, lowered, inputs=ninput)
    tgrid = tm.lower(convert.data_from_reference(data).subjects())
    tlow = convert.error_models_from_reference(_ems()).lower(
        tm.resolve_output_label, tm.nouteqs())
    got = streams_from_grid(tgrid.rows, tlow, inputs=ninput)
    assert got[1].shape[-1] == ninput and got[2].shape[-1] == ninput
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _random_streams(rng, R, M, nb, nr, bolus_cols, rate_change_cols, gap_col=None):
    dt = rng.uniform(0.1, 2.0, (R, M))
    dt[:, -1] = 0.0
    t0 = np.concatenate([np.zeros((R, 1)), np.cumsum(dt, axis=1)[:, :-1]], axis=1)
    if gap_col is not None:
        t0[0, gap_col:] += 0.5  # a discontinuity on one row
    bol = [np.zeros((R, M)) for _ in range(nb)]
    for c in bolus_cols:
        bol[c % nb][c % R, c] = 10.0
    rate = [np.ones((R, M)) for _ in range(nr)]
    for c in rate_change_cols:
        rate[0][:, c:] += 1.0
    rest = [np.ones((R, M))] * 5
    return [dt, *bol, *rate, *rest], t0


@pytest.mark.parametrize("seed, M, bolus_cols, rate_cols, gap", [
    (0, 10, [0], [], None),
    (1, 40, [0, 7, 20], [12], None),
    (2, 12, [0, 5], [3, 9], 8),
    (3, 3, [0, 1, 2], [], None),
    (4, 25, [0], [], 14),
])
def test_merge_runs_match_jax(seed, M, bolus_cols, rate_cols, gap):
    rng = np.random.default_rng(seed)
    for nb, nr in ((1, 1), (2, 1)):
        streams, t0 = _random_streams(rng, 5, M, nb, nr, bolus_cols, rate_cols, gap)
        for solver in ("dopri5", "tsit5"):
            kw = dict(n_bolus_in=nb, n_rate_in=nr, affine_streams={}, has_lag=False)
            got = _ode_merge_runs(streams, t0, solver, **kw)
            assert got == jax_merge_runs(streams, t0, solver, **kw)
    # the span cap, and no merging at all when no span would merge
    streams, t0 = _random_streams(rng, 2, 40, 1, 1, [0], [])
    runs = _ode_merge_runs(streams, t0, "dopri5", n_bolus_in=1, n_rate_in=1,
                           affine_streams={}, has_lag=False)
    assert max(b - a for a, b in runs) == 16
    assert _ode_merge_runs(streams, t0, "dopri5", n_bolus_in=1, n_rate_in=1,
                           affine_streams={}, has_lag=True) is None


def test_dense_interpolants_reproduce_the_step():
    """theta = 1 reproduces the step weights B (dopri5 published, tsit5
    derived from the order conditions), as the JAX package's."""
    from pharmsol_tpu.ops.pallas_ode import dense_P_for as jax_dense_P_for

    from pharmsol_tpu_torch.engine.ode import TABLEAUS

    for solver in ("dopri5", "tsit5"):
        P = np.asarray(fused_ode.dense_P_for(solver))
        np.testing.assert_allclose(P.sum(axis=1), TABLEAUS[solver][1], atol=1e-12)
        np.testing.assert_allclose(P, np.asarray(jax_dense_P_for(solver)), atol=1e-12)


def test_wrapper_validates_its_inputs():
    model, data, sp, ems = ode_case("ode_dopri5")
    plan = _plan(model, data, sp, ems)
    kw = plan.kernel_kwargs()
    with pytest.raises(ValueError, match="tile"):
        fused_ode.psi_ode(*plan.streams, plan.support, plan.rhs,
                          **dict(kw, merge_runs=((0, 2), (3, plan.M))))
    with pytest.raises(ValueError, match="solvers"):
        fused_ode.psi_ode(*plan.streams, plan.support, plan.rhs,
                          **dict(kw, solver="rk4"))
    # an implicit solver needs the Jacobian columns beside the RHS
    with pytest.raises(ValueError, match="jacobian=True"):
        fused_ode.psi_ode(*plan.streams, plan.support, plan.rhs,
                          **dict(kw, solver="bdf", merge_runs=None))
    with pytest.raises(ValueError, match="support must be"):
        fused_ode.psi_ode(*plan.streams, plan.support[:, :2].contiguous(),
                          plan.rhs, **kw)


def test_plan_rejects_what_the_kernel_does_not_run():
    """An unknown solver is refused; the stiff solvers and a covariate are
    not: kvaerno5 gets a plan with the Jacobian columns and no merged run,
    and the ODE with a covariate runs in every engine, fused equal to general
    within 1e-4."""
    model, data, sp, ems = ode_case("ode_dopri5")
    with pytest.raises(PharmsolError, match="unknown ODE solver"):
        _plan(model.with_solver("rk4"), data, sp, ems)
    stiff = _plan(model.with_solver("kvaerno5"), data, sp, ems)
    assert stiff.solver == "kvaerno5" and stiff.rhs.jacobian and stiff.merge_runs is None
    model.with_solver("dopri5")
    cov_model = pt.ODE(
        lambda x, p, t, b, r, cov: torch.stack([
            -p[0] * x[0] + b[0],
            p[0] * x[0] - p[1] * (cov("wt", t) / 70.0) ** 0.75 * x[1] + r[0]]),
        out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
    cov_data = pt.Data([pt.Subject.builder(f"c{i}").bolus(0.0, 100.0, 0)
                        .covariate("wt", 0.0, 50.0 + 10.0 * i).observation(1.0, 4.0, 0)
                        .observation(4.0, 2.0, 0).build() for i in range(4)])
    psi = {engine: pt.log_likelihood_matrix(cov_model, cov_data, sp, ems, engine=engine).numpy()
           for engine in ("auto", "fused", "general")}
    assert pt.last_engine_decision(cov_model)["engine"] == "general"  # auto on the CPU
    for got in psi.values():
        assert got.shape == (4, sp.shape[0]) and np.isfinite(got).all()
    np.testing.assert_array_equal(psi["auto"], psi["general"])
    assert _rel(psi["fused"], psi["general"]) <= 1e-4
