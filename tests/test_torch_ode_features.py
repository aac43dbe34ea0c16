"""ODE models with covariates, lag, fa and init: the general engine and the
twin of kernel K2e against the JAX package.

Every case of ``utils/f32_budget.py::ODE_FEATURE_CASES`` (K2e's modes: a
constant, a linearly interpolated and a carried-forward covariate, static
lag, fa, lag + fa, lag with an infusion, two inputs whose lagged doses fire
in one segment, lag/fa that change with time or read a time-varying
covariate, init rows and covariate-dependent init planes, tsit5) and the
reference's covariate example are built once per package from the same
numpy seed:

- the port's general engine against JAX ``engine='xla'``, float64, within
  1e-10 relative (both march every lane step for step);
- the port's fused plan, whose twin of K2e runs here, against the JAX plan's
  kernel in interpret mode (``engine='pallas'``, as the JAX tests run it),
  float64, within 1e-9, with the plan's mode (merged runs, lag planes or
  slot tables, init rows or planes, covariate modes) checked;
- the models the JAX plan refuses raise PharmsolError in the port's plan,
  and ``engine='auto'`` (forced onto the fused route, as on a card) records
  the reason and takes the general engine;
- the merged-run lowering never merges across a change of a covariate's
  affine stream, nor at all with lag; the per-dose-segment planes and slot
  tables equal the JAX plan's.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi
from pharmsol_tpu.likelihood.plans.ode import _PallasOdePsiPlan
from pharmsol_tpu.likelihood.plans.ode import _ode_merge_runs as jax_merge_runs

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood import matrix
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan, _ode_merge_runs
from pharmsol_tpu_torch.ops import fused_ode
from pharmsol_tpu_torch.utils.f32_budget import (
    ODE_FEATURE_CASES, covariate_model_case, ode_feature_case,
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


CASES = list(ODE_FEATURE_CASES) + ["covariate_model"]

# what the fused plan must pick per case: merged runs, lag source ("planes",
# "slots" or None), fa source, init ("rows", "planes" or None), covariate modes
EXPECT = {
    "cov_const": (True, None, None, None, ("const",)),
    "cov_linear": (True, None, None, None, ("affine",)),
    "cov_fixed": (True, None, None, None, ("affine",)),
    "lag": (False, "planes", None, None, ()),
    "fa": (True, None, "planes", None, ()),
    "lag_fa": (False, "planes", "planes", None, ()),
    "lag_infusion": (False, "planes", None, None, ()),
    "two_inputs_lag": (False, "planes", None, None, ()),
    "dyn_time": (False, "slots", "slots", None, ()),
    "dyn_cov_lag": (False, "slots", None, None, ("affine",)),
    "init_rows": (True, None, None, "rows", ()),
    "init_planes": (True, None, None, "planes", ("const",)),
    "tsit5_cov": (True, None, None, None, ("affine",)),
    "covariate_model": (False, "planes", None, None, ("const", "affine")),  # age, creatinine
}


def _case(name, lib):
    stack = jnp.stack if lib is pst else None
    if name == "covariate_model":
        return covariate_model_case(6, 12, seed=3, lib=lib, stack=stack)
    return ode_feature_case(name, lib=lib, stack=stack)


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _plan(model, data, sp, ems):
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedOdePsiPlan(model, grid, sp, lowered, torch.device("cpu"), torch.float64)


@pytest.mark.parametrize("name", CASES)
def test_general_engine_matches_jax_xla(name):
    jm, jdata, sp, jems = _case(name, pst)
    tm, tdata, sp2, tems = _case(name, pt)
    np.testing.assert_array_equal(sp, sp2)
    want = np.asarray(jax_psi(jm, jdata, sp, jems, engine="xla"))
    got = pt.log_likelihood_matrix(tm, tdata, sp, tems, engine="general").numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-10


@pytest.mark.parametrize("name", CASES)
def test_twin_matches_the_jax_kernel(name):
    jm, jdata, sp, jems = _case(name, pst)
    tm, tdata, _, tems = _case(name, pt)
    plan = _plan(tm, tdata, sp, tems)
    merged, lag, fa, init, modes = EXPECT[name]
    f = plan.features
    assert (plan.merge_runs is not None) == merged
    assert plan.rhs.cov_modes == modes
    for got_src, planes, slots in ((lag, f["lag_plane"], f["lag_slots"]),
                                   (fa, f["fa_plane"], f["fa_slots"])):
        assert got_src == (None if planes is None else "slots" if slots is not None
                           else "planes")
    assert init == ("rows" if f["init_rows"] is not None
                    else "planes" if f["init_planes"] is not None else None)
    want = np.asarray(jax_psi(jm, jdata, sp, jems, engine="pallas"))
    before = fused_ode.LAUNCHES + fused_ode.FEATURE_LAUNCHES
    got = pt.log_likelihood_matrix(tm, tdata, sp, tems, engine="fused").numpy()
    assert fused_ode.LAUNCHES + fused_ode.FEATURE_LAUNCHES == before  # the twin ran
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-9


# ---------------------------------------------------------------------------
# refusals: the JAX plan's reasons, recorded by engine='auto'
# ---------------------------------------------------------------------------


def _wt_model(lib, stack, **kw):
    return lib.ODE(lambda x, p, t, b, r, cov: stack([-p[0] * (cov("wt", t) / 70.0) * x[0] + b[0]]),
                   out=kw.pop("out", lambda x, p, t, cov: x[0:1] / p[1]),
                   nstates=1, ndrugs=1, nout=1, **kw)


def _oral(lib, stack, **kw):
    return lib.ODE(lambda x, p, t, b, r, cov: stack([-p[0] * x[0] + b[0],
                                                     p[0] * x[0] - p[1] * x[1]]),
                   out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1, **kw)


def _refused(name, lib):
    """(model, data, support, ems) of a model the fused plans refuse."""
    stack = jnp.stack if lib is pst else torch.stack
    sb = lib.Subject.builder("r").bolus(0.0, 100.0, 0)
    sp = np.array([[0.3, 20.0], [0.5, 30.0]])
    if name == "interior_knot":  # JAX tests/test_pallas_ode.py:566
        model = _wt_model(lib, stack)
        sb = (sb.covariate("wt", 0.0, 60.0).covariate("wt", 1.5, 80.0)
              .observation(1.0, 2.0, 0).observation(2.0, 1.0, 0))
    elif name == "overlapping_lag":  # :408
        model = _oral(lib, stack, lag=lambda p, t, cov: {0: p[3]})
        sb = sb.bolus(1.0, 50.0, 0).observation(0.5, 1.0, 0).observation(3.0, 1.0, 0)
        sp = np.array([[1.0, 0.2, 20.0, 1.5], [1.2, 0.3, 30.0, 0.2]])
    elif name == "negative_lag":
        model = _oral(lib, stack, lag=lambda p, t, cov: {0: p[3]})
        sb = sb.observation(1.0, 1.0, 0).observation(3.0, 1.0, 0)
        sp = np.array([[1.0, 0.2, 20.0, -0.3], [1.2, 0.3, 30.0, 0.2]])
    elif name == "covariate_out":
        model = _wt_model(lib, stack, out=lambda x, p, t, cov: x[0:1] / (p[1] * cov("wt", t) / 70.0))
        sb = sb.covariate("wt", 0.0, 60.0).observation(1.0, 2.0, 0).observation(2.0, 1.0, 0)
    else:  # kvaerno5 with a covariate as an exponent of the state: no Jacobian rule
        model = lib.ODE(lambda x, p, t, b, r, cov: stack([
            -p[0] * (cov("wt", t) / 70.0) ** (x[0] / 100.0) * x[0] + b[0]]),
            out=lambda x, p, t, cov: x[0:1] / p[1], nstates=1, ndrugs=1,
            nout=1).with_solver("kvaerno5")
        sb = sb.covariate("wt", 0.0, 60.0).observation(1.0, 2.0, 0).observation(2.0, 1.0, 0)
    ems = lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))
    return model, lib.Data([sb.build()]), sp, ems


REFUSALS = {
    "interior_knot": "change points to fall on event/segment boundaries",
    "overlapping_lag": "inter-dose gap",
    "negative_lag": "negative lag",
    "covariate_out": "out\\(\\) reads a covariate",
    "kvaerno5": "no Jacobian in the CUDA kernel",
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refused_models_take_the_general_engine_under_auto(name, monkeypatch):
    model, data, sp, ems = _refused(name, pt)
    with pytest.raises(PharmsolError, match=REFUSALS[name]):
        _plan(model, data, sp, ems)
    monkeypatch.setattr(matrix, "_auto_engine", lambda device: ("fused", "forced"))
    psi = pt.log_likelihood_matrix(model, data, sp, ems).numpy()
    jm, jdata, _, jems = _refused(name, pst)
    want = np.asarray(jax_psi(jm, jdata, sp, jems, engine="xla"))
    assert _rel(psi, want) <= 1e-10
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general"
    assert "fused plan rejected the model" in decision["reason"]
    assert re.search(REFUSALS[name], decision["reason"])


@pytest.mark.parametrize("name", ["interior_knot", "overlapping_lag", "negative_lag"])
def test_the_jax_plan_refuses_them_too(name):
    jm, jdata, sp, jems = _refused(name, pst)
    with pytest.raises(pst.PharmsolError):
        jax_psi(jm, jdata, sp, jems, engine="pallas")


# ---------------------------------------------------------------------------
# merged runs, slot tables and per-dose-segment planes
# ---------------------------------------------------------------------------


def _affine_streams(rng, R, M, change_cols):
    a = np.ones((R, M)) * rng.uniform(50, 90, (R, 1))
    b = np.zeros((R, M))
    for c in change_cols:
        a[c % R, c:] += 3.0
        b[(c + 1) % R, c:] = 0.5
    return a, b


@pytest.mark.parametrize("seed, M, change_cols", [(0, 12, [4]), (1, 20, [3, 9, 15]),
                                                  (2, 6, [])])
def test_merge_runs_stop_at_covariate_changes_and_lag(seed, M, change_cols):
    rng = np.random.default_rng(seed)
    R = 4
    dt = rng.uniform(0.1, 2.0, (R, M))
    dt[:, -1] = 0.0
    t0 = np.concatenate([np.zeros((R, 1)), np.cumsum(dt, axis=1)[:, :-1]], axis=1)
    bol = np.zeros((R, M))
    bol[:, 0] = 100.0
    streams = [dt, bol, np.zeros((R, M))] + [np.ones((R, M))] * 5
    affine = {"wt": _affine_streams(rng, R, M, change_cols)}
    for solver in ("dopri5", "tsit5"):
        kw = dict(n_bolus_in=1, n_rate_in=1, affine_streams=affine, has_lag=False)
        runs = _ode_merge_runs(streams, t0, solver, **kw)
        assert runs == jax_merge_runs(streams, t0, solver, **kw)
        assert runs is not None
        starts = {a for a, _ in runs}
        assert all(c in starts for c in change_cols)  # never merged across a change
        assert _ode_merge_runs(streams, t0, solver, **dict(kw, has_lag=True)) is None


def test_plans_merge_within_covariate_segments_only():
    plan = _plan(*ode_feature_case("cov_linear"))
    seg_t0 = plan.streams[-1].numpy()
    # the weight's knot at 2 h is a breakpoint: no merged run crosses it
    knot_col = int(np.nonzero(np.isclose(seg_t0[0], 2.0))[0][0])
    assert any(a == knot_col for a, _ in plan.merge_runs)
    assert any(b - a > 1 for a, b in plan.merge_runs)
    assert _plan(*ode_feature_case("lag")).merge_runs is None


@pytest.mark.parametrize("name", ["dyn_time", "dyn_cov_lag"])
def test_slot_planes_match_the_jax_plan(name):
    jm, jdata, sp, jems = _case(name, pst)
    jgrid = jm.lower(jdata.subjects())
    jplan = _PallasOdePsiPlan(jm, jgrid, sp, jems.lower(jm.resolve_output_label, 1), 8)
    plan = _plan(*_case(name, pt))
    assert plan.lag_slots == jplan.lag_slots and plan.fa_slots == jplan.fa_slots
    R, S = plan.R, plan.S
    for key, jp in (("lag_plane", jplan.lag_planes_dev), ("fa_plane", jplan.fa_planes_dev)):
        got = plan.features[key]
        assert (got is None) == (jp is None)
        if got is not None:
            want = np.stack([np.asarray(p)[:R, :S] for p in jp])
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0.0)


def test_wrapper_validates_the_feature_inputs():
    plan = _plan(*ode_feature_case("lag_fa"))
    args = (*plan.streams, plan.support, plan.rhs)
    kw = plan.kernel_kwargs()
    with pytest.raises(ValueError, match="incompatible with lag"):
        fused_ode.psi_ode(*args, **dict(kw, merge_runs=((0, plan.M),)))
    with pytest.raises(ValueError, match="lag_plane carries"):
        fused_ode.psi_ode(*args, **dict(kw, lag_plane=torch.cat([kw["lag_plane"]] * 2)))
    cov_plan = _plan(*ode_feature_case("cov_linear"))
    ckw = cov_plan.kernel_kwargs()
    cargs = (*cov_plan.streams, cov_plan.support, cov_plan.rhs)
    with pytest.raises(ValueError, match="an \\(a, b\\) pair"):
        fused_ode.psi_ode(*cargs, **dict(ckw, cov_streams={"wt": ckw["cov_streams"]["wt"][0]}))
    with pytest.raises(ValueError, match="differ from the RHS"):
        fused_ode.psi_ode(*cargs, **dict(ckw, cov_names=()))
    init_plan = _plan(*ode_feature_case("init_rows"))
    ikw = init_plan.kernel_kwargs()
    with pytest.raises(ValueError, match="go together"):
        fused_ode.psi_ode(*init_plan.streams, init_plan.support, init_plan.rhs,
                          **dict(ikw, init_mask=None))
