"""Kernel K1c's twin: lag with a time-varying or time-dependent seq.

A lag moves each dose's seq-reset breakpoint to the per-(row, support) fire
time; the fused plan walks each lane's chain on the host
(``plans/seq.py::_decompose_seq_colplanes``) into per-column main and post
planes, and the kernel runs a true split march (``lag_post``). These are the
JAX package's ``test_pallas_seq_colplanes.py`` cases (all 13), written once
per framework: on the CPU ``engine='fused'`` runs the plain twin of K1c,
held, float64, against the JAX kernel in interpret mode (``engine='pallas'``,
how the JAX package's own tests run it) within 1e-9 relative and against the
port's general engine within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood.plans.analytical import _FusedPsiPlan
from pharmsol_tpu_torch.ops import fused_psi
from pharmsol_tpu_torch.utils.f32_budget import k1c_case


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _ems(lib=pst):
    return lib.AssayErrorModels().add(0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def _subjects(n=6, with_inf=True, multi_dose=True):
    out = []
    for i in range(n):
        sb = pst.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        if multi_dose:
            sb = sb.bolus(6.0, 80.0, 0)
        if with_inf and i % 2 == 0:
            sb = sb.infusion(3.0, 50.0, 0, 1.0)
        sb = (sb.covariate("wt", 0.0, 55.0 + 4.0 * i).covariate("wt", 4.0, 62.0 + 3.0 * i)
              .covariate("wt", 8.0, 50.0 + 2.0 * i))
        for t in (0.5, 1.5, 3.5, 5.0, 7.5, 10.0):
            sb = sb.observation(t, float(4 * np.exp(-0.25 * t) + 0.05 * i), 0)
        out.append(sb.build())
    return pst.Data(out)


def _plan(model, data, sp, ems):
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedPsiPlan(model, grid, sp, lowered, torch.device("cpu"), torch.float64)


def _check(make, data, sp, ems=None):
    """The JAX kernel (interpret mode) against the port's twin, and the twin
    against the port's general engine; returns the port's plan."""
    ems = ems or _ems()
    want = np.asarray(jax_psi(make(jnp, pst), data, sp, ems, engine="pallas"))
    model = make(torch, pt)
    pdata, pems = convert.data_from_reference(data), convert.error_models_from_reference(ems)
    before = (fused_psi.LAUNCHES, fused_psi.FEATURE_LAUNCHES)
    got = pt.log_likelihood_matrix(model, pdata, sp, pems, engine="fused").numpy()
    assert (fused_psi.LAUNCHES, fused_psi.FEATURE_LAUNCHES) == before  # the twin ran
    general = pt.log_likelihood_matrix(model, pdata, sp, pems, engine="general").numpy()
    assert np.isfinite(want).all()
    assert _rel(got, want) <= 1e-9
    assert _rel(got, general) <= 1e-10
    return _plan(model, pdata, sp, pems)


def _affine_tv(xp, lib):
    return lib.Analytical(
        lib.one_compartment_with_absorption, out=lambda x, p, t, cov: x[1:2] / p[2],
        seq_eq=lambda p, t, cov: xp.stack([p[0], p[1] * (cov("wt", t) / 70.0) ** 0.75, p[2],
                                           p[3]]),
        lag=lambda p, t, cov: {0: p[3]}, nstates=2, ndrugs=1, nout=1)


def _sp4(seed, lag_lo, lag_hi, n=12):
    rng = np.random.RandomState(seed)
    return np.column_stack([rng.uniform(0.8, 2.0, n), rng.uniform(0.1, 0.3, n),
                            rng.uniform(8, 15, n), rng.uniform(lag_lo, lag_hi, n)])


@pytest.mark.parametrize("multi_dose, with_inf", [(False, False), (False, True), (True, False),
                                                  (True, True)])
def test_lag_affine_tv_seq_all_regimens(multi_dose, with_inf):
    plan = _check(_affine_tv, _subjects(with_inf=with_inf, multi_dose=multi_dose),
                  _sp4(11, 0.1, 1.2))
    assert plan.features["seg_postdepth"] is not None


@pytest.mark.parametrize("multi_dose, with_inf", [(False, True), (True, True)])
def test_lag_nonaffine_tv_seq_mixing(multi_dose, with_inf):
    def make(xp, lib):
        return lib.Analytical(
            lib.one_compartment_with_absorption, out=lambda x, p, t, cov: x[1:2] / p[2],
            seq_eq=lambda p, t, cov: xp.stack([
                p[0] * (cov("wt", t) / 70.0) ** p[3],
                p[1] * xp.exp(-0.001 * p[0] * cov("wt", t)), p[2], p[3]]),
            lag=lambda p, t, cov: {0: 0.4 + 0.5 * p[3]}, nstates=2, ndrugs=1, nout=1)

    _check(make, _subjects(with_inf=with_inf, multi_dose=multi_dose), _sp4(12, 0.4, 1.0))


def test_lag_time_dependent_seq():
    def make(xp, lib):
        return lib.Analytical(
            lib.one_compartment_with_absorption, out=lambda x, p, t, cov: x[1:2] / p[2],
            seq_eq=lambda p, t, cov: xp.stack([p[0] * xp.exp(-0.02 * p[1] * t), p[1], p[2],
                                               p[3]]),
            lag=lambda p, t, cov: {0: p[3]}, nstates=2, ndrugs=1, nout=1)

    subs = []
    for i in range(6):
        sb = pst.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).bolus(6.0, 80.0, 0)
        for t in (0.5, 1.5, 3.5, 5.0, 7.5, 10.0):
            sb = sb.observation(t, float(4 * np.exp(-0.25 * t)), 0)
        subs.append(sb.build())
    _check(make, pst.Data(subs), _sp4(13, 0.2, 1.2))


def test_lag_fire_crossing_observations():
    def make(xp, lib):
        return lib.Analytical(
            lib.two_compartments, out=lambda x, p, t, cov: x[0:1] / p[3],
            seq_eq=lambda p, t, cov: xp.stack([p[0] * (cov("wt", t) / 70.0) ** p[4], p[1],
                                               p[2], p[3], p[4]]),
            lag=lambda p, t, cov: {0: 3.0 * p[4]}, nstates=2, ndrugs=1, nout=1)

    rng = np.random.RandomState(14)
    sp = np.column_stack([rng.uniform(0.1, 0.3, 12), rng.uniform(0.2, 0.4, 12),
                          rng.uniform(0.1, 0.3, 12), rng.uniform(8, 15, 12),
                          rng.uniform(0.5, 1.0, 12)])
    _check(make, _subjects(multi_dose=False), sp)


def _fixed_lag(lag_h):
    def make(xp, lib):
        return lib.Analytical(
            lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
            seq_eq=lambda p, t, cov: xp.stack([p[0] * (cov("wt", t) / 70.0) ** 0.5, p[1]]),
            lag=lambda p, t, cov: {0: lag_h}, nstates=1, ndrugs=1, nout=1)
    return make


def test_lag_equal_to_dose_gap_rejected():
    """At lag == the dose gap the kernel's single pending slot would be
    overwritten in the column where the old dose fires: the plan refuses
    the boundary (strict >=) and is exact just inside it."""
    rng = np.random.RandomState(15)
    sp = np.column_stack([rng.uniform(0.1, 0.3, 8), rng.uniform(8, 15, 8)])
    data = _subjects(with_inf=False)
    with pytest.raises(PharmsolError, match="strictly before"):
        pt.log_likelihood_matrix(_fixed_lag(6.0)(torch, pt), convert.data_from_reference(data),
                                 sp, _ems(pt), engine="fused")
    _check(_fixed_lag(5.75), data, sp)


def test_colplanes_plan_takes_the_post_stream():
    sp = _sp4(16, 0.1, 1.2, n=6)
    data = convert.data_from_reference(_subjects())
    plan = _plan(_affine_tv(torch, pt), data, sp, _ems(pt))
    f = plan.features
    assert f["seg_postdepth"] is not None and f["param_planes"] is not None
    assert f["seg_depth"] is not None and f["seg_evcode"] is None
    L = f["param_planes"].shape[0]
    assert 1 <= int(f["seg_depth"].max()) <= L and int(f["seg_postdepth"].max()) <= L


def test_zero_fa_cell_rejected_in_split_march():
    """A support whose fa is exactly 0 would never fire its pending dose,
    so the seq reset the engine applies at the shifted time would be
    skipped: the plan refuses; with every fa positive the tier runs."""
    def make(xp, lib):
        return lib.Analytical(
            lib.one_compartment_with_absorption, out=lambda x, p, t, cov: x[1:2] / p[2],
            seq_eq=lambda p, t, cov: xp.stack([p[0], p[1] * (cov("wt", t) / 70.0) ** 0.75,
                                               p[2], p[3]]),
            lag=lambda p, t, cov: {0: p[3]},
            fa=lambda p, t, cov: {0: 0.5 * (p[3] - 0.5 + abs(p[3] - 0.5))},
            nstates=2, ndrugs=1, nout=1)

    rng = np.random.RandomState(17)
    sp = np.column_stack([rng.uniform(0.8, 2.0, 8), rng.uniform(0.1, 0.3, 8),
                          rng.uniform(8, 15, 8),
                          np.concatenate([rng.uniform(0.6, 1.2, 7), [0.3]])])
    data = _subjects(with_inf=False, multi_dose=False)
    with pytest.raises(PharmsolError, match="exactly zero"):
        pt.log_likelihood_matrix(make(torch, pt), convert.data_from_reference(data), sp,
                                 _ems(pt), engine="fused")
    sp_ok = sp.copy()
    sp_ok[-1, 3] = 0.8
    _check(make, data, sp_ok)


def test_colplanes_f32_budget_case_takes_the_tier():
    """The committed K1c cases take the tier they name, and their float32
    twin stays within the budget row against the float64 one."""
    from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, K1C_CASES, f32_error

    want_tier = {"lag_seq_depth": "seg_evcode", "seq_colplanes": "seg_postdepth"}
    for name, row in K1C_CASES.items():
        model, data, sp, ems = k1c_case(name, n_subjects=6, n_support=5)
        f = _plan(model, data, sp, ems).features
        if row in want_tier:
            assert f[want_tier[row]] is not None, name
        else:
            assert f["lag_slots"] is not None or f["fa_slots"] is not None, name
        golden = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
        pt.set_float_dtype(torch.float32)
        try:
            got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
        finally:
            pt.set_float_dtype(torch.float64)
        assert got.dtype == torch.float32
        assert f32_error(got.numpy(), golden.numpy()) <= F32_BUDGET[row], name


def _dyn_subjects(seed):
    rng = np.random.RandomState(seed)
    subs = []
    for i in range(4):
        sb = pst.Subject.builder(f"g{i}").bolus(0.0, 100.0, 0).infusion(1.0, 50.0, 0, 1.5)
        if i % 2 == 0:
            sb = sb.bolus(3.0, 60.0, 0)
        for t in (0.5, 1.2, 2.1, 3.5, 4.5, 6.0):
            sb = sb.observation(float(t), float(np.abs(3 + rng.randn())), 0)
        subs.append(sb.build())
    return pst.Data(subs), rng


def test_dynamic_lag_with_covfree_seq_exact():
    """A time-dependent lag with a covariate-free seq: the in-kernel depth
    counter with per-dose-segment lag slot tables."""
    def make(xp, lib):
        return lib.Analytical(
            lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
            seq_eq=lambda p, t, cov: xp.stack([p[0] * (1.0 + 0.15 * p[2]), p[1], p[2]]),
            lag=lambda p, t, cov: {0: p[2] * (1.0 + 0.05 * t)}, nstates=1, ndrugs=1, nout=1)

    data, rng = _dyn_subjects(21)
    sp = np.abs(np.column_stack([0.2 * (1 + 0.15 * rng.randn(8)),
                                 11.0 * (1 + 0.15 * rng.randn(8)), rng.uniform(0.1, 0.6, 8)]))
    plan = _check(make, data, sp)
    assert plan.features["seg_evcode"] is not None and plan.lag_slots is not None


def _tv_two_dose_subjects():
    subs = []
    for i in range(4):
        sb = (pst.Subject.builder(f"h{i}").bolus(0.0, 100.0, 0).bolus(6.0, 80.0, 0)
              .covariate("wt", 0.0, 55.0 + 4 * i).covariate("wt", 4.0, 62.0 + 3 * i))
        for t in (0.5, 1.5, 3.5, 7.5):
            sb = sb.observation(float(t), float(4 * np.exp(-0.25 * t) + 0.05 * i), 0)
        subs.append(sb.build())
    return pst.Data(subs)


@pytest.mark.parametrize("lag", ["time_dependent", "reads_the_covariate"])
def test_dynamic_lag_with_tv_seq_exact(lag):
    """A dynamic lag with a time-varying covariate seq: the column walk takes
    exact per-dose-column lag planes (every fire time is still host-known);
    with the lag reading the covariate the seq reads, the hardest case."""
    lag_fn = {"time_dependent": lambda p, t, cov: {0: p[3] * (1.0 + 0.05 * t)},
              "reads_the_covariate": lambda p, t, cov: {0: p[3] * cov("wt", t) / 70.0}}[lag]

    def make(xp, lib):
        return lib.Analytical(
            lib.one_compartment_with_absorption, out=lambda x, p, t, cov: x[1:2] / p[2],
            seq_eq=lambda p, t, cov: xp.stack([p[0], p[1] * (cov("wt", t) / 70.0) ** 0.75,
                                               p[2], p[3]]),
            lag=lag_fn, nstates=2, ndrugs=1, nout=1)

    plan = _check(make, _tv_two_dose_subjects(), _sp4(22, 0.1, 0.8, n=6))
    assert plan.features["seg_postdepth"] is not None and plan.lag_slots is not None
