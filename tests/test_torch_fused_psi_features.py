"""The feature tier of the fused psi plan and the twin of kernel K1b.

On the CPU ``engine='fused'`` builds ``_FusedPsiPlan`` and runs K1b's plain
twin ``psi_analytical_plain``; the CUDA kernel is held against that twin on
the card (``chip_smoke.py``, ``test_torch_cuda.py``). Here, float64:

- every mode of K1b (``FEATURE_CASES``: row, row with offsets, segment,
  segment with offsets, levels, planes, segment-indexed planes, lag + fa,
  lag with a depth-1 seq, init rows and planes) against the JAX package's
  ``engine='xla'`` within 1e-9 relative, with the plan's mode checked;
- two cases against the JAX package's Pallas kernel in interpret mode, how
  the JAX package's own tests run it on the CPU;
- the configurations of kernel K1c: ``engine='fused'`` runs its twin, equal
  to the general engine, and ``engine='auto'`` keeps the fused engine;
- float32 within the feature budget rows.
"""

import functools

import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood import matrix
from pharmsol_tpu_torch.likelihood.plans.analytical import _FusedPsiPlan
from pharmsol_tpu_torch.ops import fused_psi
from pharmsol_tpu_torch.ops.fused_psi import psi_analytical, psi_analytical_plain
from pharmsol_tpu_torch.utils.f32_budget import (
    F32_BUDGET, FEATURE_BUDGETS, FEATURE_CASES, f32_error, feature_budget_case,
    feature_case,
)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _plan(model, data, sp, ems, dtype=torch.float64):
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedPsiPlan(model, grid, sp, lowered, torch.device("cpu"), dtype)


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


@pytest.mark.parametrize("name", list(FEATURE_CASES))
def test_twin_matches_jax_xla(name):
    mj, dj, spj, ej, mode = feature_case(name, seed=3, lib=pst)
    model, data, sp, ems, _ = feature_case(name, seed=3)
    plan = _plan(model, data, sp, ems)
    assert plan.mode == mode
    assert any(v is not None for v in plan.features.values())
    want = np.asarray(jax_psi(mj, dj, spj, ej, engine="xla"))
    before = (fused_psi.LAUNCHES, fused_psi.FEATURE_LAUNCHES)
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    # the CPU runs the twin, not a launch
    assert (fused_psi.LAUNCHES, fused_psi.FEATURE_LAUNCHES) == before
    assert _rel(got, want) <= 1e-9


@pytest.mark.parametrize("name", ["row_lag_fa", "segment_offset"])
def test_twin_matches_the_jax_kernel_in_interpret_mode(name):
    mj, dj, spj, ej, _ = feature_case(name, seed=5, lib=pst)
    model, data, sp, ems, _ = feature_case(name, seed=5)
    want = np.asarray(jax_psi(mj, dj, spj, ej, engine="pallas"))
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    assert _rel(got, want) <= 1e-9


def test_plan_inputs():
    model, data, sp, ems, _ = feature_case("row_lag_fa", n_subjects=5, n_support=7)
    plan = _plan(model, data, sp, ems)
    f = plan.features
    assert tuple(f["param_mult"].shape) == (5, 4)
    # the allometric factor on ke, kcp and kpc; ka untouched
    wt = np.asarray(model.lower(data.subjects()).rows.cov_v)[:, 0, 0]
    np.testing.assert_allclose(f["param_mult"][:, 0].numpy(), (wt / 70.0) ** 0.75)
    np.testing.assert_allclose(f["param_mult"][:, 1].numpy(), 1.0)
    # lag and fa read no covariate: one row per support, not an [R, S] plane
    assert tuple(f["lag_plane"].shape) == (1, 7) and tuple(f["fa_plane"].shape) == (1, 7)
    np.testing.assert_allclose(f["lag_plane"].numpy(), sp[None, :, 5])
    np.testing.assert_allclose(f["fa_plane"].numpy(), sp[None, :, 6])
    assert f["seg_depth"] is None and f["init_mask"] is None
    # no feature at all: K1a's inputs
    base = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                         nstates=1, ndrugs=1, nout=1)
    plan = _plan(base, data, sp[:, [0, 4]].copy(), ems)
    assert plan.mode is None and all(v is None for v in plan.features.values())


def _lag_depth_subjects(lib, n=6):
    # JAX tests/test_pallas_psi.py:1304: the infusion end compounds the seq
    # chain past depth 1 while the lag moves the dose's reset
    out = []
    for i in range(n):
        b = (lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
             .infusion(1.0, 50.0, 0, 1.5).covariate("wt", 0.0, 55.0 + 4.0 * i))
        for t in (0.5, 1.2, 2.1, 3.0, 4.5, 6.0, 10.0):
            b = b.observation(t, float(5 * np.exp(-0.2 * t) + 0.05 * i), 0)
        out.append(b.build())
    return lib.Data(out)


def _tv_subjects(lib, n=6):
    out = []
    for i in range(n):
        b = (lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).bolus(12.0, 50.0, 0)
             .covariate("wt", 0.0, 55.0 + 4.0 * i).covariate("wt", 6.0, 66.0 - 3.0 * i))
        for t in (1.0, 2.5, 4.0, 9.0, 14.0):
            b = b.observation(t, float(4 * np.exp(-0.2 * t) + 0.05 * i), 0)
        out.append(b.build())
    return lib.Data(out)


def _out1(x, p, t, cov):
    return x[0:1] / p[1]


# the configurations of kernel K1c: (model, data) builders
K1C = {
    "time_dependent_lag": lambda: (pt.Analytical(
        pt.one_compartment, lag=lambda p, t, cov: {0: p[2] * (1.0 + 0.01 * t)},
        out=_out1, nstates=1, ndrugs=1, nout=1), _tv_subjects(pt)),
    "lag_reads_a_time_varying_covariate": lambda: (pt.Analytical(
        pt.one_compartment, lag=lambda p, t, cov: {0: p[2] * cov("wt", t) / 60.0},
        out=_out1, nstates=1, ndrugs=1, nout=1), _tv_subjects(pt)),
    "time_dependent_fa": lambda: (pt.Analytical(
        pt.one_compartment, fa=lambda p, t, cov: {0: p[2] / (1.0 + 0.1 * t)},
        out=_out1, nstates=1, ndrugs=1, nout=1), _tv_subjects(pt)),
    "lag_with_seq_depth_gt1_levels": lambda: (pt.Analytical(
        pt.one_compartment, seq_eq=lambda p, t, cov: [p[0] * (1.0 + 0.15 * p[2]), p[1], p[2]],
        lag=lambda p, t, cov: {0: p[2]}, out=_out1, nstates=1, ndrugs=1, nout=1),
        _lag_depth_subjects(pt)),
    "lag_with_seq_depth_gt1_planes": lambda: (pt.Analytical(
        pt.one_compartment,
        seq_eq=lambda p, t, cov: [p[0] * (cov("wt", t) / 70.0) ** p[2], p[1], p[2]],
        lag=lambda p, t, cov: {0: 1.2 * p[2]}, out=_out1, nstates=1, ndrugs=1, nout=1),
        _lag_depth_subjects(pt)),
    "lag_with_time_varying_seq": lambda: (pt.Analytical(
        pt.one_compartment,
        seq_eq=lambda p, t, cov: [p[0] * (cov("wt", t) / 70.0) ** 0.75, p[1], p[2]],
        lag=lambda p, t, cov: {0: p[2]}, out=_out1, nstates=1, ndrugs=1, nout=1),
        _tv_subjects(pt)),
}


def _ems():
    return pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))


@pytest.mark.parametrize("name", list(K1C))
def test_k1c_configurations_raise_and_auto_takes_the_general_engine(name, monkeypatch):
    """Since kernel K1c these configurations no longer raise: the fused plan
    takes them (its twin here) and equals the general engine, and ``auto``
    on a card keeps the fused engine."""
    model, data = K1C[name]()
    sp = np.column_stack([np.linspace(0.1, 0.3, 5), np.linspace(8, 15, 5),
                          np.linspace(0.2, 0.9, 5)])
    fused = pt.log_likelihood_matrix(model, data, sp, _ems(), engine="fused")
    want = pt.log_likelihood_matrix(model, data, sp, _ems(), engine="general")
    torch.testing.assert_close(fused, want, rtol=1e-10, atol=1e-10)
    # auto as on a card: the plan accepts, the fused engine runs
    monkeypatch.setattr(matrix, "_auto_engine", lambda device: ("fused", "forced"))
    got = pt.log_likelihood_matrix(model, data, sp, _ems())
    assert pt.last_engine_decision(model)["engine"] == "fused"
    torch.testing.assert_close(got, fused, rtol=0, atol=0)


def test_lags_the_kernel_cannot_hold_raise():
    model = pt.Analytical(pt.one_compartment, lag=lambda p, t, cov: {0: p[2]},
                          out=_out1, nstates=1, ndrugs=1, nout=1)
    data = pt.Data([pt.Subject.builder("s0").bolus(0.0, 50.0, 0).bolus(1.0, 50.0, 0)
                    .observation(6.0, 1.0, 0).build()])
    # doses 1 h apart and a lag of 3 h: two doses pending at once
    with pytest.raises(PharmsolError, match="lag to elapse strictly"):
        pt.log_likelihood_matrix(model, data, np.array([[0.2, 10.0, 3.0]]), _ems(),
                                 engine="fused")
    with pytest.raises(PharmsolError, match="negative lag"):
        pt.log_likelihood_matrix(model, data, np.array([[0.2, 10.0, -0.5]]), _ems(),
                                 engine="fused")
    # a covariate read in out(): refused, as in the JAX plan
    reads = pt.Analytical(pt.one_compartment, nstates=1, ndrugs=1, nout=1,
                          out=lambda x, p, t, cov: x[0:1] / (p[1] * cov("wt", t) / 70.0))
    with pytest.raises(PharmsolError, match="out\\(\\) reads a covariate"):
        pt.log_likelihood_matrix(reads, _tv_subjects(pt), np.array([[0.2, 10.0]]), _ems(),
                                 engine="fused")


@pytest.mark.parametrize("name", FEATURE_BUDGETS)
def test_twin_float32_within_the_feature_budget(name):
    model, data, sp, ems = feature_budget_case(name)
    golden = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    pt.set_float_dtype(torch.float32)
    try:
        got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    finally:
        pt.set_float_dtype(torch.float64)
    assert got.dtype == torch.float32
    assert f32_error(got.numpy(), golden.numpy()) <= F32_BUDGET[name]


@functools.lru_cache(maxsize=None)
def _row_case():
    model, data, sp, ems, _ = feature_case("row", n_subjects=3, n_support=4)
    return _plan(model, data, sp, ems)


def test_wrapper_checks_the_feature_inputs():
    plan = _row_case()
    kw = plan.kernel_kwargs()
    R, M = plan.streams[0].shape
    ok = psi_analytical(*plan.streams, plan.support, **kw)
    assert ok.shape == (R, 4)
    bad = dict(kw, param_levels=torch.ones((1, 2, 4), dtype=torch.float64),
               seg_depth=torch.ones((R, M), dtype=torch.float64))
    with pytest.raises(ValueError, match="mutually exclusive"):
        psi_analytical_plain(*plan.streams, plan.support, **bad)
    with pytest.raises(ValueError, match="param_mult must be"):
        psi_analytical(*plan.streams, plan.support,
                       **dict(kw, param_mult=kw["param_mult"][:, :1].contiguous()))
    with pytest.raises(ValueError, match="require seg_depth"):
        psi_analytical(*plan.streams, plan.support,
                       **dict(kw, seg_depth=torch.ones((R, M), dtype=torch.float64)))
    with pytest.raises(ValueError, match="init_mask"):
        psi_analytical(*plan.streams, plan.support,
                       **dict(kw, init_rows=torch.ones((2, 4), dtype=torch.float64)))
    with pytest.raises(ValueError, match="expected torch.float64"):
        psi_analytical(*plan.streams, plan.support,
                       **dict(kw, lag_plane=torch.ones((R, 4), dtype=torch.float32)))
