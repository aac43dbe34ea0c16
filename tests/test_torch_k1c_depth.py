"""Kernel K1c's twin: lag with a seq chain deeper than one, and lag and fa
that change with time.

- ``lag_depth``: an infusion's end compounds the seq chain past depth 1 while
  a support-dependent lag moves each dose's reset to its own fire time; the
  event-code stream drives the kernel's depth counter and the segment of a
  fire runs a split march (JAX ``test_pallas_psi.py:1341-1415``);
- lag and fa evaluated per dose segment, selected by slot tables
  (``:1441-1540``), their refusals, and the lag x time-varying seq x
  infusion x censoring x two outputs stress case of
  ``test_pallas_seq_colplanes.py``.

On the CPU ``engine='fused'`` runs the plain twin, held, float64, against the
JAX kernel in interpret mode within 1e-9 relative and against the port's
general engine within 1e-10.
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
from pharmsol_tpu_torch.ops.fused_psi import psi_analytical_plain


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


def _check(make, data, sp):
    """The JAX kernel (interpret mode) against the port's twin, and the twin
    against the port's general engine; returns the port's plan."""
    want = np.asarray(jax_psi(make(jnp, pst), data, sp, _ems(), engine="pallas"))
    model = make(torch, pt)
    pdata, pems = convert.data_from_reference(data), _ems(pt)
    got = pt.log_likelihood_matrix(model, pdata, sp, pems, engine="fused").numpy()
    general = pt.log_likelihood_matrix(model, pdata, sp, pems, engine="general").numpy()
    assert np.isfinite(want).all()
    assert _rel(got, want) <= 1e-9
    assert _rel(got, general) <= 1e-10
    grid = model.lower(pdata.subjects())
    return _FusedPsiPlan(model, grid, sp, pems.lower(model.resolve_output_label, 1),
                         torch.device("cpu"), torch.float64)


def _lag_depth_subjects(n=8, lag_crosses_infusion=True):
    out = []
    for i in range(n):
        sb = (pst.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).infusion(1.0, 50.0, 0, 1.5)
              .covariate("wt", 0.0, 55.0 + 4.0 * i))
        if lag_crosses_infusion and i % 2 == 0:
            # a second bolus whose lag can fire in the compounded region
            sb = sb.bolus(2.0, 60.0, 0)
        for t in (0.5, 1.2, 2.1, 3.0, 4.5, 6.0, 10.0):
            sb = sb.observation(t, float(5 * np.exp(-0.2 * t) + 0.05 * i), 0)
        out.append(sb.build())
    return pst.Data(out)


def _one_cmt(seq_eq, lag):
    def make(xp, lib):
        return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                              seq_eq=lambda p, t, cov: xp.stack(seq_eq(p, t, cov)),
                              lag=lag, nstates=1, ndrugs=1, nout=1)
    return make


def test_lag_with_seq_depth_gt1_levels():
    rng = np.random.RandomState(31)
    sp = np.column_stack([rng.uniform(0.1, 0.3, 12), rng.uniform(8, 15, 12),
                          rng.uniform(0.0, 1.8, 12)])
    plan = _check(_one_cmt(lambda p, t, cov: [p[0] * (1.0 + 0.15 * p[2]), p[1], p[2]],
                           lambda p, t, cov: {0: p[2]}), _lag_depth_subjects(), sp)
    assert plan.mode == "levels" and plan.features["seg_evcode"] is not None
    assert plan.features["param_levels"].shape[0] > 1


def test_twin_tallies_each_fire_by_the_infusion_of_its_segment():
    """The twin's ``counts`` (the work a bound is priced on): every lagged
    dose that fires, those of them that land inside the 1-2.5 h infusion,
    the level models prepared once per level and support (the kernel's
    table in levels mode) and at least one level each cell's model takes."""
    rng = np.random.RandomState(31)
    sp = np.column_stack([rng.uniform(0.1, 0.3, 12), rng.uniform(8, 15, 12),
                          rng.uniform(0.0, 1.8, 12)])
    model = _one_cmt(lambda p, t, cov: [p[0] * (1.0 + 0.15 * p[2]), p[1], p[2]],
                     lambda p, t, cov: {0: p[2]})(torch, pt)
    data = convert.data_from_reference(_lag_depth_subjects())
    grid = model.lower(data.subjects())
    plan = _FusedPsiPlan(model, grid, sp, _ems(pt).lower(model.resolve_output_label, 1),
                         torch.device("cpu"), torch.float64)
    counts = {}
    psi_analytical_plain(*plan.streams, plan.support, counts=counts, **plan.kernel_kwargs())
    lag = sp[:, 2]
    second = np.arange(8) % 2 == 0  # the rows with a second bolus at 2 h
    in_infusion = (lag >= 1.0) & (lag < 2.5)
    assert counts["fires"] == 8 * 12 + int(second.sum()) * 12
    assert counts["fires_with_rate"] == (8 * int(in_infusion.sum())
                                         + int(second.sum()) * int((2.0 + lag < 2.5).sum()))
    assert 0 < counts["fires_with_rate"] < counts["fires"]
    assert counts["prepares"] == plan.features["param_levels"].shape[0] * 12
    assert counts["level_changes"] >= 8 * 12


def test_lag_with_seq_depth_gt1_planes():
    rng = np.random.RandomState(32)
    sp = np.column_stack([rng.uniform(0.1, 0.3, 12), rng.uniform(8, 15, 12),
                          rng.uniform(0.2, 1.2, 12)])
    plan = _check(_one_cmt(lambda p, t, cov: [p[0] * (cov("wt", t) / 70.0) ** p[2], p[1], p[2]],
                           lambda p, t, cov: {0: 1.2 * p[2]}), _lag_depth_subjects(), sp)
    assert plan.mode == "planes" and plan.features["seg_evcode"] is not None


def test_lag_fa_with_seq_depth_gt1():
    def make(xp, lib):
        return lib.Analytical(
            lib.two_compartments_with_absorption, out=lambda x, p, t, cov: x[1:2] / p[4],
            seq_eq=lambda p, t, cov: xp.stack([p[0], p[1] * (1.0 + 0.1 * p[5]), p[2], p[3],
                                               p[4], p[5]]),
            lag=lambda p, t, cov: {0: p[5]}, fa=lambda p, t, cov: {0: 1.0 / (1.0 + 0.3 * p[5])},
            nstates=3, ndrugs=1, nout=1)

    rng = np.random.RandomState(33)
    sp = np.column_stack([rng.uniform(0.8, 2.0, 12), rng.uniform(0.1, 0.3, 12),
                          rng.uniform(0.1, 0.3, 12), rng.uniform(0.05, 0.2, 12),
                          rng.uniform(8, 15, 12), rng.uniform(0.0, 1.5, 12)])
    _check(make, _lag_depth_subjects(lag_crosses_infusion=False), sp)


def test_lag_depth_zero_lag_lanes_match_plain():
    """Zero on some supports, positive on others: the zero-lag lanes fire at
    offset 0 of their bolus column, the others later, in one call."""
    rng = np.random.RandomState(34)
    lag_col = np.concatenate([np.zeros(4), rng.uniform(0.6, 1.9, 8)])
    sp = np.column_stack([rng.uniform(0.1, 0.3, 12), rng.uniform(8, 15, 12), lag_col])
    _check(_one_cmt(lambda p, t, cov: [p[0] * (1.0 + 0.2 * p[2]), p[1], p[2]],
                    lambda p, t, cov: {0: 0.5 * (p[2] - 0.5 + abs(p[2] - 0.5))}),
           _lag_depth_subjects(), sp)


def _two_dose_subjects(n, meal=False):
    subs = []
    for i in range(n):
        sb = pst.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).bolus(12.0, 80.0, 0)
        if meal:
            sb = sb.covariate("meal!", 0.0, 1.0).covariate("meal!", 6.0, 0.4 + 0.05 * i)
        for t in (0.5, 1.5, 3.0, 6.0, 10.0, 13.0, 16.0):
            sb = sb.observation(t, float(4 * np.exp(-0.2 * t) + 0.05 * i), 0)
        subs.append(sb.build())
    return pst.Data(subs)


def _oral(lag, fa):
    def make(xp, lib):
        return lib.Analytical(lib.one_compartment_with_absorption,
                              out=lambda x, p, t, cov: x[1:2] / p[2], lag=lag, fa=fa,
                              nstates=2, ndrugs=1, nout=1)
    return make


def test_time_dependent_lag_fa():
    """Lag at each dose's own time, fa at the shifted one: per-dose-segment
    planes selected by the slot tables."""
    rng = np.random.RandomState(33)
    sp = np.column_stack([rng.uniform(0.8, 2.0, 12), rng.uniform(0.1, 0.3, 12),
                          rng.uniform(8, 15, 12), rng.uniform(0.0, 1.0, 12),
                          rng.uniform(0.4, 0.9, 12)])
    plan = _check(_oral(lambda p, t, cov: {0: p[3] * (1.0 + 0.04 * t)},
                        lambda p, t, cov: {0: p[4] / (1.0 + 0.02 * t)}),
                  _two_dose_subjects(8), sp)
    assert sum(v >= 0 for v in plan.lag_slots) == 2 and plan.fa_slots is not None


def test_lag_reading_varying_covariate():
    rng = np.random.RandomState(35)
    sp = np.column_stack([rng.uniform(0.8, 2.0, 12), rng.uniform(0.1, 0.3, 12),
                          rng.uniform(8, 15, 12), rng.uniform(0.0, 1.2, 12),
                          rng.uniform(0.5, 1.0, 12)])
    _check(_oral(lambda p, t, cov: {0: p[3] * cov("meal", t)},
                 lambda p, t, cov: {0: p[4] * (2.0 - cov("meal", t)) / 2.0}),
           _two_dose_subjects(8, meal=True), sp)


def test_dynamic_fa_only():
    def make(xp, lib):
        return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                              fa=lambda p, t, cov: {0: p[2] / (1.0 + 0.1 * t)},
                              nstates=1, ndrugs=1, nout=1)

    subs = []
    for i in range(6):
        sb = pst.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).bolus(8.0, 60.0, 0)
        for t in (1.0, 3.0, 6.0, 9.0, 14.0):
            sb = sb.observation(t, float(4 * np.exp(-0.2 * t) + 0.05 * i), 0)
        subs.append(sb.build())
    rng = np.random.RandomState(37)
    sp = np.column_stack([rng.uniform(0.1, 0.3, 12), rng.uniform(8, 15, 12),
                          rng.uniform(0.4, 1.0, 12)])
    plan = _check(make, pst.Data(subs), sp)
    assert plan.lag_slots is None and plan.fa_slots is not None


@pytest.mark.parametrize("lag", ["dynamic", "static"])
def test_lag_overlap_rejected(lag):
    """A lag that reaches the next dose would need two pending slots."""
    fn = {"dynamic": lambda p, t, cov: {0: p[2] * (1.0 + t)},
          "static": lambda p, t, cov: {0: p[2]}}[lag]
    model = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1], lag=fn,
                          nstates=1, ndrugs=1, nout=1)
    s = (pt.Subject.builder("s0").bolus(0.0, 50.0, 0).bolus(1.0, 50.0, 0)
         .observation(6.0, 1.0, 0).build())
    sp = np.array([[0.2, 10.0, 3.0], [0.3, 12.0, 0.2]])
    with pytest.raises(PharmsolError, match="lag"):
        pt.log_likelihood_matrix(model, pt.Data([s]), sp, _ems(pt), engine="fused")
def test_stress_lag_tvseq_infusion_censoring_multioutput():
    """Lag x time-varying seq x infusion x BLOQ/ALOQ x two outputs. The JAX
    kernel's log-CDF is approximate (~6e-5), the twin's exact: against the
    JAX kernel 1e-6 as in the JAX test, against the general engine 1e-10."""
    def make(xp, lib):
        return lib.Analytical(
            lib.one_compartment_with_absorption,
            out=lambda x, p, t, cov: xp.stack([x[1] / p[2], 2.5 * x[1] / p[2] + 0.1]),
            seq_eq=lambda p, t, cov: xp.stack([p[0] * xp.exp(-0.01 * t),
                                               p[1] * (cov("wt", t) / 70.0) ** 0.75, p[2], p[3]]),
            lag=lambda p, t, cov: {0: p[3]}, nstates=2, ndrugs=1, nout=2)

    ems = (pst.AssayErrorModels()
           .add(0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1), 1.0))
           .add(1, pst.AssayErrorModel.proportional(pst.ErrorPoly(0.3, 0.15), 1.5)))
    subs = []
    for i in range(6):
        sb = (pst.Subject.builder(f"x{i}").bolus(0.0, 100.0, 0).bolus(8.0, 60.0, 0)
              .infusion(3.0, 50.0, 0, 1.5).covariate("wt", 0.0, 52.0 + 5.0 * i)
              .covariate("wt", 5.0, 70.0 - 3.0 * i).covariate("wt", 10.0, 60.0 + 2.0 * i))
        for t in (0.5, 1.5, 3.5, 5.0, 7.5, 10.0):
            sb = sb.observation(t, float(4 * np.exp(-0.2 * t) + 0.1 * i), 0)
            sb = sb.observation(t + 0.25, float(9 * np.exp(-0.2 * t) + 0.2 * i), 1)
        sb = (sb.censored_observation(14.0, 0.1, 0, pst.Censor.BLOQ)
              .censored_observation(0.25, 8.0, 1, pst.Censor.ALOQ))
        subs.append(sb.build())
    rng = np.random.RandomState(18)
    sp = np.column_stack([rng.uniform(0.8, 2.0, 12), rng.uniform(0.1, 0.3, 12),
                          rng.uniform(8, 15, 12), rng.uniform(0.2, 1.4, 12)])
    data = pst.Data(subs)
    want = np.asarray(jax_psi(make(jnp, pst), data, sp, ems, engine="pallas"))
    model = make(torch, pt)
    pdata, pems = convert.data_from_reference(data), convert.error_models_from_reference(ems)
    got = pt.log_likelihood_matrix(model, pdata, sp, pems, engine="fused").numpy()
    general = pt.log_likelihood_matrix(model, pdata, sp, pems, engine="general").numpy()
    assert _rel(got, want) < 1e-6 and _rel(got, general) <= 1e-10
