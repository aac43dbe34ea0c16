"""K1b's and K1c's inputs since their redesign: the observation terms that
depend on the row alone, hoisted out of the cell, and a covariate-free lag
or fa passed as one row per support instead of an [R, S] plane.

CPU, float64, inputs made with numpy from a seed:

- the twin with the hoisted terms (``observation_terms``: each row's
  constant sum and 1 / sigma) against the JAX package's Pallas kernel in
  interpret mode over the 12 structures, with two outputs (one with a bias)
  and censored observations, 1e-9 relative;
- the twin fed a [1, S] lag and fa row against the same values broadcast to
  [R, S] planes, 1e-15;
- the closed-form plan keeps a row for a covariate-free closure and builds a
  plane for one that reads a time-constant covariate (the Covariate Short
  and lag-depth Short models at a small size);
- ``log_likelihood_matrix`` on those two models, fused and general engines,
  against the JAX package's, 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi
from pharmsol_tpu.utils.f32_budget import _NOMINAL

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.likelihood.plans.analytical import _FusedPsiPlan
from pharmsol_tpu_torch.ops.fused_psi import (
    STRUCTURES, observation_terms, psi_analytical_plain,
)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def _plan(model, data, sp, ems):
    return _FusedPsiPlan(model, model.lower(data.subjects()), sp,
                         ems.lower(model.resolve_output_label, model.nouteqs()),
                         torch.device("cpu"), torch.float64)


def _censored_two_output_data(rng, n):
    """Two boluses and an infusion into input 0, five observations of output
    0, two of output 1, and a BLOQ and an ALOQ observation whose limits lie
    far from any prediction (output 1 carries a bias of 5): their log-CDF
    terms are 0 to 1e-20 in the exact form and in the JAX kernel's
    approximation alike, while the censored observations still leave the
    rows' constant sums."""
    subjects = []
    for i in range(n):
        b = (pst.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).bolus(12.0, 60.0, 0)
             .infusion(3.0, 150.0, 0, 1.5))
        for t in (0.5, 2.0, 4.0, 8.0, 13.0):
            b = b.observation(t, float(abs(3.0 + rng.randn())), 0)
        b = b.observation(1.5, 2.0 + 0.1 * i, 1).observation(9.0, 1.0 + 0.05 * i, 1)
        b = b.censored_observation(6.0, 1000.0, 0, pst.Censor.BLOQ)
        b = b.censored_observation(10.0, 1e-6, 1, pst.Censor.ALOQ)
        subjects.append(b.build())
    return pst.Data(subjects)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_hoisted_terms_match_the_jax_kernel(name):
    """The twin, which sums the hoisted ``observation_terms`` (each row's
    constant sum, 1 / sigma), against the JAX kernel in interpret mode: two
    outputs, the second with a bias, and censored observations, 1e-9."""
    from pharmsol_tpu.engine.analytical import KERNELS

    rng = np.random.RandomState(7 + len(name))
    data = _censored_two_output_data(rng, 4)
    _, nstates, npar = KERNELS[name]
    c = 1 if name.endswith("_with_absorption") else 0
    sp = np.abs(np.array(_NOMINAL[name] + [11.0])[None, :]
                * (1.0 + 0.15 * rng.randn(24, npar + 1)))
    ems = (pst.AssayErrorModels()
           .add(0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1), 1.0))
           .add(1, pst.AssayErrorModel.proportional(pst.ErrorPoly(0.1, 0.2), 2.0)))

    def model(lib, stack):
        return lib.Analytical(
            getattr(lib, name), nstates=nstates, ndrugs=1, nout=2,
            out=lambda x, p, t, cov: stack([x[c] / p[npar], 0.5 * x[c] / p[npar] + 5.0]))

    want = np.asarray(jax_psi(model(pst, jnp.stack), data, sp, ems, engine="pallas"))
    plan = _plan(model(pt, torch.stack), convert.data_from_reference(data), sp,
                 convert.error_models_from_reference(ems))
    assert plan.outeq is not None and plan.out_bias is not None
    cens = plan.streams[6]
    assert cens is not None and bool((cens != 0).any())
    rows = psi_analytical_plain(*plan.streams, plan.support, **plan.kernel_kwargs())
    assert _rel(plan.finalize(rows).numpy(), want) <= 1e-9


def test_observation_terms_leave_censored_and_masked_slots_out():
    """``obs_const`` sums ``-log(2 pi) / 2 - log sigma`` over a row's
    uncensored observations only; ``obs_isig`` is 1 / sigma there and 1 on
    slots without an observation."""
    mask = torch.tensor([[1.0, 1.0, 0.0, 1.0]], dtype=torch.float64)
    sigma = torch.tensor([[0.5, 2.0, 7.0, 4.0]], dtype=torch.float64)
    cens = torch.tensor([[0.0, 1.0, 0.0, 0.0]], dtype=torch.float64)
    isig, const = observation_terms(mask, sigma, cens)
    c = -0.5 * np.log(2 * np.pi)
    np.testing.assert_allclose(const.numpy(), [2 * c - np.log(0.5) - np.log(4.0)], rtol=1e-15)
    np.testing.assert_allclose(isig.numpy(), [[2.0, 0.5, 1.0, 0.25]], rtol=1e-15)


def test_lag_and_fa_rows_equal_their_broadcast_planes():
    """The twin fed a [1, S] lag and fa row and the same values broadcast to
    [R, S] planes: equal to 1e-15."""
    from pharmsol_tpu_torch.utils.f32_budget import feature_case

    model, data, sp, ems, _ = feature_case("row_lag_fa", n_subjects=5, n_support=9, seed=3)
    plan = _plan(model, data, sp, ems)
    kw = plan.kernel_kwargs()
    R = plan.streams[0].shape[0]
    assert tuple(kw["lag_plane"].shape) == (1, 9) and tuple(kw["fa_plane"].shape) == (1, 9)
    rows = psi_analytical_plain(*plan.streams, plan.support, **kw)
    planes = psi_analytical_plain(*plan.streams, plan.support, **dict(
        kw, lag_plane=kw["lag_plane"].expand(R, 9).contiguous(),
        fa_plane=kw["fa_plane"].expand(R, 9).contiguous()))
    assert _rel(rows.numpy(), planes.numpy()) <= 1e-15


def _cov_short(lib, n, lag=None):
    """The Covariate Short cell at ``n`` subjects: the Short regimen, each
    subject's weight constant, allometric rate constants, lag p[5] and fa
    p[6] (``lag`` replaces the lag closure)."""
    rng = np.random.RandomState(11)
    wt = rng.uniform(40.0, 120.0, n)
    subjects = []
    for i in range(n):
        b = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).covariate("wt", 0.0, float(wt[i]))
        for t, v in zip((0.5, 1.0, 2.0, 4.0, 8.0, 12.0), np.abs(5.0 + rng.randn(6))):
            b = b.observation(t, float(v), 0)
        subjects.append(b.build())

    def allometric(p, t, cov):
        sc = (cov("wt", t) / 70.0) ** 0.75
        return [p[0] * sc, p[1], p[2] * sc, p[3] * sc, p[4], p[5], p[6]]

    model = lib.Analytical(
        lib.two_compartments_with_absorption, seq_eq=allometric,
        lag=lag or (lambda p, t, cov: {0: p[5]}), fa=lambda p, t, cov: {0: p[6]},
        out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)
    sp = np.abs(np.array([0.15, 3.0, 0.3, 0.2, 10.0, 0.5, 0.8])[None, :]
                * (1.0 + 0.2 * rng.randn(6, 7)))
    return model, lib.Data(subjects), sp


def _lag_depth_short(lib, n):
    """The lag-depth Short cell at ``n`` subjects: the 2-cmt oral model whose
    seq compounds across the end of the 1.5 h infusion, with a lag and an fa
    that read no covariate."""
    rng = np.random.RandomState(12)
    subjects = []
    for i in range(n):
        b = (lib.Subject.builder(f"d{i}").bolus(0.0, 100.0, 0).infusion(1.0, 50.0, 0, 1.5)
             .covariate("wt", 0.0, 55.0 + 4.0 * (i % 8)))
        for t in (0.5, 1.2, 2.1, 3.0, 4.5, 6.0, 10.0):
            b = b.observation(t, float(5.0 * np.exp(-0.2 * t) * np.exp(0.1 * rng.randn())), 0)
        subjects.append(b.build())
    model = lib.Analytical(
        lib.two_compartments_with_absorption, out=lambda x, p, t, cov: x[1:2] / p[4],
        seq_eq=lambda p, t, cov: [p[0], p[1] * (1.0 + 0.1 * p[5]), p[2], p[3], p[4], p[5]],
        lag=lambda p, t, cov: {0: p[5]}, fa=lambda p, t, cov: {0: 1.0 / (1.0 + 0.3 * p[5])},
        nstates=3, ndrugs=1, nout=1)
    sp = np.abs(np.array([1.4, 0.2, 0.2, 0.12, 11.5, 0.75])[None, :]
                * (1.0 + 0.2 * rng.randn(5, 6)))
    return model, lib.Data(subjects), sp


def _ems(lib):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


@pytest.mark.parametrize("cell", ["cov_short", "lag_depth"])
def test_plan_keeps_a_covariate_free_lag_and_fa_as_rows(cell):
    """A covariate-free lag and fa: one row per support [1, S], the
    values of the support's columns; no [R, S] plane is built."""
    model, data, sp = (_cov_short(pt, 5) if cell == "cov_short" else _lag_depth_short(pt, 5))
    plan = _plan(model, data, sp, _ems(pt))
    f = plan.features
    S = sp.shape[0]
    assert plan.mode == ("row" if cell == "cov_short" else "levels")
    assert tuple(f["lag_plane"].shape) == (1, S) and tuple(f["fa_plane"].shape) == (1, S)
    np.testing.assert_array_equal(f["lag_plane"].numpy()[0], sp[:, 5])
    want_fa = sp[:, 6] if cell == "cov_short" else 1.0 / (1.0 + 0.3 * sp[:, 5])
    np.testing.assert_allclose(f["fa_plane"].numpy()[0], want_fa, rtol=1e-15)


def test_plan_builds_a_plane_for_a_lag_that_reads_a_covariate():
    """A lag that reads the (time-constant) weight: an [R, S] plane, one
    value per (row, support); the fa beside it stays a row."""
    model, data, sp = _cov_short(pt, 5, lag=lambda p, t, cov: {0: p[5] * cov("wt", t) / 70.0})
    plan = _plan(model, data, sp, _ems(pt))
    f = plan.features
    assert tuple(f["lag_plane"].shape) == (5, sp.shape[0])
    assert tuple(f["fa_plane"].shape) == (1, sp.shape[0])
    wt = np.asarray(model.lower(data.subjects()).rows.cov_v)[:, 0, 0]
    np.testing.assert_allclose(f["lag_plane"].numpy(), wt[:, None] / 70.0 * sp[None, :, 5],
                               rtol=1e-14)


@pytest.mark.parametrize("cell", ["cov_short", "lag_depth"])
def test_both_engines_match_the_jax_package(cell):
    """``log_likelihood_matrix`` through the fused engine (the twin over the
    rows) and the general engine, against the JAX package's general engine:
    1e-9."""
    build = _cov_short if cell == "cov_short" else _lag_depth_short
    mj, dj, spj = build(pst, 6)
    model, data, sp = build(pt, 6)
    want = np.asarray(jax_psi(mj, dj, spj, _ems(pst), engine="xla"))
    for engine in ("fused", "general"):
        got = pt.log_likelihood_matrix(model, data, sp, _ems(pt), engine=engine).numpy()
        assert _rel(got, want) <= 1e-9, engine
