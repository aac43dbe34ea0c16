"""Covariates, seq, lag, fa and init in the port's general engine.

The same subjects and models, made from a numpy seed, go through the JAX
package's general engine (``engine='xla'``) and the port's
(``engine='general'``), float64 on the CPU, within 1e-10 relative:
time-constant and time-varying covariates read by seq, seq without
covariates with the infusion-end compounding, lag and fa (overlapping
lags, lag and fa that change with time or read a time-varying covariate,
which the fused plan leaves to this engine), init per support and read from
a covariate, a 3-compartment model with seq. The port's covariate helpers
(``CovView``, ``plans/decompose.py``) are held against the JAX package's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.engine.grid import CovView as JaxCovView
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi
from pharmsol_tpu.likelihood.plans import decompose as jax_decompose

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.engine.grid import CovView
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood.plans import decompose
from pharmsol_tpu_torch.utils.f32_budget import feature_case


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _ems(lib):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def _compare(build):
    """``build(lib)`` -> (model, data, support) in package ``lib``: the
    port's general engine against the JAX package's xla engine."""
    mj, dj, sp = build(pst)
    mt, dt, _ = build(pt)
    want = np.asarray(jax_psi(mj, dj, sp, _ems(pst), engine="xla"))
    got = pt.log_likelihood_matrix(mt, dt, sp, _ems(pt), engine="general").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    return got


# every mode of the fused plan's catalog, through the general engine
CATALOG = ("row", "segment_tv", "levels", "levels_3cmt", "planes", "lag_fa",
           "lag_seq_depth1", "row_lag_fa", "init_rows", "init_planes")


@pytest.mark.parametrize("name", CATALOG)
def test_general_engine_matches_jax_on_the_catalog(name):
    def build(lib):
        model, data, sp, _, _ = feature_case(name, n_subjects=6, n_support=9,
                                             seed=7, lib=lib)
        return model, data, sp

    _compare(build)


def _stack(lib):
    return jnp.stack if lib is pst else torch.stack


def test_time_varying_covariates_two_of_them():
    # JAX tests/test_pallas_psi.py:919: wt with a second knot, crcl constant,
    # an infusion and a BLOQ observation, 2-cmt oral
    def build(lib):
        rng = np.random.RandomState(4)
        subs = []
        for i in range(6):
            b = (lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
                 .infusion(2.0, 50.0, 0, 1.5)
                 .covariate("wt", 0.0, 80.0 - 2 * i)
                 .covariate("wt", 12.0, 60.0 + i)
                 .covariate("crcl", 0.0, 90.0 + 3 * i))
            for t in (0.5, 1.0, 3.0, 6.0, 12.0):
                b = b.observation(float(t), float(abs(5 + rng.randn())), 0)
            b = b.censored_observation(24.0, 0.5, 0, lib.Censor.BLOQ)
            subs.append(b.build())

        def seq(p, t, cov):
            sc = (cov("wt", t) / 70.0) ** 0.75
            rc = cov("crcl", t) / 100.0
            return _stack(lib)([p[0] * sc * rc, p[1], p[2] * sc, p[3] * sc, p[4]])

        model = lib.Analytical(lib.two_compartments_with_absorption, seq_eq=seq,
                               out=lambda x, p, t, cov: x[1:2] / p[4],
                               nstates=3, ndrugs=1, nout=1)
        sp = np.abs(np.array([0.15, 1.2, 0.3, 0.2, 10.0])[None, :]
                    * (1.0 + 0.2 * rng.randn(8, 5)))
        return model, lib.Data(subs), sp

    _compare(build)


def test_seq_compounds_across_infusion_ends():
    # JAX tests/test_pallas_psi.py:884: infusions only, the seq chain
    # compounds across the infusion-end sub-splits
    def build(lib):
        rng = np.random.RandomState(3)
        subs = []
        for i in range(4):
            b = (lib.Subject.builder(f"s{i}").infusion(0.0, 100.0, 0, 2.0)
                 .covariate("wt", 0.0, 60.0 + 5 * i))
            for t in (1.0, 3.0, 8.0):
                b = b.observation(float(t), float(abs(4 + rng.randn())), 0)
            subs.append(b.build())
        model = lib.Analytical(
            lib.one_compartment,
            seq_eq=lambda p, t, cov: [p[0] * (cov("wt", t) / 70.0) ** 0.75, p[1]],
            out=lambda x, p, t, cov: x[:1] / p[1], nstates=1, ndrugs=1, nout=1)
        return model, lib.Data(subs), np.array([[0.15, 10.0], [0.2, 12.0]])

    _compare(build)


def test_seq_without_covariates_compounds_too():
    # a parameter-only seq, applied once more on every infusion-end sub-split
    def build(lib):
        subs = []
        for i in range(4):
            b = lib.Subject.builder(f"s{i}").bolus(0.0, 80.0, 0).infusion(1.0, 60.0, 0, 3.0)
            for t in (0.5, 2.0, 3.5, 5.0, 9.0):
                b = b.observation(t, 3.0 + 0.2 * i, 0)
            subs.append(b.build())
        model = lib.Analytical(
            lib.one_compartment_with_absorption,
            seq_eq=lambda p, t, cov: [p[0], p[1] * 1.1, p[2]],
            out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
        return model, lib.Data(subs), np.array([[1.2, 0.15, 10.0], [0.9, 0.2, 14.0]])

    _compare(build)


def _two_dose_subjects(lib, n=4, gap=1.0, meal=False):
    subs = []
    for i in range(n):
        b = lib.Subject.builder(f"s{i}").bolus(0.0, 50.0, 0).bolus(gap, 50.0, 0)
        if meal:
            b = b.covariate("meal!", 0.0, 1.0).covariate("meal!", 6.0, 0.4 + 0.05 * i)
        for t in (0.5, 1.5, 3.0, 6.0, 10.0, 16.0):
            b = b.observation(t, float(4 * np.exp(-0.2 * t) + 0.05 * i), 0)
        subs.append(b.build())
    return lib.Data(subs)


def test_overlapping_lag():
    # doses 1 h apart, lags up to 3 h: two doses pending at once, which the
    # fused plan refuses and the general engine sorts per support
    def build(lib):
        model = lib.Analytical(lib.one_compartment, lag=lambda p, t, cov: {0: p[2]},
                               out=lambda x, p, t, cov: x[0:1] / p[1],
                               nstates=1, ndrugs=1, nout=1)
        sp = np.array([[0.2, 10.0, 3.0], [0.3, 12.0, 0.2], [0.25, 9.0, 1.0]])
        return model, _two_dose_subjects(lib), sp

    _compare(build)


def test_time_dependent_lag_and_fa():
    # lag evaluated at each dose's own time, fa at the shifted time
    def build(lib):
        model = lib.Analytical(
            lib.one_compartment_with_absorption,
            lag=lambda p, t, cov: {0: p[3] * (1.0 + 0.04 * t)},
            fa=lambda p, t, cov: {0: p[4] / (1.0 + 0.02 * t)},
            out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
        rng = np.random.RandomState(33)
        sp = np.column_stack([rng.uniform(0.8, 2.0, 6), rng.uniform(0.1, 0.3, 6),
                              rng.uniform(8, 15, 6), rng.uniform(0.0, 1.0, 6),
                              rng.uniform(0.4, 0.9, 6)])
        return model, _two_dose_subjects(lib, gap=12.0), sp

    _compare(build)


def test_lag_reading_a_time_varying_covariate():
    def build(lib):
        model = lib.Analytical(
            lib.one_compartment_with_absorption,
            lag=lambda p, t, cov: {0: p[3] * cov("meal", t)},
            fa=lambda p, t, cov: {0: p[4] * (2.0 - cov("meal", t)) / 2.0},
            out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
        rng = np.random.RandomState(35)
        sp = np.column_stack([rng.uniform(0.8, 2.0, 6), rng.uniform(0.1, 0.3, 6),
                              rng.uniform(8, 15, 6), rng.uniform(0.0, 1.2, 6),
                              rng.uniform(0.5, 1.0, 6)])
        return model, _two_dose_subjects(lib, gap=12.0, meal=True), sp

    _compare(build)


def test_init_applies_on_occasion_zero_only():
    # JAX tests/test_pallas_psi.py:1615: a reset occasion starts at zero
    def build(lib):
        model = lib.Analytical(
            lib.one_compartment,
            init=lambda p, t, cov: [3.0 / p[1] + 0.0 * p[0]],
            out=lambda x, p, t, cov: x[0:1] / p[1], nstates=1, ndrugs=1, nout=1)
        subs = []
        for i in range(4):
            b = lib.Subject.builder(f"s{i}").bolus(0.0, 50.0, 0)
            for t in (1.0, 3.0):
                b = b.observation(t, 2.0 + 0.1 * i, 0)
            b = b.reset().bolus(0.0, 40.0, 0)
            for t in (1.0, 4.0):
                b = b.observation(t, 1.5, 0)
            subs.append(b.build())
        rng = np.random.RandomState(11)
        sp = np.abs(np.array([0.3, 20.0])[None, :] * (1.0 + 0.2 * rng.randn(8, 2)))
        return model, lib.Data(subs), sp

    _compare(build)


def test_init_composes_with_seq_and_lag():
    # init, a covariate seq, lag and fa in one model, two occasions
    def build(lib):
        model = lib.Analytical(
            lib.two_compartments_with_absorption,
            seq_eq=lambda p, t, cov: [p[0] * (cov("wt", t) / 70.0) ** 0.75, p[1],
                                      p[2], p[3], p[4], p[5], p[6]],
            lag=lambda p, t, cov: {0: p[5]}, fa=lambda p, t, cov: {0: p[6]},
            init=lambda p, t, cov: [0.0 * p[0], 1.0 + 0.01 * cov("wt", 0.0), 0.5 * p[2]],
            out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)
        rng = np.random.RandomState(0)
        subs = []
        for i in range(5):
            b = (lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).bolus(12.0, 80.0, 0)
                 .covariate("wt", 0.0, 55.0 + 5 * i).covariate("wt", 6.0, 70.0 - 2 * i))
            if i % 2 == 0:
                b = b.infusion(3.0, 50.0, 0, 1.5)
            for t in (0.3, 0.7, 1.5, 2.5, 5.0, 9.0, 12.5, 14.0, 20.0):
                b = b.observation(t, float(3 * np.exp(-0.2 * t) + 0.05 * i), 0)
            if i == 1:
                b = b.reset().bolus(0.0, 60.0, 0).observation(2.0, 2.0, 0)
            subs.append(b.build())
        sp = np.column_stack([rng.uniform(0.1, 0.3, 7), rng.uniform(0.8, 2, 7),
                              rng.uniform(0.2, 0.4, 7), rng.uniform(0.1, 0.3, 7),
                              rng.uniform(8, 15, 7), rng.uniform(0, 1.2, 7),
                              rng.uniform(0.5, 1, 7)])
        return model, lib.Data(subs), sp

    _compare(build)


# -- the covariate helpers against the JAX package's ---------------------------


@functools.lru_cache(maxsize=None)
def _grids():
    """One population with a linear, a fixed and a constant covariate, in
    both packages' lowering."""
    subs = []
    for i in range(4):
        b = (pst.Subject.builder(f"c{i}").bolus(0.0, 10.0, 0)
             .covariate("wt", 1.0, 60.0 + i).covariate("wt", 5.0, 70.0 - 3 * i)
             .covariate("wt", 9.0, 65.0)
             .covariate("meal!", 0.0, 1.0).covariate("meal!", 4.0, 0.5 + 0.1 * i)
             .covariate("age", 0.0, 30.0 + 10 * i))
        for t in (1.0, 4.0, 9.0):
            b = b.observation(t, 1.0, 0)
        subs.append(b.build())
    data = pst.Data(subs)
    mj = pst.Analytical(pst.one_compartment, nstates=1, ndrugs=1, nout=1)
    mt = pt.Analytical(pt.one_compartment, nstates=1, ndrugs=1, nout=1)
    return (mj.lower(data.subjects()),
            mt.lower(convert.data_from_reference(data).subjects()))


@pytest.mark.parametrize("name", ["wt", "meal", "age"])
def test_covview_matches_jax(name):
    gj, gt = _grids()
    ts = np.array([-1.0, 0.0, 1.0, 2.5, 4.0, 5.0, 7.0, 9.0, 12.0])
    for r in range(gt.n_rows):
        cj = JaxCovView(jnp.asarray(gj.rows.cov_t[r]), jnp.asarray(gj.rows.cov_v[r]),
                        jnp.asarray(gj.rows.cov_fixed[r]), gj.cov_names)
        ct = CovView(torch.as_tensor(gt.rows.cov_t[r]), torch.as_tensor(gt.rows.cov_v[r]),
                     torch.as_tensor(gt.rows.cov_fixed[r]), gt.cov_names)
        want = [float(cj(name, t)) for t in ts]
        got = [float(ct(name, torch.tensor(t, dtype=torch.float64))) for t in ts]
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    with pytest.raises(Exception, match="unknown covariate"):
        ct("height", 0.0)


def test_covariate_value_helpers_match_jax():
    gj, gt = _grids()
    for tq in (0.0, 3.0, 20.0):
        want = jax_decompose._covariate_values_at(gj, tq)
        got = decompose._covariate_values_at(gt, tq)
        for n in gt.cov_names:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-15)
    te = np.array([0.5, 4.5, 8.0, 30.0])
    want = jax_decompose._host_cov_values(gj, te)
    got = decompose._host_cov_values(gt, te)
    for n in gt.cov_names:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-15)
    assert decompose._classify_covariates(gt)[1] == jax_decompose._classify_covariates(gj)[1]


def test_affine_covariate_streams_match_jax():
    from pharmsol_tpu.ops.pallas_psi import segment_schedule as jax_schedule

    from pharmsol_tpu_torch.ops.fused_psi import segment_schedule

    gj, gt = _grids()
    _, t0j, dtj, _ = jax_schedule(gj.rows)
    _, t0t, dtt, _ = segment_schedule(gt.rows)
    np.testing.assert_array_equal(t0t, t0j)
    names = ["meal", "age"]
    want = jax_decompose._affine_covariate_streams(gj, names, t0j, dtj)
    got = decompose._affine_covariate_streams(gt, names, t0t, dtt)
    for n in names:
        for a, b in zip(got[n], want[n]):
            np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-14)
    # wt's knot at 5 h lies inside a segment: refused, as in the JAX package
    with pytest.raises(PharmsolError, match="strictly inside"):
        decompose._affine_covariate_streams(gt, ["wt"], t0t, dtt)


@pytest.mark.parametrize("kind", ["ode", "sde"])
def test_ode_and_sde_refuse_covariates(kind):
    """ODE models and, since kernel K3b, SDE models take covariates and lag
    in every engine (ODE: fused and general agree at the controller's
    error; SDE at zero diffusion to rounding)."""
    data = pt.Data([pt.Subject.builder("a").bolus(0.0, 100.0, 0)
                    .covariate("wt", 0.0, 70.0).observation(1.0, 5.0, 0).build()])
    sp = np.array([[0.2, 10.0]])
    if kind == "ode":
        model = pt.ODE(lambda x, p, t, b, r, cov: torch.stack(
                           [-p[0] * cov("wt", t) / 70.0 * x[0] + b[0]]),
                       out=lambda x, p, t, cov: x[0:1] / p[1], nstates=1, ndrugs=1, nout=1)
        psi = {engine: pt.log_likelihood_matrix(model, data, sp, _ems(pt), engine=engine)
               for engine in ("general", "fused", "auto")}
        assert all(bool(torch.isfinite(v).all()) for v in psi.values())
        torch.testing.assert_close(psi["fused"], psi["general"], rtol=1e-4, atol=1e-4)
        lagged = pt.ODE(lambda x, p, t, b, r, cov: x, lag=lambda p, t, cov: {0: 1.0},
                        nstates=1, ndrugs=1, nout=1)
        assert lagged.spec.lag is not None
        return
    model = pt.SDE(lambda x, p, t, r, cov: torch.stack([-p[0] * cov("wt", t) / 70.0 * x[0]]),
                   lambda p, t, cov: [0.0], out=lambda x, p, t, cov: x[0:1] / p[1],
                   nparticles=8, nstates=1, ndrugs=1, nout=1)
    psi = {engine: pt.log_likelihood_matrix(model, data, sp, _ems(pt), engine=engine)
           for engine in ("general", "fused", "auto")}
    assert all(bool(torch.isfinite(v).all()) for v in psi.values())
    torch.testing.assert_close(psi["fused"], psi["general"], rtol=1e-9, atol=1e-9)
    lagged = pt.SDE(lambda x, p, t, r, cov: x, lambda p, t, cov: [0.0],
                    lag=lambda p, t, cov: {0: 1.0}, nstates=1, ndrugs=1, nout=1)
    assert lagged.spec.lag is not None
