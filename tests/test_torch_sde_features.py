"""SDE models with covariates, lag, fa and init in the port's general engine.

The general engine (``engine/sde.py``) gives each row's closures the row's
covariates (a CovView rebuilt inside the row vmap), sorts each support's own
lag-shifted segments and evaluates init with the covariates at t = 0, as the
JAX package's ``engine/sde.py:185-210``. At zero diffusion every particle
follows the deterministic Euler-Maruyama march, which both packages take step
for step, so psi agrees with JAX ``engine='xla'`` to rounding: within 1e-9
relative, float64 on the CPU (mirroring ``test_pallas_sde.py:145, :236, :266,
:294, :338``). With noise the draws differ (torch generators against JAX's
threefry) and the engines agree within filter noise (``:319``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.utils.f32_budget import SDE_FEATURE_CASES, sde_feature_case


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _ems():
    return pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.0, 0.0, 0.0), 0.5))


@pytest.mark.parametrize("name", SDE_FEATURE_CASES)
def test_general_engine_matches_jax_xla_at_zero_diffusion(name):
    jm, jd, jsp, je = sde_feature_case(name, 3, 4, lib=pst, stack=jnp.stack, nparticles=8,
                                       sigma=False)
    want = np.asarray(jax_psi(jm, jd, jsp, je, engine="xla"))
    model, data, sp, ems = sde_feature_case(name, 3, 4, nparticles=8, sigma=False)
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    assert np.isfinite(want).all() and _rel(got, want) <= 1e-9


def _decay(xp, cls, g=0.0, nparticles=8, seed=3, **kw):
    """test_pallas_sde.py's one-state decay model, closures per framework."""
    return cls(drift=lambda x, p, t, r, cov: xp.stack([-p[0] * x[0]]),
               diffusion=lambda p, t, cov: [g + 0.0 * p[0]],
               out=lambda x, p, t, cov: x[0:1] / p[1],
               nparticles=nparticles, nstates=1, ndrugs=1, nout=1, seed=seed, **kw)


def _both(make, data, sp):
    """psi of the JAX model (xla) and of the port's (general) on one data."""
    want = np.asarray(jax_psi(make(jnp, pst.SDE), data, sp, _ems(), engine="xla"))
    got = pt.log_likelihood_matrix(make(torch, pt.SDE), convert.data_from_reference(data), sp,
                                   convert.error_models_from_reference(_ems()),
                                   engine="general").numpy()
    return got, want


def test_lag_fa_match_jax_xla():
    """test_pallas_sde.py:266: static lag and fa, doses at 0 and 2 h."""
    subs = []
    for i in range(3):
        sb = pst.SubjectBuilder(f"t{i}").bolus(0.0, 100.0, 0).bolus(2.0, 50.0, 0)
        for t in (0.5, 1.2, 2.6):
            sb = sb.observation(t, float(6 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subs.append(sb.build())
    rng = np.random.default_rng(5)
    sp = np.column_stack([rng.uniform(0.8, 1.6, 4), rng.uniform(8, 14, 4),
                          rng.uniform(0.1, 1.0, 4), rng.uniform(0.4, 1.0, 4)])
    got, want = _both(lambda xp, cls: _decay(xp, cls, lag=lambda p, t, cov: {0: p[2]},
                                             fa=lambda p, t, cov: {0: p[3]}),
                      pst.Data(subs), sp)
    assert _rel(got, want) <= 1e-9


def test_time_varying_covariate_matches_jax_xla():
    """test_pallas_sde.py:294: a weight that changes at 0.9 h scales the
    elimination."""
    def make(xp, cls):
        return cls(drift=lambda x, p, t, r, cov: xp.stack([-p[0] * (cov("wt", t) / 70.0) * x[0]]),
                   diffusion=lambda p, t, cov: [0.0 * p[0]],
                   out=lambda x, p, t, cov: x[0:1] / p[1],
                   nparticles=8, nstates=1, ndrugs=1, nout=1, seed=3)

    subs = []
    for i in range(3):
        sb = (pst.SubjectBuilder(f"u{i}").bolus(0.0, 100.0, 0)
              .covariate("wt", 0.0, 55.0 + 4 * i).covariate("wt", 0.9, 70.0 - 3 * i))
        for t in (0.3, 0.9, 1.5):
            sb = sb.observation(t, float(8 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subs.append(sb.build())
    rng = np.random.default_rng(6)
    sp = np.column_stack([rng.uniform(0.2, 0.6, 4), rng.uniform(8, 14, 4)])
    got, want = _both(make, pst.Data(subs), sp)
    assert _rel(got, want) <= 1e-9


def test_covariate_dependent_init_matches_jax_xla():
    """test_pallas_sde.py:145: init reads the weight at t = 0."""
    subs = []
    for i in range(5):
        sb = pst.SubjectBuilder(f"s{i}").bolus(0.0, 100.0, 0).covariate("wt", 0.0, 55.0 + 6.0 * i)
        for t in (0.3, 0.8, 1.5):
            sb = sb.observation(t, float(8 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subs.append(sb.build())
    rng = np.random.default_rng(6)
    sp = np.column_stack([rng.uniform(0.2, 0.6, 6), rng.uniform(8, 14, 6)])
    got, want = _both(lambda xp, cls: _decay(
        xp, cls, init=lambda p, t, cov: [p[1] * cov("wt", t) / 70.0]), pst.Data(subs), sp)
    assert _rel(got, want) <= 1e-9


def test_dynamic_lag_fa_match_jax_xla():
    """test_pallas_sde.py:338: lag and fa that change with the dose's time."""
    subs = []
    for i in range(3):
        sb = pst.SubjectBuilder(f"d{i}").bolus(0.0, 100.0, 0).bolus(2.0, 50.0, 0)
        for t in (0.5, 1.2, 2.6, 3.5):
            sb = sb.observation(t, float(6 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subs.append(sb.build())
    rng = np.random.default_rng(7)
    sp = np.column_stack([rng.uniform(0.8, 1.6, 4), rng.uniform(8, 14, 4),
                          rng.uniform(0.1, 0.5, 4)])
    got, want = _both(lambda xp, cls: _decay(
        xp, cls, lag=lambda p, t, cov: {0: p[2] * (1.0 + 0.05 * t)},
        fa=lambda p, t, cov: {0: 1.0 / (1.0 + 0.02 * t)}), pst.Data(subs), sp)
    assert _rel(got, want) <= 1e-9


def test_lag_with_noise_agrees_with_jax_statistically():
    """test_pallas_sde.py:319: with noise both engines give finite psi
    within filter noise of each other (independent generators)."""
    sb = pst.SubjectBuilder("s0").bolus(0.0, 100.0, 0)
    for t in (0.5, 1.2, 2.6):
        sb = sb.observation(t, float(6 * np.exp(-0.3 * t)), 0)
    sp = np.array([[1.0, 10.0, 0.4]])
    got, want = _both(lambda xp, cls: _decay(xp, cls, g=0.3, nparticles=128, seed=1,
                                             lag=lambda p, t, cov: {0: p[2]}),
                      pst.Data([sb.build()]), sp)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert abs(float(got[0, 0]) - float(want[0, 0])) < 1.0


def test_options_carry_lag_and_fa_across():
    lag, fa = (lambda p, t, cov: {0: p[2]}), (lambda p, t, cov: {0: p[3]})
    jm = _decay(jnp, pst.SDE, lag=lag, fa=fa)
    opts = convert.sde_options_from_reference(jm)
    assert opts["lag"] is lag and opts["fa"] is fa
    model = pt.SDE(lambda x, p, t, r, cov: torch.stack([-p[0] * x[0]]),
                   lambda p, t, cov: [0.0], out=lambda x, p, t, cov: x[0:1] / p[1],
                   nstates=1, ndrugs=1, nout=1, **opts)
    assert model.spec.lag is lag and model.spec.fa is fa and model._lag is lag
