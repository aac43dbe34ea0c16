"""The per-subject batch log-likelihood of the port against the JAX package.

``log_likelihood_batch`` / ``log_likelihood_subject``: every subject under its
own parameter row, prediction-based sigma through ResidualErrorModels (the
SAEM/FOCE surface), on the same data (built with the JAX package's builder,
carried across by ``convert.data_from_reference``), parameters and residual
models (``convert.residual_error_models_from_reference``); float64 within
1e-10 relative. Mirrors ``tests/test_population.py:78-107``: each residual
kind, multi-occasion subjects, the hand-computed value of one subject, a
missing residual model (-inf), a failed simulation (-inf); closed form
(with lag and fa, whose segments sort per row), ODE and SDE at zero
diffusion. Also: the general engine's psi, whose segment loop the batch's
prediction march shares, against the JAX package's ``engine='xla'``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_batch as jax_batch
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood.matrix import log_likelihood_batch, log_likelihood_subject
from pharmsol_tpu_torch.utils import f32_budget as fb

RTOL = 1e-10
KINDS = {
    "constant": lambda lib: lib.ResidualErrorModel.constant(0.7),
    "proportional": lambda lib: lib.ResidualErrorModel.proportional(0.15),
    "combined": lambda lib: lib.ResidualErrorModel.combined(0.5, 0.1),
    "exponential": lambda lib: lib.ResidualErrorModel.exponential(0.3),
}


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def population(n=5, seed=42):
    """One-compartment subjects of the JAX package's test_population, every
    other one with a second occasion."""
    rng = np.random.RandomState(seed)
    subjects = []
    for i in range(n):
        b = pst.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t in (0.5, 1.0, 2.0, 4.0, 8.0):
            b = b.observation(t, float(60 * math.exp(-0.2 * t) + rng.randn()), 0)
        if i % 2:
            b = b.reset().bolus(0.0, 50.0, 0).observation(1.0, float(25 + rng.randn()), 0)
        subjects.append(b.build())
    return pst.Data(subjects)


def one_cmt(lib):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


@pytest.fixture(scope="module")
def closed():
    """The JAX model is shared by the module's tests: its batch program is
    compiled once."""
    return one_cmt(pst), one_cmt(pt), population()


def batch_pair(jm, tm, jd, params, jrems):
    want = np.asarray(jax_batch(jm, jd, params, jrems))
    got = log_likelihood_batch(tm, convert.data_from_reference(jd), params,
                               convert.residual_error_models_from_reference(jrems))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert got.shape == (len(jd),)
    return got.numpy(), want


@pytest.mark.parametrize("kind", list(KINDS))
def test_residual_kinds_match_jax(closed, kind):
    jm, tm, jd = closed
    params = np.array([[0.1 + 0.03 * i, 1.0 + 0.1 * i] for i in range(len(jd))])
    jrems = pst.ResidualErrorModels().add(0, KINDS[kind](pst))
    got, want = batch_pair(jm, tm, jd, params, jrems)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_subject_value_by_hand(closed):
    """tests/test_population.py:78-100: subject 0 by hand from the port's
    predictions, and log_likelihood_subject; the port's
    ResidualErrorModels.total_log_likelihood gives the same sum."""
    jm, tm, jd = closed
    params = np.array([[0.15, 1.0], [0.2, 1.1], [0.25, 0.9], [0.3, 1.0], [0.12, 1.2]])
    rems = pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.combined(0.5, 0.1))
    data = convert.data_from_reference(jd)
    lls = log_likelihood_batch(tm, data, params, rems)
    for i in (0, 1):
        preds = tm.estimate_predictions(data.subjects()[i], params[i])
        total = 0.0
        for p in preds.predictions():
            s = max(math.sqrt(0.5**2 + 0.1**2 * p.prediction**2),
                    math.sqrt(np.finfo(np.float64).eps))
            z = (p.observation - p.prediction) / s
            total += -0.5 * (math.log(2 * math.pi) + 2 * math.log(s) + z * z)
        np.testing.assert_allclose(float(lls[i]), total, rtol=RTOL)
        np.testing.assert_allclose(rems.total_log_likelihood(
            (0, p.observation, p.prediction) for p in preds.predictions()), total, rtol=RTOL)
        single = log_likelihood_subject(tm, data.subjects()[i], params[i], rems)
        np.testing.assert_allclose(single, total, rtol=RTOL)


def test_missing_model_and_failure_are_neg_inf(closed):
    """An active observation on an output without a residual model gives
    -inf (mod.rs:132); so does a simulation that fails (NaN), in both
    packages."""
    jm, tm, jd = closed
    params = np.array([[0.15, 1.0], [0.2, 0.0], [0.25, 0.9], [0.3, 1.0], [0.12, 1.2]])
    got, want = batch_pair(jm, tm, jd, params, pst.ResidualErrorModels())
    assert np.all(np.isneginf(got)) and np.all(np.isneginf(want))
    jrems = pst.ResidualErrorModels().add(0, KINDS["combined"](pst))
    got, want = batch_pair(jm, tm, jd, params, jrems)
    assert np.isneginf(got[1]) and np.isneginf(want[1])
    keep = np.arange(len(jd)) != 1
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL)


def test_parameter_rows_must_match_the_subjects(closed):
    _, tm, jd = closed
    rems = pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.constant(1.0))
    with pytest.raises(PharmsolError, match="rows"):
        log_likelihood_batch(tm, convert.data_from_reference(jd), np.ones((2, 2)), rems)


@pytest.mark.parametrize("name", ["lag_fa", "init_rows"])
def test_closed_form_features_match_jax(name):
    """Lag and fa (each row's segments sorted under its own parameters) and
    init, per subject."""
    jm, jd, sp = fb.feature_case(name, 4, 4, lib=pst)[:3]
    tm = fb.feature_case(name, 4, 4)[0]
    jrems = pst.ResidualErrorModels().add(0, KINDS["combined"](pst))
    got, want = batch_pair(jm, tm, jd, sp, jrems)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("name", ["ode", "sde_zero_diffusion"])
def test_ode_and_sde_match_jax(name):
    """An ODE with lag and fa (dopri5), and an SDE at zero diffusion (1e-9:
    the engines' noise differs, so they agree only without it)."""
    if name == "ode":
        build, rtol = (lambda **kw: fb.ode_feature_case("lag_fa", 3, 3, **kw)), RTOL
    else:
        build, rtol = (lambda **kw: fb.sde_feature_case("cov_affine", 3, 3, sigma=False,
                                                        **kw)), 1e-9
    jm, jd, sp = build(lib=pst, stack=jnp.stack)[:3]
    tm = build()[0]
    jrems = pst.ResidualErrorModels().add(0, KINDS["proportional"](pst))
    got, want = batch_pair(jm, tm, jd, sp, jrems)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("name", ["closed_lag_fa", "ode_lag_fa"])
def test_general_psi_unchanged_by_the_shared_march(name):
    """The general engine's psi, whose segment loop the prediction march
    shares, against the JAX package's ``engine='xla'`` (1e-10), on cases
    whose segments sort per support point."""
    if name == "closed_lag_fa":
        jm, jd, sp, jems = fb.feature_case("lag_fa", 3, 4, lib=pst)[:4]
        tm, _, _, tems = fb.feature_case("lag_fa", 3, 4)[:4]
    else:
        jm, jd, sp, jems = fb.ode_feature_case("lag_fa", 2, 3, lib=pst, stack=jnp.stack)
        tm, _, _, tems = fb.ode_feature_case("lag_fa", 2, 3)
    want = np.asarray(jax_psi(jm, jd, sp, jems, engine="xla"))
    got = pt.log_likelihood_matrix(tm, convert.data_from_reference(jd), sp, tems,
                                   engine="general").numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)
