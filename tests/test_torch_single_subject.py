"""The single-subject API of the port against the JAX package (float64, CPU).

``estimate_predictions`` (predictions, states, times, observations and each
Prediction's metadata), ``estimate_log_likelihood``, ``simulate_subject`` and
the single-subject cache, on the same subject built with the JAX package's
builder and carried across by ``convert.data_from_reference``, under the same
parameters and error models. Models here: the 12 closed forms, on a two-
occasion subject with boluses, an infusion, an errorpoly override, a BLOQ
and a missing observation, and a non-finite prediction's SolverError.
Tolerance: 1e-10 relative. The closed form with covariates, seq, lag, fa
and init, metadata labels and the cache are in
``test_torch_single_subject_features.py``; the ODE and SDE models in
``test_torch_single_subject_ode.py``. (The JAX side compiles two programs
per model, a few seconds each: the files are split to keep each short.)
"""

import numpy as np
import pytest
import torch

import pharmsol_tpu as pst

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import SolverError
from pharmsol_tpu_torch.utils import f32_budget as fb

RTOL = 1e-10


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def jax_subject(sid="s0", seed=0):
    rng = np.random.RandomState(seed)
    b = (pst.Subject.builder(sid).bolus(0.0, 100.0, 0).infusion(6.0, 50.0, 0, 2.0)
         .bolus(12.0, 80.0, 0))
    for t in (0.0, 1.0, 7.0, 13.0):
        b = b.observation(t, float(2.0 + rng.rand()), 0)
    b = (b.observation_with_error(3.0, 2.5, 0, (0.1, 0.2, 0.0, 0.01))
         .censored_observation(30.0, 0.05, 0, pst.Censor.BLOQ)
         .missing_observation(16.0, 0)
         .reset().bolus(0.0, 60.0, 0).observation(1.0, 1.2, 0).observation(5.0, 0.8, 0))
    return b.build()


def jax_ems():
    return pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1, 0.0, 0.0), 1.0))


def closed_models(name):
    """(JAX model, port model, parameters) of structure ``name``: the kernel
    and its central compartment over the volume (the last column)."""
    n = 1 + ("two" in name) + 2 * ("three" in name) + ("absorption" in name)
    c = 1 if "absorption" in name else 0

    def out(x, p, t, cov):
        return x[c:c + 1] / p[-1]

    params = list(fb.NOMINAL[name]) + [11.0]
    return (pst.Analytical(getattr(pst, name), out=out, nstates=n, ndrugs=1, nout=1),
            pt.Analytical(getattr(pt, name), out=out, nstates=n, ndrugs=1, nout=1),
            params)


def assert_same_predictions(got, want, rtol=RTOL):
    g, w = got.predictions(), want.predictions()
    assert len(g) == len(w) > 0
    assert got.flat_times() == want.flat_times()
    assert got.flat_observations() == want.flat_observations()
    for a, b in zip(g, w):
        assert (a.outeq, a.occasion, a.censoring.value, a.errorpoly) == \
            (b.outeq, b.occasion, b.censoring.value, b.errorpoly)
    np.testing.assert_allclose(got.flat_predictions(), want.flat_predictions(),
                               rtol=rtol, atol=1e-300)
    np.testing.assert_allclose(np.array([a.state for a in g]),
                               np.array([np.asarray(b.state, dtype=float) for b in w]),
                               rtol=rtol, atol=1e-12)


def compare_subject(jm, tm, js, params, jems, rtol=RTOL):
    ps = convert.data_from_reference([js]).subjects()[0]
    tems = convert.error_models_from_reference(jems)
    assert_same_predictions(tm.estimate_predictions(ps, params),
                            jm.estimate_predictions(js, params), rtol)
    ll_t = tm.estimate_log_likelihood(ps, params, tems)
    ll_j = jm.estimate_log_likelihood(js, params, jems)
    assert np.isfinite(ll_t)
    np.testing.assert_allclose(ll_t, ll_j, rtol=rtol)
    preds, lik = tm.simulate_subject(ps, params, tems)
    assert lik == pytest.approx(float(np.exp(ll_j)), rel=rtol)
    assert preds.flat_predictions() == tm.estimate_predictions(ps, params).flat_predictions()
    assert tm.estimate_likelihood(ps, params, tems) == pytest.approx(
        jm.estimate_likelihood(js, params, jems), rel=rtol)


@pytest.mark.parametrize("name", list(fb.NOMINAL))
def test_closed_form_matches_jax(name):
    jm, tm, params = closed_models(name)
    compare_subject(jm, tm, jax_subject(), params, jax_ems())


def test_solver_error_carries_the_subject_id():
    """A non-finite prediction raises SolverError with the subject's id and
    the parameters (error/mod.rs:82-110), in both packages."""
    jm, tm, _ = closed_models("one_compartment")
    js = pst.Subject.builder("bad_subject").bolus(0.0, 100.0, 0).observation(1.0, 5.0, 0).build()
    ps = convert.data_from_reference([js]).subjects()[0]
    with pytest.raises(SolverError) as e:
        tm.estimate_predictions(ps, [0.2, 0.0])
    assert e.value.subject_id == "bad_subject" and e.value.parameters == [0.2, 0.0]
    assert "bad_subject" in str(e.value)
    with pytest.raises(pst.errors.SolverError) as ej:
        jm.estimate_predictions(js, [0.2, 0.0])
    assert ej.value.subject_id == e.value.subject_id
    # the population paths degrade to -inf instead
    ems = convert.error_models_from_reference(jax_ems())
    psi = pt.log_likelihood_matrix(tm, pt.Data([ps]), np.array([[0.2, 0.0]]), ems)
    assert torch.isneginf(psi).all()
