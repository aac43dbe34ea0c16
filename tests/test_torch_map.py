"""The port's ``fit_map`` against the JAX package's (mirrors
``tests/test_map.py``).

A JAX ``fit_map`` costs 26-60 s on this CPU, so the gate holds the port's fit
by cheaper, exact means, on the data of ``test_map.py::_synth_data`` (carried
across by ``convert.data_from_reference``), float64 on the CPU:

- the port's optimum is a stationary point of the JAX objective: the JAX
  gradient of the negative log posterior (built from the JAX package's
  ``log_likelihood_fn`` and the same prior, compiled once) is below
  ``grad_tol`` at the port's estimate, for maximum likelihood, for MAP
  with a prior, and for the adaptive dopri5 ODE (``jax.jacfwd``);
- the objective's value and gradient at three points equal the JAX
  package's within 1e-10;
- the input validation of ``test_fit_map_rejects_sde_and_bad_x0``.

Marked ``slow``: the estimates, the log posterior and the standard errors
against a JAX ``fit_map`` at ``grad_tol=1e-8``, within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import fit_map as jax_fit_map

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.optimize import fit_map

from test_map import _synth_data

X0 = [0.8, 0.4, 8.0]
PRIOR_MEAN = np.array([2.0, 0.1, 20.0])


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _ems(lib):
    return lib.AssayErrorModels().add(0, lib.AssayErrorModel.proportional(lib.ErrorPoly(0.0, 0.03),
                                                                          1.0))


def _model(lib):
    return lib.Analytical(lib.one_compartment_with_absorption,
                          out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)


def _ode(lib, stack):
    return lib.ODE(lambda x, p, t, b, rateiv, cov: stack([-p[0] * x[0] + b[0],
                                                         p[0] * x[0] - p[1] * x[1]]),
                   out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)


def _prior(lib):
    log_mean = (jnp.asarray if lib is jnp else torch.as_tensor)(np.log(PRIOR_MEAN))

    def prior(p):
        return -0.5 * lib.sum(((lib.log(p) - log_mean) / 0.2) ** 2)

    return prior


def _jax_objective(model, data, prior=None, forward=False):
    """The JAX package's negative log posterior in z = log(p) and its
    gradient (``fit_map``'s objective), jitted."""
    ll = model.log_likelihood_fn(data, _ems(pst))

    def neg(z):
        p = jnp.exp(z)
        return -(ll(p) + (prior(p) if prior is not None else 0.0))

    return jax.jit(neg), jax.jit(jax.jacfwd(neg) if forward else jax.grad(neg))


@pytest.fixture(scope="module")
def closed():
    jd = _synth_data()
    return jd, convert.data_from_reference(jd), _jax_objective(_model(pst), jd)


def _stationary(jgrad, res, grad_tol):
    assert res.converged, res.summary()
    g = np.asarray(jgrad(jnp.asarray(np.log(res.parameters))))
    assert np.max(np.abs(g)) < grad_tol, (g, res.summary())


def test_optimum_is_stationary_for_the_jax_objective(closed):
    jd, td, (_, jgrad) = closed
    res = fit_map(_model(pt), td, _ems(pt), X0)
    _stationary(jgrad, res, 1e-6)
    assert np.all(np.abs(res.parameters - [1.2, 0.25, 12.0]) / [1.2, 0.25, 12.0] < 0.15)
    assert res.standard_errors is not None and np.all(res.standard_errors > 0)
    C = res.covariance
    assert np.allclose(C, C.T, rtol=1e-8) and np.all(np.linalg.eigvalsh(C) > 0)
    assert "converged" in res.summary()


def test_value_and_gradient_match_jax_at_three_points(closed):
    jd, td, (jval, jgrad) = closed
    ll = _model(pt).log_likelihood_fn(td, _ems(pt))
    for z in (np.log(X0), np.log([1.2, 0.25, 12.0]), np.log([0.5, 0.7, 20.0])):
        zt = torch.tensor(z, requires_grad=True)
        v = -ll(torch.exp(zt))
        (g,) = torch.autograd.grad(v, zt)
        np.testing.assert_allclose(float(v.detach()), float(jval(jnp.asarray(z))), rtol=1e-10)
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad(jnp.asarray(z))), rtol=1e-10)


def test_prior_optimum_is_stationary_and_shrinks():
    """MAP with a log-normal prior (``test_fit_map_prior_shrinks_toward_
    prior_mean``): stationary for the JAX posterior, every component moved
    from the ML estimate toward the prior mean."""
    jd = _synth_data(n=2, seed=3)
    td = convert.data_from_reference(jd)
    _, jgrad = _jax_objective(_model(pst), jd, prior=_prior(jnp))
    ml = fit_map(_model(pt), td, _ems(pt), X0)
    mp = fit_map(_model(pt), td, _ems(pt), X0, prior_logpdf=_prior(torch))
    _stationary(jgrad, mp, 1e-6)
    for i in range(3):
        assert (abs(np.log(mp.parameters[i]) - np.log(PRIOR_MEAN[i]))
                < abs(np.log(ml.parameters[i]) - np.log(PRIOR_MEAN[i])))
    assert mp.log_likelihood <= ml.log_likelihood + 1e-9


def test_adaptive_solver_optimum_is_stationary_for_jax_jacfwd():
    """dopri5: the port differentiates its stepper loop by reverse mode; the
    JAX package's ``jax.jacfwd`` through its while_loop is below
    ``grad_tol`` at the port's estimate (``test_fit_map_adaptive_solver_
    forward_mode``)."""
    jd = _synth_data(3)
    _, jgrad = _jax_objective(_ode(pst, jnp.stack), jd, forward=True)
    res = fit_map(_ode(pt, torch.stack), convert.data_from_reference(jd), _ems(pt), X0)
    _stationary(jgrad, res, 1e-6)
    assert res.standard_errors is not None and np.all(np.isfinite(res.standard_errors))


def test_rejects_sde_and_bad_x0():
    td = convert.data_from_reference(_synth_data(1))
    sde = pt.SDE(lambda x, p, t, rateiv, cov: [-p[0] * x[0]], lambda p, t, cov: [0.1],
                 out=lambda x, p, t, cov: x[0:1] / p[1], nstates=1, ndrugs=1, nout=1,
                 nparticles=8)
    with pytest.raises(PharmsolError, match="SDE"):
        fit_map(sde, td, _ems(pt), [0.3, 10.0])
    with pytest.raises(PharmsolError, match="positive"):
        fit_map(_model(pt), td, _ems(pt), [0.8, -0.4, 8.0])
    # ka == ke is the flip-flop singularity of the oral kernel
    with pytest.raises(PharmsolError, match="non-finite"):
        fit_map(_model(pt), td, _ems(pt), [0.5, 0.5, 8.0])


def test_refits_same_shaped_data():
    """A second Data of the same shapes refits (the bootstrap workflow):
    different noise, a different optimum."""
    m = _model(pt)
    r1 = fit_map(m, convert.data_from_reference(_synth_data(seed=0)), _ems(pt), X0)
    r2 = fit_map(m, convert.data_from_reference(_synth_data(seed=1)), _ems(pt), X0)
    assert r1.converged and r2.converged
    assert not np.allclose(r1.parameters, r2.parameters)


@pytest.mark.slow
def test_estimates_match_a_jax_fit(closed):
    jd, td, _ = closed
    want = jax_fit_map(_model(pst), jd, _ems(pst), X0, grad_tol=1e-8)
    got = fit_map(_model(pt), td, _ems(pt), X0, grad_tol=1e-8)
    assert want.converged and got.converged
    np.testing.assert_allclose(got.parameters, want.parameters, rtol=1e-6)
    np.testing.assert_allclose(got.log_posterior, want.log_posterior, rtol=1e-10)
    np.testing.assert_allclose(got.standard_errors, want.standard_errors, rtol=1e-6)
