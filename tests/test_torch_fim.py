"""The port's ``laplace_standard_errors`` (mirrors ``tests/test_fim.py``).

The standard errors come from the exact Hessian of the Laplace objective at
a fit's estimates: ``torch.autograd`` twice through the objective, the
second pass through the implicit rule of the inner modes (whose backward
is differentiable). The estimates here are a fit-shaped record with fixed
theta, omega and residual models, so that no package runs a fit.

- In the gate: the port's Hessian against central differences of its own
  ``neg_laplace`` gradient (which ``test_torch_laplace.py`` holds against
  the JAX package's), and the report's covariance, SEs and labels against
  that Hessian, float64 on the CPU.
- Marked ``slow``: the standard errors, the covariance and the
  log-likelihood against the JAX package's ``laplace_standard_errors`` at
  the same record, within 1e-7 relative.
"""

from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import laplace_standard_errors as jax_fim

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.optimize import fit_laplace, laplace_standard_errors

from test_fim import _population


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


class FitRecord(NamedTuple):
    """What ``laplace_standard_errors`` reads of a fit."""

    theta: np.ndarray
    omega: np.ndarray
    transform: tuple
    residual_models: object
    omega_cov: Optional[np.ndarray] = None
    beta: Optional[np.ndarray] = None
    covariate_effects: Optional[tuple] = None


def _model(lib):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _record(lib):
    rems = lib.ResidualErrorModels().add(0, lib.ResidualErrorModel.proportional(0.07))
    return FitRecord(theta=np.array([0.26, 10.4]), omega=np.array([0.27, 0.14]),
                     transform=("log", "log"), residual_models=rems)


@pytest.fixture(scope="module")
def data():
    jd = _population(n=8, seed=3)
    return jd, convert.data_from_reference(jd)


def test_hessian_matches_central_differences_of_the_gradient(data):
    _, td = data
    rec = _record(pt)
    r = laplace_standard_errors(_model(pt), td, None, rec)
    intro = {}
    fit_laplace(_model(pt), td, rec.residual_models, rec.theta, _introspect=intro,
                _build_only=True)
    psi = torch.tensor(np.concatenate([np.log(rec.theta), np.log(rec.omega), [np.log(0.07)]]))
    from pharmsol_tpu_torch.optimize.laplace import laplace_hessian

    H = laplace_hessian(intro["neg_laplace"], psi)

    def grad(z):
        z = z.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(intro["neg_laplace"](z), z)
        return g.numpy()

    eps = 1e-5
    fd = np.stack([(grad(psi + eps * e) - grad(psi - eps * e)) / (2 * eps)
                   for e in torch.eye(psi.shape[0], dtype=psi.dtype)])
    np.testing.assert_allclose(H, fd, rtol=0, atol=1e-6 * np.abs(H).max())
    np.testing.assert_allclose(H, H.T, rtol=0, atol=1e-9 * np.abs(H).max())
    # the report is that Hessian's inverse, with the delta method's SEs
    cov = np.linalg.inv(0.5 * (H + H.T))
    np.testing.assert_allclose(r.covariance, cov, rtol=1e-12)
    sd = np.sqrt(np.diag(cov))
    np.testing.assert_allclose(r.theta_se, rec.theta * sd[:2], rtol=1e-12)
    np.testing.assert_allclose(r.omega_se, rec.omega * sd[2:4], rtol=1e-12)
    np.testing.assert_allclose(r.sigma_se, 0.07 * sd[4:], rtol=1e-12)
    assert r.names == ("mu[0]", "mu[1]", "log_omega[0]", "log_omega[1]", "log_sigma[0.b]")
    assert np.isfinite(r.condition_number) and np.isfinite(r.log_likelihood)
    assert np.allclose(np.diag(r.correlation), 1.0)
    assert "condition number" in r.summary()


@pytest.mark.slow
def test_standard_errors_match_jax(data):
    jd, td = data
    want = jax_fim(_model(pst), jd, None, _record(pst))
    got = laplace_standard_errors(_model(pt), td, None, _record(pt))
    for name in ("theta_se", "omega_se", "sigma_se", "covariance"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-7)
    np.testing.assert_allclose(got.log_likelihood, want.log_likelihood, rtol=1e-10)
    np.testing.assert_allclose(got.gradient_norm, want.gradient_norm, rtol=1e-6)
    assert got.names == want.names
