"""The port's differentiable likelihood against the JAX package's.

``EquationBase.log_likelihood_fn`` (mirrors ``tests/test_grad.py``): a torch
function of the dense parameter vector on the lowered data. The same data
(built with the JAX package's builder, carried across by
``convert.data_from_reference``) and parameters go through both packages, in
float64 on the CPU:

- closed forms (1-cmt and 2-cmt oral) and the ``expm`` ODE: the value
  within 1e-12 relative, ``torch.autograd``'s gradient against
  ``jax.grad`` within 1e-10; the Hessian and the per-subject Jacobian
  against ``jax.hessian`` / ``jax.jacrev``;
- the adaptive dopri5 ODE: ``torch.autograd`` differentiates the port's
  masked stepper loop, and the derivative is held against ``jax.jacfwd``
  through the JAX package's ``lax.while_loop`` (the same discrete march)
  within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert

P0 = np.array([1.1, 0.25, 11.0])


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _ems(lib):
    return lib.AssayErrorModels().add(0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def _data(n=3):
    subjects = []
    for i in range(n):
        sb = pst.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        if i == 2:
            sb = sb.infusion(3.0, 50.0, 0, 1.5)
        for t in (0.5, 2.0, 6.0):
            sb = sb.observation(t, float(5 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subjects.append(sb.build())
    return pst.Data(subjects)


def _oral(lib):
    return lib.Analytical(lib.one_compartment_with_absorption,
                          out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)


def _two_cmt_oral(lib):
    return lib.Analytical(lib.two_compartments_with_absorption,
                          out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)


def _ode(lib, stack, solver=None):
    m = lib.ODE(lambda x, p, t, b, rateiv, cov: stack([-p[0] * x[0] + b[0],
                                                       p[0] * x[0] - p[1] * x[1] + rateiv[0]]),
                out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
    return m.with_solver(solver) if solver else m


CASES = {
    # name: (model builder (lib, stack), parameters, JAX derivative, value / gradient rtol)
    "one_cmt_oral": (lambda lib, st: _oral(lib), P0, jax.grad, (1e-12, 1e-10)),
    "two_cmt_oral": (lambda lib, st: _two_cmt_oral(lib), np.array([1.1, 0.2, 0.3, 0.15, 11.0]),
                     jax.grad, (1e-12, 1e-10)),
    "expm": (lambda lib, st: _ode(lib, st, "expm"), P0, jax.grad, (1e-12, 1e-10)),
    "dopri5": (lambda lib, st: _ode(lib, st), P0, jax.jacfwd, (1e-12, 1e-8)),
}


@pytest.fixture(scope="module")
def data():
    jd = _data()
    return jd, convert.data_from_reference(jd)


@pytest.mark.parametrize("name", list(CASES))
def test_value_and_gradient_match_jax(name, data):
    build, p, jax_d, (rtol_v, rtol_g) = CASES[name]
    jd, td = data
    jf = build(pst, jnp.stack).log_likelihood_fn(jd, _ems(pst))
    want_v = float(jf(jnp.asarray(p)))
    want_g = np.asarray(jax.jit(jax_d(jf))(jnp.asarray(p)))
    fn = build(pt, torch.stack).log_likelihood_fn(td, _ems(pt))
    x = torch.tensor(p, requires_grad=True)
    v = fn(x)
    (g,) = torch.autograd.grad(v, x)
    assert np.isfinite(want_v) and np.all(np.isfinite(want_g))
    np.testing.assert_allclose(float(v.detach()), want_v, rtol=rtol_v, atol=0)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=rtol_g, atol=0)


def test_hessian_and_per_subject_jacobian_match_jax(data):
    """Second order and the per-subject surface (``per_subject=True``): the
    Jacobian [n_subjects, n_params] of the per-subject log-likelihoods by
    ``torch.func.jacrev`` against ``jax.jacrev``, its column sums the
    gradient of the total, and the Hessian against ``jax.hessian``."""
    jd, td = data
    jm, tm = _oral(pst), _oral(pt)
    jper = jm.log_likelihood_fn(jd, _ems(pst), per_subject=True)
    jtot = jm.log_likelihood_fn(jd, _ems(pst))
    want_per = np.asarray(jper(jnp.asarray(P0)))
    want_J = np.asarray(jax.jit(jax.jacrev(jper))(jnp.asarray(P0)))
    want_H = np.asarray(jax.jit(jax.hessian(jtot))(jnp.asarray(P0)))
    fper = tm.log_likelihood_fn(td, _ems(pt), per_subject=True)
    ftot = tm.log_likelihood_fn(td, _ems(pt))
    x = torch.tensor(P0)
    per = fper(x).numpy()
    assert per.shape == (3,)
    np.testing.assert_allclose(per, want_per, rtol=1e-12, atol=0)
    assert np.isclose(per.sum(), float(ftot(x)), rtol=1e-13)
    J = torch.func.jacrev(fper)(x).numpy()
    assert J.shape == (3, 3)
    np.testing.assert_allclose(J, want_J, rtol=1e-10, atol=0)
    np.testing.assert_allclose(J.sum(axis=0), torch.func.grad(ftot)(x).numpy(), rtol=1e-10)
    H = torch.autograd.functional.hessian(ftot, x).numpy()
    np.testing.assert_allclose(H, want_H, rtol=1e-9, atol=0)
    np.testing.assert_allclose(H, H.T, rtol=1e-10)


def test_one_subject_and_parameters_as_numpy(data):
    """A single Subject is accepted as the data, numpy parameters as the
    argument; the function's value is the subject's
    ``estimate_log_likelihood``."""
    _, td = data
    tm = _oral(pt)
    s = td.subjects()[0]
    fn = tm.log_likelihood_fn(s, _ems(pt))
    v = fn(P0)
    assert isinstance(v, torch.Tensor) and v.dim() == 0
    np.testing.assert_allclose(float(v), tm.estimate_log_likelihood(s, P0, _ems(pt)),
                               rtol=1e-13)


def test_every_model_class_has_log_likelihood_fn():
    """The JAX package gives ``log_likelihood_fn`` to every equation class
    (``EquationBase``); so does the port, the SDE's being its particle
    filter (not differentiable)."""
    for cls in (pt.Analytical, pt.ODE, pt.SDE):
        assert callable(getattr(cls, "log_likelihood_fn"))
    sde = pt.SDE(lambda x, p, t, r, cov: [-p[0] * x[0]], lambda p, t, cov: [0.0],
                 out=lambda x, p, t, cov: [x[0] / p[1]], nstates=1, ndrugs=1, nout=1,
                 nparticles=8)
    s = pt.Subject.builder("a").bolus(0.0, 100.0, 0).observation(2.0, 8.0, 0).build()
    fn = sde.log_likelihood_fn(s, _ems(pt))
    assert np.isfinite(float(fn(np.array([0.2, 10.0]))))
