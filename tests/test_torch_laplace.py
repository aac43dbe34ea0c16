"""The port's ``fit_laplace`` against the JAX package's (mirrors
``tests/test_laplace.py``).

One JAX ``fit_laplace`` costs ~100 s on this CPU, so the gate compares the
objective itself, through the private ``_introspect`` hook with
``_build_only=True`` (neither side runs its optimizer), float64 on the CPU:

- ``neg_laplace`` within 1e-10 relative, its gradient (through the implicit
  rule of the inner modes: ``jax.grad`` against ``torch.autograd``) within
  1e-8 and the inner modes within 1e-9, at ``psi0`` and at a perturbed
  psi, on ``test_laplace.py::_population`` (8 subjects, diagonal omega;
  ``test_torch_laplace_features.py`` holds the full omega, a covariate
  effect and IOV);
- the port's fitted psi on the 8 subjects is a stationary point of the JAX
  objective: the JAX gradient is below ``grad_tol`` there;
- the input validation and the information-criteria surface.

Marked ``slow``: theta, omega and sigma against a JAX ``fit_laplace``
within 1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import fit_laplace as jax_fit_laplace

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.optimize import fit_laplace
from pharmsol_tpu_torch.optimize.laplace import LaplaceResult
from pharmsol_tpu_torch.optimize.saem import SaemResult

from test_laplace import _population

THETA0 = [0.3, 10.0]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _model(lib):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _prop(lib, b=0.2):
    return lib.ResidualErrorModels().add(0, lib.ResidualErrorModel.proportional(b))


def covariate_population(n=8, seed=5):
    """One-compartment subjects with a baseline weight; every other subject
    has a second occasion (unbalanced occasions, the padded kappa slots)."""
    rng = np.random.default_rng(seed)
    subjects = []
    for i in range(n):
        wt = float(rng.uniform(50.0, 100.0))
        eta = 0.2 * rng.standard_normal()
        sb = pst.Subject.builder(f"s{i}")
        for occ in range(1 + i % 2):
            if occ:
                sb = sb.reset()
            ke = 0.25 * np.exp(eta + 0.15 * rng.standard_normal())
            v = 10.0 * (wt / 70.0) ** 0.75
            sb = sb.bolus(0.0, 100.0, 0).covariate("wt", 0.0, wt)
            for t in (1.0, 4.0, 10.0):
                c = 100.0 * np.exp(-ke * t) / v
                sb = sb.observation(t, float(c * (1 + 0.05 * rng.standard_normal())), 0)
        subjects.append(sb.build())
    return pst.Data(subjects)


CONFIGS = {
    # name: (population builder, fit keywords)
    "diagonal": (lambda: _population(n=8, seed=3)[0], {}),
    "full_covariate_iov": (covariate_population,
                           dict(omega="full", covariate_effects=[(1, "wt", "power", 70.0)],
                                iov=[0], omega_iov0=0.2)),
}


def _jax_pieces(name):
    build, kw = CONFIGS[name]
    jd = build()
    intro = {}
    jax_fit_laplace(_model(pst), jd, _prop(pst), THETA0, _introspect=intro, _build_only=True,
                    **kw)
    neg = intro["neg_laplace"]

    def modes(psi):
        m, L, om_iov, sa, sb = intro["unpack"](psi)
        l_inv = jax.scipy.linalg.solve_triangular(L, jnp.eye(L.shape[0]), lower=True)
        return intro["inner_modes"](m, l_inv.T @ l_inv, 1.0 / (om_iov * om_iov), sa, sb, None)

    return jd, intro, jax.jit(jax.value_and_grad(neg)), jax.jit(modes)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX pieces of each configuration, built (and compiled) once per
    module on first use."""
    return functools.lru_cache(maxsize=None)(_jax_pieces)


def _port_pieces(name, jd):
    _, kw = CONFIGS[name]
    intro = {}
    assert fit_laplace(_model(pt), convert.data_from_reference(jd), _prop(pt), THETA0,
                       _introspect=intro, _build_only=True, **kw) is None
    return intro


def _port_modes(intro, psi):
    m, L, om_iov, sa, sb = intro["unpack"](psi)
    l_inv = torch.linalg.solve_triangular(L, torch.eye(L.shape[0], dtype=L.dtype), upper=False)
    return intro["inner_modes"](m, l_inv.T @ l_inv, 1.0 / (om_iov * om_iov), sa, sb)


def test_objective_gradient_and_modes_match_jax(jax_side):
    check_against_jax("diagonal", jax_side)


def check_against_jax(name, jax_side):
    """The objective, its gradient and the inner modes of configuration
    ``name`` against the JAX package's, at psi0 and at a perturbed psi."""
    jd, jintro, jvg, jmodes = jax_side(name)
    intro = _port_pieces(name, jd)
    psi0 = np.asarray(jintro["psi0"])
    np.testing.assert_array_equal(intro["psi0"].numpy(), psi0)
    assert intro["layout"]["o_sig"] == jintro["layout"]["o_sig"]
    for psi in (psi0, psi0 + np.linspace(-0.15, 0.12, psi0.size)):
        want_v, want_g = jvg(jnp.asarray(psi))
        z = torch.tensor(psi, requires_grad=True)
        v = intro["neg_laplace"](z)
        (g,) = torch.autograd.grad(v, z)
        np.testing.assert_allclose(float(v.detach()), float(want_v), rtol=1e-10)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-8, atol=1e-10)
        assert_modes_agree(intro, psi, _port_modes(intro, torch.tensor(psi)),
                           torch.tensor(np.asarray(jmodes(jnp.asarray(psi)))))


def assert_modes_agree(intro, psi, got, want):
    """The port's inner modes are solved: its remaining Newton step
    ``H^-1 g`` is below 1e-10 relative. They agree with the JAX package's
    within 1e-9 relative plus what the JAX side's damped Newton left
    unsolved, its own remaining step: a subject whose objective has
    flattened below the rounding of its value stops the accept test before
    the gradient vanishes (the JAX package's Newton stops one subject of
    ``_population`` at psi0 short of its mode)."""
    m, L, om_iov, sa, sb = intro["unpack"](torch.tensor(psi))
    l_inv = torch.linalg.solve_triangular(L, torch.eye(L.shape[0], dtype=L.dtype), upper=False)
    args = (m, l_inv.T @ l_inv, 1.0 / (om_iov * om_iov), sa, sb)

    def residual_step(u):
        g, H = intro["joint_grad_hess"](u.clone(), *args)
        return torch.linalg.solve(H, g.unsqueeze(-1))[..., 0].detach().abs()

    left = residual_step(got)
    assert torch.all(left <= 1e-10 * got.abs() + 1e-13), (left / got.abs()).max()
    bound = 1e-9 * want.abs() + 1e-12 + residual_step(want)
    assert torch.all((got - want).abs() <= bound), ((got - want).abs() / bound).max()


def test_fitted_psi_is_stationary_for_the_jax_objective(jax_side):
    jd, _, jvg, _ = jax_side("diagonal")
    intro = {}
    res = fit_laplace(_model(pt), convert.data_from_reference(jd), _prop(pt), THETA0,
                      _introspect=intro, compute_se=False)
    assert res.converged, res.summary()
    g = np.asarray(jvg(jnp.asarray(intro["z_opt"]))[1])
    assert np.max(np.abs(g)) < 1e-4, g
    assert res.individual_parameters.shape == (8, 2) and res.kappa is None
    assert "typical" in res.summary()


def test_validates_inputs():
    jd, _ = _population(n=4, seed=2)
    data = convert.data_from_reference(jd)
    m = _model(pt)
    with pytest.raises(PharmsolError, match="theta0 > 0"):
        fit_laplace(m, data, _prop(pt), [-0.1, 10.0])
    with pytest.raises(PharmsolError, match="metadata"):
        fit_laplace(m, data, _prop(pt), {"ke": 0.3, "v": 10.0})
    with pytest.raises(PharmsolError, match="at least 2"):
        fit_laplace(m, pt.Data(list(data.subjects())[:1]), _prop(pt), THETA0)
    with pytest.raises(PharmsolError, match="transform"):
        fit_laplace(m, data, _prop(pt), THETA0, transform="sqrt")
    with pytest.raises(PharmsolError, match="omega0"):
        fit_laplace(m, data, _prop(pt), THETA0, omega0=0.0)
    with pytest.raises(PharmsolError, match="residual error"):
        fit_laplace(m, data, pt.ResidualErrorModels(), THETA0)
    with pytest.raises(PharmsolError, match="'diagonal' or 'full'"):
        fit_laplace(m, data, _prop(pt), THETA0, omega="block")
    with pytest.raises(PharmsolError, match="more than one occasion"):
        fit_laplace(m, data, _prop(pt), THETA0, iov=[0])
    sde = pt.SDE(lambda x, p, t, rateiv, cov: [-p[0] * x[0]], lambda p, t, cov: [0.1],
                 out=lambda x, p, t, cov: x[0:1] / p[1], nparticles=8, nstates=1, ndrugs=1,
                 nout=1)
    with pytest.raises(PharmsolError, match="fit_saem"):
        fit_laplace(sde, data, _prop(pt), THETA0)


def test_information_criteria_surface():
    # aic/bic are pure arithmetic on (log_likelihood, n_free, n_obs)
    r = LaplaceResult(
        theta=np.ones(2), omega=np.ones(2), residual_models=None,
        individual_parameters=np.ones((2, 2)), eta=np.zeros((2, 2)),
        log_likelihood=-100.0, converged=True, iterations=3,
        gradient_norm=0.0, standard_errors=None,
        omega_standard_errors=None, parameter_names=None,
        transform=("log", "log"), n_free=5, n_obs=50,
    )
    assert r.aic() == pytest.approx(210.0)
    assert r.bic() == pytest.approx(200.0 + 5 * np.log(50))
    s = SaemResult(
        theta=np.ones(2), omega=np.ones(2), residual_models=None,
        individual_parameters=np.ones((2, 2)),
        ll_trace=np.zeros(3), accept_rate=0.4, log_likelihood=None,
        parameter_names=None, transform=("log", "log"),
        n_free=5, n_obs=50,
    )
    assert np.isnan(s.aic()) and np.isnan(s.bic())


@pytest.mark.slow
def test_fit_matches_a_jax_fit():
    jd, _ = _population(n=8, seed=3)
    want = jax_fit_laplace(_model(pst), jd, _prop(pst), THETA0)
    got = fit_laplace(_model(pt), convert.data_from_reference(jd), _prop(pt), THETA0)
    np.testing.assert_allclose(got.theta, want.theta, rtol=1e-5)
    np.testing.assert_allclose(got.omega, want.omega, rtol=1e-5)
    np.testing.assert_allclose(got.residual_models.get(0).b, want.residual_models.get(0).b,
                               rtol=1e-5)
    np.testing.assert_allclose(got.log_likelihood, want.log_likelihood, rtol=1e-8)
    np.testing.assert_allclose(got.standard_errors, want.standard_errors, rtol=1e-5)
