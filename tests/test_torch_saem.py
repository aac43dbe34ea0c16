"""The port's ``fit_saem`` against the JAX package's on the JAX run's own
draws (mirrors ``tests/test_saem.py``).

SAEM is stochastic: the JAX package draws from ``jax.random.PRNGKey(seed)``
(a key per iteration, per MH step four subkeys: the phi proposal's normals,
its uniforms, the kappa proposal's normals and uniforms; ``seed + 1`` and
``seed + 2`` for the importance sample), the port from a CPU
``torch.Generator``. :func:`jax_draws` rebuilds the JAX run's draws with
that key schedule and hands them to the port through its private
``_draws`` hook, so both packages run the same chain: 6 subjects,
``n_burn=5, n_iters=5, mh_steps=2``, ``ll_draws=16``, with and without a
covariate effect and IOV. The ll trace, theta, omega, sigma, the
individual parameters and the importance-sampled log-likelihood agree
within 1e-10 relative (float64, CPU). Also the input validation, and the
port's own draws (same seed, same fit). Marked ``slow``: an SDE model at
zero diffusion (the port's SDE predictions equal the JAX package's only
there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import fit_saem as jax_fit_saem

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.optimize import fit_saem
from pharmsol_tpu_torch.optimize.saem import saem_draws

from test_saem import _population
from test_torch_laplace import covariate_population

RTOL = 1e-10
RUN = dict(n_burn=5, n_iters=5, mh_steps=2, ll_draws=16, seed=0)


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


def jax_draws(seed, n_total, mh_steps, n_sub, p, k_max, q, ll_draws):
    """The normals and uniforms of a JAX ``fit_saem`` run
    (``optimize/saem.py:522, :426, :381-388, :407-414, :574-581``)."""
    f64 = jnp.float64
    keys = jax.random.split(jax.random.PRNGKey(seed), n_total)
    parts = {"phi_noise": [], "phi_unif": [], "kap_noise": [], "kap_unif": []}
    for key in keys:
        steps = [jax.random.split(k, 4) for k in jax.random.split(key, mh_steps)]
        parts["phi_noise"].append([jax.random.normal(k[0], (n_sub, p), dtype=f64) for k in steps])
        parts["phi_unif"].append([jax.random.uniform(k[1], (n_sub,), dtype=f64) for k in steps])
        if q:
            parts["kap_noise"].append([jax.random.normal(k[2], (n_sub, k_max, q), dtype=f64)
                                       for k in steps])
            parts["kap_unif"].append([jax.random.uniform(k[3], (n_sub,), dtype=f64)
                                      for k in steps])
    out = {k: np.asarray(v, dtype=np.float64) for k, v in parts.items() if v}
    if ll_draws:
        out["is_eta"] = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (ll_draws, p),
                                                     dtype=f64))
        if q:
            out["is_kap"] = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 2),
                                                         (ll_draws, k_max, q), dtype=f64))
    return out


CASES = {
    # name: (JAX population, theta0, fit keywords, n_sub, k_max, q)
    "plain": (lambda: _population(n=6, seed=2)[0], [0.3, 10.0], {}, 6, 1, 0),
    "covariate_iov": (lambda: covariate_population(n=6), [0.3, 10.0],
                      dict(covariate_effects=[(1, "wt", "power", 70.0)], iov=[0],
                           omega_iov0=0.2), 6, 2, 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fit_on_the_jax_draws_matches_jax(name):
    build, theta0, kw, n_sub, k_max, q = CASES[name]
    jd = build()
    want = jax_fit_saem(_model(pst), jd, _prop(pst), theta0, **RUN, **kw)
    draws = jax_draws(RUN["seed"], RUN["n_burn"] + RUN["n_iters"], RUN["mh_steps"], n_sub, 2,
                      k_max, q, RUN["ll_draws"])
    got = fit_saem(_model(pt), convert.data_from_reference(jd), _prop(pt), theta0,
                   _draws=draws, **RUN, **kw)
    assert len(got.ll_trace) == 10 and np.all(np.isfinite(want.ll_trace))
    np.testing.assert_allclose(got.ll_trace, want.ll_trace, rtol=RTOL)
    for field in ("theta", "omega", "individual_parameters", "log_likelihood", "accept_rate"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=RTOL,
                                   err_msg=field)
    np.testing.assert_allclose(got.residual_models.get(0).b, want.residual_models.get(0).b,
                               rtol=RTOL)
    if q:
        for field in ("beta", "omega_iov", "kappa"):
            np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=RTOL,
                                       atol=1e-14, err_msg=field)
        assert got.iov_parameters == want.iov_parameters == (0,)
        assert got.covariate_labels == want.covariate_labels
    assert got.n_free == want.n_free and got.n_obs == want.n_obs
    assert "typical" in got.summary()


def test_own_draws_are_reproducible():
    """Without ``_draws`` the port draws from CPU generators seeded with
    ``seed``: one seed, one fit; another seed, another chain."""
    td = convert.data_from_reference(_population(n=4, seed=2)[0])
    kw = dict(n_burn=3, n_iters=3, mh_steps=2)
    a = fit_saem(_model(pt), td, _prop(pt), [0.3, 10.0], seed=4, **kw)
    b = fit_saem(_model(pt), td, _prop(pt), [0.3, 10.0], seed=4, **kw)
    c = fit_saem(_model(pt), td, _prop(pt), [0.3, 10.0], seed=5, **kw)
    np.testing.assert_array_equal(a.ll_trace, b.ll_trace)
    assert not np.array_equal(a.ll_trace, c.ll_trace)
    d = saem_draws(4, 6, 2, 4, 2, 1, 0, 0)
    assert d["phi_noise"].shape == (6, 2, 4, 2) and d["phi_unif"].shape == (6, 2, 4)
    intro = {}
    e = fit_saem(_model(pt), td, _prop(pt), [0.3, 10.0], _draws=d, _introspect=intro, **kw)
    np.testing.assert_array_equal(a.ll_trace, e.ll_trace)
    # the private hook: every Metropolis decision and the loop's seconds
    assert intro["accepted"].shape == (6, 2, 4) and intro["loop_s"] > 0.0


def test_validates_inputs():
    data = convert.data_from_reference(_population(n=4, seed=2)[0])
    m = _model(pt)
    with pytest.raises(PharmsolError, match="theta0 > 0"):
        fit_saem(m, data, _prop(pt), [-0.1, 10.0])
    with pytest.raises(PharmsolError, match="metadata"):
        fit_saem(m, data, _prop(pt), {"ke": 0.3, "v": 10.0})
    with pytest.raises(PharmsolError, match="at least 2"):
        fit_saem(m, pt.Data(list(data.subjects())[:1]), _prop(pt), [0.3, 10.0])
    with pytest.raises(PharmsolError, match="transform"):
        fit_saem(m, data, _prop(pt), [0.3, 10.0], transform="sqrt")
    with pytest.raises(PharmsolError, match="omega0"):
        fit_saem(m, data, _prop(pt), [0.3, 10.0], omega0=0.0)
    with pytest.raises(PharmsolError, match="residual error"):
        fit_saem(m, data, pt.ResidualErrorModels(), [0.3, 10.0])
    with pytest.raises(PharmsolError, match="'diagonal' or 'full'"):
        fit_saem(m, data, _prop(pt), [0.3, 10.0], omega="block")
    with pytest.raises(PharmsolError, match=">= 1"):
        fit_saem(m, data, _prop(pt), [0.3, 10.0], n_burn=0)


@pytest.mark.slow
def test_sde_at_zero_diffusion_matches_jax():
    """An SDE model's conditional likelihood predicts particle means; at zero
    diffusion every particle follows the ODE, so the two packages' fits on
    the same draws agree."""
    jd = _population(n=6, seed=2)[0]

    def sde(lib, stack):
        return lib.SDE(lambda x, p, t, rateiv, cov: stack([-p[0] * x[0]]),
                       lambda p, t, cov: stack([0.0 * p[0]]),
                       out=lambda x, p, t, cov: x[0:1] / p[1], nparticles=4, nstates=1,
                       ndrugs=1, nout=1)

    want = jax_fit_saem(sde(pst, jnp.stack), jd, _prop(pst), [0.3, 10.0], **RUN)
    draws = jax_draws(0, 10, 2, 6, 2, 1, 0, RUN["ll_draws"])
    got = fit_saem(sde(pt, torch.stack), convert.data_from_reference(jd), _prop(pt),
                   [0.3, 10.0], _draws=draws, **RUN)
    np.testing.assert_allclose(got.ll_trace, want.ll_trace, rtol=1e-9)
    np.testing.assert_allclose(got.theta, want.theta, rtol=1e-9)
    np.testing.assert_allclose(got.omega, want.omega, rtol=1e-9)
    np.testing.assert_allclose(got.log_likelihood, want.log_likelihood, rtol=1e-9)
