"""The port's simulation diagnostics (``optimize/diagnostics.py``: VPC,
NPDE, GOF) against the JAX package's (mirrors ``tests/test_diagnostics.py``
and the VPC/NPDE part of ``tests/test_iov.py``).

The port draws from a CPU ``torch.Generator`` seeded with ``seed``; the JAX
package from ``jax.random.PRNGKey(seed)``. Parity runs on the JAX package's
own draws, rebuilt here with ``jax.random`` in its key order
(:func:`jax_replicate_draws`) and handed to the port's private ``_draws``
hook. Float64 on the CPU:

- the replicate simulations within 1e-12 relative (plus 1e-12 absolute):
  parametric (diagonal and full omega), nonparametric (support indices),
  occasion-level kappas (IOV) and typical-value covariate shifts;
- ``vpc`` percentiles and bands, ``npde`` values and moments within 1e-10;
- ``gof`` (no draws: PRED, IPRED, IWRES, CWRES, eta and the shrinkages,
  parametric and nonparametric) within 1e-10;
- on the port's own draws, the JAX file's statistical oracles (coverage
  under the true population, misfit flagged under a wrong one, npde
  moments) and its input validation.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import gof as jax_gof
from pharmsol_tpu.optimize import npde as jax_npde
from pharmsol_tpu.optimize import vpc as jax_vpc
from pharmsol_tpu.optimize.diagnostics import _simulate as jax_simulate

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.optimize import gof, npde, vpc
from pharmsol_tpu_torch.optimize.diagnostics import _simulate

from test_covariate_effects import _population as _cov_population
from test_diagnostics import KE, OMEGA, V, _population, _truth
from test_iov import _population as _iov_population

TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _model(lib):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _prop(lib, b=0.08):
    return lib.ResidualErrorModels().add(0, lib.ResidualErrorModel.proportional(b))


def jax_replicate_draws(population, n_rep, n_sub, obs_shape, seed, rep_chunk, k_max=1):
    """The JAX package's draws for ``_simulate`` (``diagnostics.py``'s key
    order: one split into the population draw and the noise; per chunk a
    ``fold_in`` of the chunk start, one key per replicate, split first for
    the replicate's kappas), in the port's ``_draws`` layout."""
    key_draw, key_noise = jax.random.split(jax.random.PRNGKey(seed))
    out = {}
    support = getattr(population, "support", None)
    if support is not None:
        w = np.asarray(population.weights, dtype=np.float64)
        logw = jnp.asarray(np.log(np.maximum(w, 1e-300)))
        out["idx"] = np.asarray(jax.random.categorical(key_draw, logw, shape=(n_rep, n_sub)))
        p = np.asarray(support).shape[1]
    else:
        p = len(population.theta)
        out["z"] = np.asarray(jax.random.normal(key_draw, (n_rep, n_sub, p), dtype=jnp.float64))
    om_iov = getattr(population, "omega_iov", None)
    q = 0 if om_iov is None else len(population.iov_parameters)
    chunk = int(min(max(rep_chunk, 1), n_rep))
    kaps, eps = [], []
    for start in range(0, n_rep, chunk):
        n = min(chunk, n_rep - start)
        # one key per row of the chunk the JAX program runs: a short tail is
        # padded with its own head, up to a whole chunk
        keys = jax.random.split(jax.random.fold_in(key_noise, start), n + min(chunk - n, n))
        for i in range(n):
            k = keys[i]
            if q:
                kk, k = jax.random.split(k)
                kaps.append(np.asarray(jax.random.normal(kk, (n_sub, k_max, q),
                                                         dtype=jnp.float64)))
            eps.append(np.asarray(jax.random.normal(k, tuple(obs_shape), dtype=jnp.float64)))
    if q:
        out["kap"] = np.stack(kaps)
    out["eps"] = np.stack(eps)
    import torch

    return {k: torch.as_tensor(np.array(v)) for k, v in out.items()}


def port_draws(jd, population, n_rep, seed, rep_chunk, rems=None):
    """The JAX draws for the port's ``_draws`` hook on the data ``jd``."""
    from pharmsol_tpu_torch.optimize._condll import build_cond_ll

    cond = build_cond_ll(_model(pt), convert.data_from_reference(jd), rems or _prop(pt),
                         device="cpu")
    return jax_replicate_draws(population, n_rep, cond.n_sub, tuple(cond.obs_value.shape),
                               seed, rep_chunk, int(cond.n_occ_max))


def _pops():
    full = SimpleNamespace(theta=np.asarray([KE, V]), omega=np.asarray(OMEGA),
                           omega_cov=np.array([[0.09, 0.02], [0.02, 0.0225]]),
                           transform=("log", "log"))
    nonpar = SimpleNamespace(support=np.asarray([[KE * 0.8, V], [KE * 1.25, V * 1.1]]),
                             weights=np.asarray([0.35, 0.65]))
    return {"diagonal": _truth(), "full": full, "nonparametric": nonpar}


@pytest.mark.parametrize("which", ["diagonal", "full", "nonparametric"])
def test_simulations_on_jax_draws_match(which):
    jd = _population(n=6)
    pop = _pops()[which]
    n_rep, chunk = 7, 5  # a tail chunk padded by less than its own length
    _, want = jax_simulate(_model(pst), jd, _prop(pst), pop, n_rep, 4, True, chunk)
    _, got = _simulate(_model(pt), convert.data_from_reference(jd), _prop(pt), pop, n_rep, 4,
                       True, chunk, "cpu", port_draws(jd, pop, n_rep, 4, chunk))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_iov_and_covariate_shift_simulations_match():
    """Occasion-level kappas on the transformed scale per occasion row, and
    the typical-value covariate shift of each subject."""
    jd, _ = _iov_population(n_sub=4, n_occ=3, seed=7)
    rems = (pst.ResidualErrorModels().add(0, pst.ResidualErrorModel.proportional(0.05)),
            pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.proportional(0.05)))
    iov = SimpleNamespace(theta=np.asarray([KE, V]), omega=np.asarray([0.15, 0.1]),
                          omega_cov=None, transform=("log", "log"),
                          omega_iov=np.asarray([0.3]), iov_parameters=(0,))
    _, want = jax_simulate(_model(pst), jd, rems[0], iov, 3, 1, True, 2)
    _, got = _simulate(_model(pt), convert.data_from_reference(jd), rems[1], iov, 3, 1, True, 2,
                       "cpu", port_draws(jd, iov, 3, 1, 2, rems[1]))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    cd, _ = _cov_population(n=6, seed=3, beta_true=0.75)
    cov = SimpleNamespace(theta=np.asarray([KE, V]), omega=np.asarray([0.12, 0.15]),
                          omega_cov=None, transform=("log", "log"), beta=np.asarray([0.75]),
                          covariate_effects=((0, "wt", "power", 70.0),))
    _, want = jax_simulate(_model(pst), cd, _prop(pst, 0.06), cov, 3, 2, True, 3)
    _, got = _simulate(_model(pt), convert.data_from_reference(cd), _prop(pt, 0.06), cov, 3, 2,
                       True, 3, "cpu", port_draws(cd, cov, 3, 2, 3))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _same_tuple(got, want):
    for a, b in zip(got, want):
        if isinstance(b, (float, int, np.floating, np.ndarray)) and not isinstance(b, bool):
            np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                                       **TOL)
        else:
            assert a == b


@pytest.mark.parametrize("which", ["diagonal", "nonparametric"])
def test_vpc_and_npde_on_jax_draws_match(which):
    jd = _population(n=8)
    pop = _pops()[which]
    data = convert.data_from_reference(jd)
    want = jax_vpc(_model(pst), jd, _prop(pst), pop, n_rep=40, seed=3, rep_chunk=16)
    got = vpc(_model(pt), data, _prop(pt), pop, n_rep=40, seed=3, rep_chunk=16,
              _draws=port_draws(jd, pop, 40, 3, 16))
    _same_tuple(got, want)
    assert got.summary() == want.summary()
    want = jax_npde(_model(pst), jd, _prop(pst), pop, n_rep=120, seed=5, rep_chunk=64)
    got = npde(_model(pt), data, _prop(pt), pop, n_rep=120, seed=5, rep_chunk=64,
               _draws=port_draws(jd, pop, 120, 5, 64))
    _same_tuple(got, want)


def test_iov_vpc_and_npde_on_jax_draws_match():
    """``test_iov.py::test_vpc_npde_draw_kappa``'s diagnostics of an IOV fit
    (its population, the fit's estimates given)."""
    jd, _ = _iov_population(n_sub=5, n_occ=3, seed=7)
    rems = (pst.ResidualErrorModels().add(0, pst.ResidualErrorModel.proportional(0.05)),
            pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.proportional(0.05)))
    fit = SimpleNamespace(theta=np.asarray([0.26, 9.8]), omega=np.asarray([0.14, 0.05]),
                          omega_cov=None, transform=("log", "log"),
                          omega_iov=np.asarray([0.28]), iov_parameters=(0,))
    data = convert.data_from_reference(jd)
    want = jax_vpc(_model(pst), jd, rems[0], fit, n_rep=30, seed=1, rep_chunk=16)
    got = vpc(_model(pt), data, rems[1], fit, n_rep=30, seed=1, rep_chunk=16,
              _draws=port_draws(jd, fit, 30, 1, 16, rems[1]))
    _same_tuple(got, want)
    want = jax_npde(_model(pst), jd, rems[0], fit, n_rep=100, seed=1, rep_chunk=64)
    got = npde(_model(pt), data, rems[1], fit, n_rep=100, seed=1, rep_chunk=64,
               _draws=port_draws(jd, fit, 100, 1, 64, rems[1]))
    _same_tuple(got, want)


def _fit_like(which, jd, p=2):
    """A fit result's surface for ``gof``: estimates, individual parameters
    and (nonparametric) posterior means."""
    rng = np.random.default_rng(1)
    n = len(jd.subjects())
    if which == "nonparametric":
        pop = _pops()["nonparametric"]
        means = np.asarray(pop.support).mean(axis=0) * np.exp(0.1 * rng.standard_normal((n, p)))
        return SimpleNamespace(support=pop.support, weights=pop.weights,
                               individual_posterior_means=lambda: means)
    indiv = np.asarray([KE, V]) * np.exp(0.2 * rng.standard_normal((n, p)))
    base = dict(theta=np.asarray([KE, V]), omega=np.asarray(OMEGA), omega_cov=None,
                transform=("log", "log"), individual_parameters=indiv, parameter_names=None)
    if which == "covariate":
        base.update(beta=np.asarray([0.75]), covariate_effects=((0, "wt", "power", 70.0),))
    return SimpleNamespace(**base)


@pytest.mark.parametrize("which", ["parametric", "covariate", "nonparametric"])
def test_gof_matches_jax(which):
    jd = _cov_population(n=6, seed=5)[0] if which == "covariate" else _population(n=6)
    fit = _fit_like(which, jd)
    want = jax_gof(_model(pst), jd, _prop(pst, 0.2), fit)
    got = gof(_model(pt), convert.data_from_reference(jd), _prop(pt, 0.2), fit)
    _same_tuple(got, want)
    assert got.summary() == want.summary()


# -- the JAX file's oracles on the port's own draws -----------------------------------


def test_vpc_correct_model_covers():
    data = convert.data_from_reference(_population())
    res = vpc(_model(pt), data, _prop(pt), _truth(), n_rep=300, seed=1)
    assert len(res.bin_times) == 5
    assert int(res.n_obs.sum()) == 24 * 5
    assert res.observed.shape == (3, 5)
    assert res.coverage() >= 0.7, res.summary()
    rel = np.abs(res.predicted[1] / res.observed[1] - 1)
    assert np.all(rel < 0.35), res.summary()
    assert np.all(res.pi_low <= res.pi_high)
    assert "VPC" in res.summary()


def test_vpc_wrong_model_flags_misfit():
    data = convert.data_from_reference(_population())
    wrong = SimpleNamespace(theta=np.asarray([3.0 * KE, V]), omega=np.asarray(OMEGA),
                            omega_cov=None, transform=("log", "log"))
    assert vpc(_model(pt), data, _prop(pt), wrong, n_rep=300, seed=1).coverage() < 0.5


def test_vpc_nonparametric_population_runs():
    data = convert.data_from_reference(_population(n=12))
    res = vpc(_model(pt), data, _prop(pt), _pops()["nonparametric"], n_rep=200, seed=0, bins=3)
    assert np.all(res.n_obs > 0) and np.isfinite(res.predicted).all()


def test_npde_correct_model_is_standard_normal():
    data = convert.data_from_reference(_population())
    res = npde(_model(pt), data, _prop(pt), _truth(), n_rep=1000, seed=2)
    assert len(res.npde) == 24 * 5 and len(res.subject_ids) == len(res.npde)
    assert abs(res.z_mean) < 3.0, res.summary()
    assert abs(res.z_var) < 3.5, res.summary()
    assert "NPDE" in res.summary()


def test_npde_wrong_model_rejects():
    data = convert.data_from_reference(_population())
    wrong = SimpleNamespace(theta=np.asarray([2.0 * KE, V]), omega=np.asarray(OMEGA),
                            omega_cov=None, transform=("log", "log"))
    res = npde(_model(pt), data, _prop(pt), wrong, n_rep=500, seed=2)
    assert abs(res.z_mean) > 4.0, res.summary()


def test_diagnostics_validation():
    data = convert.data_from_reference(_population(n=4))
    m, r = _model(pt), _prop(pt)
    with pytest.raises(PharmsolError, match="n_rep"):
        vpc(m, data, r, _truth(), n_rep=5)
    with pytest.raises(PharmsolError, match="ci"):
        vpc(m, data, r, _truth(), ci=1.5)
    with pytest.raises(PharmsolError, match="outeq"):
        vpc(m, data, r, _truth(), outeq=3, n_rep=20)
    with pytest.raises(PharmsolError, match="n_rep"):
        npde(m, data, r, _truth(), n_rep=10)
    with pytest.raises(PharmsolError, match="population"):
        vpc(m, data, r, object(), n_rep=20)
    with pytest.raises(PharmsolError, match="fit result"):
        gof(m, data, r, SimpleNamespace(theta=None, support=None))
    bad = SimpleNamespace(theta=np.asarray([KE, V]), omega=np.asarray([0.12, 0.15]),
                          omega_cov=None, transform=("log", "log"), beta=np.asarray([0.75]),
                          covariate_effects=None)
    with pytest.raises(PharmsolError, match="covariate_effects"):
        npde(m, data, r, bad, n_rep=100, seed=1)
