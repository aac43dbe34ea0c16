"""The port's stepwise covariate search (``optimize/scm.py``) against the
JAX package's (mirrors ``tests/test_scm.py``).

Float64 on the CPU:

- ``_lrt_pvalue_1dof`` equals the JAX package's, and matches the published
  chi-square quantiles; the input validation;
- the vectorized candidate screen: for every candidate effect set, from the
  same warm start with the same covariate designs, the port's
  ``_vectorized_candidate_lls`` (the lanes of ``neg_laplace_wxy_lanes``)
  against the same batched L-BFGS over the JAX package's
  ``neg_laplace_wxy`` (``test_torch_refits.py::jax_objective_refits``):
  log-likelihoods within 1e-8 relative;
- ``scm`` itself at a small size (few outer iterations): every accepted
  step's LRT is twice its fits' log-likelihood difference, and every
  candidate was screened.

The JAX file's statistical checks (the real effect kept, the noise one
dropped) need converged fits, minutes each here; they stay with the JAX
file's ``slow`` tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import fit_laplace as jax_fit_laplace
from pharmsol_tpu.optimize._coveffects import resolve_covariate_effects as jax_resolve
from pharmsol_tpu.optimize.scm import _lrt_pvalue_1dof as jax_lrt_pvalue

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.optimize import scm
from pharmsol_tpu_torch.optimize.scm import _lrt_pvalue_1dof, _vectorized_candidate_lls

from test_scm import _population
from test_torch_refits import jax_objective_refits

THETA0 = [0.3, 9.0]
CANDS = [(0, "wt", "power", 70.0), (0, "junk", "power", 1.0)]
KW = dict(inner_steps=12, compute_se=False)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _model(lib):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _prop(lib, b=0.2):
    return lib.ResidualErrorModels().add(0, lib.ResidualErrorModel.proportional(b))


def test_lrt_pvalue_1dof():
    assert _lrt_pvalue_1dof(3.841) == pytest.approx(0.05, abs=2e-4)
    assert _lrt_pvalue_1dof(6.635) == pytest.approx(0.01, abs=2e-4)
    assert _lrt_pvalue_1dof(0.0) == 1.0
    assert _lrt_pvalue_1dof(float("nan")) == 1.0
    assert _lrt_pvalue_1dof(-3.0) == 1.0
    for v in (0.1, 1.0, 2.7, 3.841, 10.0, 30.0):
        assert _lrt_pvalue_1dof(v) == jax_lrt_pvalue(v)


def test_scm_validation():
    data = convert.data_from_reference(_population(n=4, seed=2))
    m, r = _model(pt), _prop(pt)
    with pytest.raises(PharmsolError, match="at least one candidate"):
        scm(m, data, r, THETA0, [])
    with pytest.raises(PharmsolError, match="duplicate"):
        scm(m, data, r, THETA0, [(0, "wt", "power"), (0, "wt", "power")])
    with pytest.raises(PharmsolError, match="alphas"):
        scm(m, data, r, THETA0, [(0, "wt", "power")], forward_alpha=1.5)
    with pytest.raises(PharmsolError, match="on_error"):
        scm(m, data, r, THETA0, [(0, "wt", "power")], on_error="bogus")
    with pytest.raises(PharmsolError, match="refit_iters"):
        scm(m, data, r, THETA0, [(0, "wt", "power")], refit_iters=0)


def test_candidate_screen_matches_the_jax_objective():
    jd = _population(n=6, seed=4)
    intro = {}
    jax_fit_laplace(_model(pst), jd, _prop(pst), THETA0, covariate_effects=[CANDS[0]],
                    _introspect=intro, _build_only=True, inner_steps=12)
    ones = jnp.ones((6,))
    jvg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda z, x, o: intro["neg_laplace_wxy"](z, ones, None, x, o))))
    designs = [jax_resolve([c], list(jd.subjects()), 2, None) for c in CANDS]
    X = np.stack([np.asarray(d.x) for d in designs])
    O = np.stack([np.asarray(d.onehot) for d in designs])
    z0 = np.asarray(intro["psi0"])
    _, _, jf = jax_objective_refits(jvg, np.broadcast_to(z0, (2, z0.size)), (X, O), 2)
    data = convert.data_from_reference(jd)
    lls, ok = _vectorized_candidate_lls(_model(pt), data, _prop(pt), THETA0,
                                        [[c] for c in CANDS], z0, dict(inner_steps=12), 2,
                                        list(data.subjects()), 2, None, "skip", "cpu")
    assert ok.all()
    np.testing.assert_allclose(lls, -jf, rtol=1e-8)


def test_scm_step_bookkeeping():
    """One candidate, a few outer iterations a fit: the base fit, the
    screen, the confirming fit; the backward phase reuses the cached base
    fit."""
    data = convert.data_from_reference(_population(n=6, seed=11))
    res = scm(_model(pt), data, _prop(pt), THETA0, CANDS[:1], forward_alpha=0.9999,
              refit_iters=1, max_iters=3, device="cpu", **KW)
    assert {t["effect"] for t in res.trials if t.get("screened")} == {CANDS[0]}
    prev = res.base_log_likelihood
    for s in res.steps:
        sign = 1.0 if s.action == "add" else -1.0
        assert s.lrt == pytest.approx(sign * 2.0 * (s.log_likelihood - prev), abs=1e-9)
        assert s.p_value == _lrt_pvalue_1dof(s.lrt)
        prev = s.log_likelihood
    assert res.final.log_likelihood == prev and 1 <= res.n_fits <= 2
    assert "SCM" in res.summary()
