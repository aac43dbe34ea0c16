"""The port's likelihood profiles (``optimize/profile.py::llp``) against the
JAX package's (mirrors ``tests/test_profile.py``).

Float64 on the CPU:

- the input validation; the interval walk ``_crossing`` equals the JAX
  package's on drawn deviance traces;
- the pinned-coordinate refits: from the same warm start with the same
  masks and pinned values, the port's ``_vectorized_refits`` over
  ``neg_laplace_w_lanes`` against the same batched L-BFGS over the JAX
  package's ``neg_laplace`` (``test_torch_refits.py::
  jax_objective_refits``), the profile values within 1e-8 relative;
- ``llp`` itself at a small size: the deviance is 0 at the estimate, the
  catalogue takes typical values, omegas and sigmas, and an unknown name
  raises.

The JAX file's statistical check (profile against Wald bounds) needs a
converged fit, minutes here; it stays with the JAX file's ``slow`` tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import fit_laplace as jax_fit_laplace
from pharmsol_tpu.optimize.profile import _crossing as jax_crossing

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.optimize import fit_laplace, llp
from pharmsol_tpu_torch.optimize.bootstrap import _vectorized_refits
from pharmsol_tpu_torch.optimize.profile import _crossing

from test_profile import _population
from test_torch_refits import jax_objective_refits

THETA0 = [0.4, 8.0]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _model(lib):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _prop(lib):
    return lib.ResidualErrorModels().add(0, lib.ResidualErrorModel.proportional(0.06))


def test_llp_validation():
    data = convert.data_from_reference(_population(n=4, seed=2))
    with pytest.raises(PharmsolError, match="level"):
        llp(_model(pt), data, _prop(pt), THETA0, level=1.5)
    with pytest.raises(PharmsolError, match="n_grid"):
        llp(_model(pt), data, _prop(pt), THETA0, n_grid=1)
    with pytest.raises(PharmsolError, match="max_width"):
        llp(_model(pt), data, _prop(pt), THETA0, max_width=-1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crossing_matches_jax(seed):
    rng = np.random.default_rng(seed)
    vs = np.cumsum(rng.uniform(0.1, 0.5, 9))
    dev = np.concatenate([[0.0], np.cumsum(rng.uniform(0.0, 1.5, 8))])
    ok = rng.uniform(size=9) > 0.1
    ok[0] = True
    for target in (0.5, 3.84, 50.0):
        a, b = _crossing(vs, dev, ok, target), jax_crossing(vs, dev, ok, target)
        assert (np.isnan(a) and np.isnan(b)) or a == b


def test_pinned_refits_match_the_jax_objective():
    jd = _population(n=6, seed=5)
    intro, jintro = {}, {}
    jax_fit_laplace(_model(pst), jd, _prop(pst), THETA0, _introspect=jintro, _build_only=True,
                    inner_steps=12)
    fit_laplace(_model(pt), convert.data_from_reference(jd), _prop(pt), THETA0,
                _introspect=intro, _build_only=True, inner_steps=12)
    z0 = np.asarray(jintro["psi0"])
    dim = z0.size
    # ke pinned on either side, and sigma pinned above
    M = np.zeros((3, dim))
    M[0, 0] = M[1, 0] = M[2, dim - 1] = 1.0
    V = np.array([z0[0] - 0.2, z0[0] + 0.2, z0[-1] + 0.3])
    neg = jintro["neg_laplace"]
    jvg = jax.jit(jax.vmap(jax.value_and_grad(lambda z, m, v: neg(jnp.where(m > 0, v, z)))))
    _, _, jf = jax_objective_refits(jvg, np.broadcast_to(z0, (3, dim)), (M, V), 2)
    ones = torch.ones((3, 6), dtype=torch.float64)

    def obj(z, mv):
        m, v = mv
        return intro["neg_laplace_w_lanes"](torch.where(m > 0, v[:, None], z), ones)

    z, _, f = _vectorized_refits(obj, torch.tensor(z0), (torch.tensor(M), torch.tensor(V)), 2)
    np.testing.assert_allclose(f, jf, rtol=1e-8)
    assert np.all(np.isfinite(z))


def test_llp_small():
    data = convert.data_from_reference(_population(n=6, seed=5))
    kw = dict(n_grid=3, refit_iters=1, max_iters=3, inner_steps=12, compute_se=False)
    with pytest.raises(PharmsolError, match="unknown profile parameter"):
        llp(_model(pt), data, _prop(pt), THETA0, parameters=["nope"], device="cpu",
            **dict(kw, max_iters=1))
    res = llp(_model(pt), data, _prop(pt), THETA0, parameters=["p[0]", "sigma[0]"],
              device="cpu", **kw)
    for name, pp in res.parameters.items():
        assert pp.grid.shape == (7,) and pp.deviance.shape == (7,) and pp.ok.shape == (7,), name
        assert pp.deviance[3] == 0.0 and pp.grid[3] == pytest.approx(pp.estimate)
        assert np.all(np.diff(pp.grid) > 0)
    assert res.parameters["sigma[0]"].estimate > 0
    assert "Profile likelihood" in res.summary()
