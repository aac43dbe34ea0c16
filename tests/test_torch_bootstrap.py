"""The port's case bootstrap (``optimize/bootstrap.py``) against the JAX
package's (mirrors ``tests/test_bootstrap.py``).

Float64 on the CPU:

- the generic ``bootstrap`` around a stub fitter: the JAX file's checks,
  and the replicate samples equal the JAX package's exactly (both draw from
  numpy's ``default_rng(seed)``);
- the vectorized refit of ``bootstrap_laplace``: from the same warm start
  (psi0) with the same weight operands (the JAX package's own draws), the
  port's ``_vectorized_refits`` over its batched objective
  (``neg_laplace_w_lanes``) against the same batched L-BFGS over the JAX
  package's ``neg_laplace_w`` (``test_torch_refits.py::
  jax_objective_refits``; the optimizer is held against the JAX program
  there): ``Z`` and the final values within 1e-8 relative;
- ``bootstrap_laplace`` itself at a small size: its samples are the decoded
  refits of its own full fit's optimum under those weights.

A full JAX fit takes minutes here, so no JAX ``bootstrap_laplace`` runs in
the gate.
"""


import jax
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import bootstrap as jax_bootstrap
from pharmsol_tpu.optimize import fit_laplace as jax_fit_laplace

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.optimize import bootstrap, bootstrap_laplace, fit_laplace
from pharmsol_tpu_torch.optimize.bootstrap import _decode_psi_samples, _vectorized_refits

from test_bootstrap import _population
from test_torch_refits import jax_objective_refits

THETA0 = [0.4, 8.0]
N_SUB, N_BOOT, STEPS = 6, 4, 3
# eight inner Newton steps instead of 25: the same objective on both sides
INNER = 8


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


class _StubResult:
    def __init__(self, theta, names=None):
        self.theta = np.asarray(theta, dtype=np.float64)
        self.parameter_names = names


def _toy_data(lib, n=10):
    subjects = []
    for i in range(n):
        sb = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        sb = sb.observation(1.0, float(i), 0)
        subjects.append(sb.build())
    return lib.Data(subjects)


def _id_mean_fit(data):
    ids = [float(s.id[1:]) for s in data.subjects()]
    return _StubResult([np.mean(ids)], names=("mu",))


def test_bootstrap_mechanics_deterministic_stub():
    data = _toy_data(pt, 12)
    res = bootstrap(data, _id_mean_fit, n_boot=64, seed=1)
    assert res.n_requested == 64 and res.n_failed == 0
    assert res.samples["theta"].shape == (64, 1)
    assert res.parameter_names == ("mu",)
    assert res.estimate["theta"][0] == pytest.approx(np.mean(range(12)))
    se = res.se()["theta"][0]
    expect = np.std(np.arange(12.0)) / np.sqrt(12.0)
    assert 0.5 * expect < se < 2.0 * expect
    lo, hi = res.ci()["theta"]
    assert lo[0] < res.estimate["theta"][0] < hi[0]
    assert "mu" in res.summary()
    assert abs(res.bias()["theta"][0]) < 3.0 * se
    want = jax_bootstrap(_toy_data(pst, 12), _id_mean_fit, n_boot=64, seed=1)
    np.testing.assert_array_equal(res.samples["theta"], want.samples["theta"])
    assert res.summary() == want.summary()


def test_bootstrap_same_seed_reproduces():
    data = _toy_data(pt, 8)
    a = bootstrap(data, _id_mean_fit, n_boot=16, seed=7)
    b = bootstrap(data, _id_mean_fit, n_boot=16, seed=7)
    np.testing.assert_array_equal(a.samples["theta"], b.samples["theta"])
    c = bootstrap(data, _id_mean_fit, n_boot=16, seed=8)
    assert not np.array_equal(a.samples["theta"], c.samples["theta"])


def test_bootstrap_stratified_preserves_stratum_sizes():
    def per_stratum_counts(d):
        ids = [int(s.id[1:]) for s in d.subjects()]
        return _StubResult([sum(1 for i in ids if i % 2 == 0), sum(1 for i in ids if i % 2 == 1)])

    kw = dict(n_boot=16, seed=3, stratify=lambda s: int(s.id[1:]) % 2)
    res = bootstrap(_toy_data(pt, 10), per_stratum_counts, **kw)
    np.testing.assert_array_equal(res.samples["theta"], np.full((16, 2), 5.0))
    ids = bootstrap(_toy_data(pt, 10), _id_mean_fit, **kw)
    want = jax_bootstrap(_toy_data(pst, 10), _id_mean_fit, **kw)
    np.testing.assert_array_equal(ids.samples["theta"], want.samples["theta"])


def test_bootstrap_skips_failed_replicates():
    data = _toy_data(pt, 6)
    calls = {"n": 0}

    def flaky(d):
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            raise RuntimeError("refit blew up")
        return _id_mean_fit(d)

    res = bootstrap(data, flaky, n_boot=12, seed=0, include_full=False)
    assert res.n_failed == 4
    assert res.samples["theta"].shape[0] == 8
    with pytest.raises(RuntimeError):
        bootstrap(data, flaky, n_boot=12, seed=0, on_error="raise", include_full=False)


def test_bootstrap_validation_errors():
    data = _toy_data(pt, 4)
    with pytest.raises(PharmsolError):
        bootstrap(data, _id_mean_fit, n_boot=1)
    with pytest.raises(PharmsolError):
        bootstrap(pt.Data([data.subjects()[0]]), _id_mean_fit, n_boot=8)
    with pytest.raises(PharmsolError):
        bootstrap(data, _id_mean_fit, n_boot=8, on_error="explode")
    with pytest.raises(PharmsolError):
        bootstrap(data, lambda d: object(), n_boot=8)
    with pytest.raises(PharmsolError, match="n_boot"):
        bootstrap_laplace(_model(pt), data, _prop(pt), THETA0, n_boot=1)
    with pytest.raises(PharmsolError, match="refit_iters"):
        bootstrap_laplace(_model(pt), data, _prop(pt), THETA0, refit_iters=0)


# -- the vectorized Laplace refits ------------------------------------------------


def _model(lib):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _prop(lib):
    return lib.ResidualErrorModels().add(0, lib.ResidualErrorModel.proportional(0.2))


def _weights(seed, n_boot, n):
    """``bootstrap_laplace``'s weight draws (the JAX package's code)."""
    rng = np.random.default_rng(seed)
    draws = rng.integers(0, n, size=(n_boot, n))
    return np.stack([np.bincount(row, minlength=n) for row in draws]).astype(np.float64)


@pytest.fixture(scope="module")
def jax_side():
    jd = _population(n=N_SUB)
    intro = {}
    jax_fit_laplace(_model(pst), jd, _prop(pst), THETA0, _introspect=intro, _build_only=True,
                    inner_steps=INNER)
    jvg = jax.jit(jax.vmap(jax.value_and_grad(intro["neg_laplace_w"])))
    return jd, intro, jvg


def test_refits_match_the_jax_objective(jax_side):
    jd, jintro, jvg = jax_side
    intro = {}
    fit_laplace(_model(pt), convert.data_from_reference(jd), _prop(pt), THETA0,
                _introspect=intro, _build_only=True, inner_steps=INNER)
    psi0 = np.asarray(jintro["psi0"])
    np.testing.assert_array_equal(intro["psi0"].numpy(), psi0)
    W = _weights(2, N_BOOT, N_SUB)
    z, g, f = _vectorized_refits(intro["neg_laplace_w_lanes"], torch.tensor(psi0),
                                 torch.tensor(W), STEPS)
    jz, jg, jf = jax_objective_refits(jvg, np.broadcast_to(psi0, (N_BOOT, psi0.size)), (W,),
                                      STEPS)
    assert np.all(np.isfinite(jz)) and np.all(np.abs(jz - psi0) > 0)
    np.testing.assert_allclose(z, jz, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(f, jf, rtol=1e-8)
    np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-8)


def test_bootstrap_laplace_samples_are_its_decoded_refits(jax_side):
    jd, _, _ = jax_side
    data = convert.data_from_reference(jd)
    res = bootstrap_laplace(_model(pt), data, _prop(pt), THETA0, n_boot=N_BOOT, seed=2,
                            refit_iters=2, max_iters=4, compute_se=False, inner_steps=INNER,
                            device="cpu")
    assert res.n_requested == N_BOOT and res.n_failed == 0
    assert res.samples["theta"].shape == (N_BOOT, 2) and res.samples["omega"].shape == (N_BOOT, 2)
    np.testing.assert_allclose(res.estimate["theta"], res.full.theta)
    intro = {}
    fit_laplace(_model(pt), data, _prop(pt), THETA0, _introspect=intro, _build_only=True,
                inner_steps=INNER)
    # the full fit's optimum: log theta, log omega, log sigma
    full = res.full
    z_opt = np.log(np.concatenate([full.theta, full.omega, [full.residual_models.get(0).b]]))
    z, _, _ = _vectorized_refits(intro["neg_laplace_w_lanes"], torch.tensor(z_opt),
                                 torch.tensor(_weights(2, N_BOOT, N_SUB)), 2)
    want = _decode_psi_samples(z, intro["layout"])
    for k in ("theta", "omega"):
        np.testing.assert_allclose(res.samples[k], want[k], rtol=1e-9)
    assert "theta" in res.summary()
