"""The port's simulation–re-estimation (``optimize/sse.py``) against the
JAX package's (mirrors ``tests/test_sse.py``, with its covariate-shift
replicate path).

Float64 on the CPU:

- the replicate walk (``_replicate_subjects``) round-trips the original
  values and lowers to the same observation grid; the input validation;
- ``sse``'s replicates are the port's simulations, one dataset each (a stub
  fitter reads them back exactly);
- the replicate simulations of ``sse_laplace`` on the JAX package's draws
  (``test_torch_diagnostics.py::jax_replicate_draws``), with and without a
  fitted covariate effect, within 1e-12 relative;
- the vectorized refit: from the same warm start (psi0) with the same
  simulated observations, the port's ``_vectorized_refits`` over
  ``neg_laplace_wy_lanes`` against the same batched L-BFGS over the JAX
  package's ``neg_laplace_wy`` (``test_torch_refits.py::
  jax_objective_refits``), ``Z`` and the final values within 1e-8
  relative (with a covariate effect, the simulations; the design
  operand's refits are held in ``test_torch_scm.py``);
- ``sse_laplace`` itself at a small size: its samples are the decoded
  refits of its own full optimum over its own simulations.
"""

import math
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import fit_laplace as jax_fit_laplace
from pharmsol_tpu.optimize.diagnostics import _simulate as jax_simulate

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.data.event import Censor
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.optimize import fit_laplace, sse, sse_laplace
from pharmsol_tpu_torch.optimize._condll import build_cond_ll
from pharmsol_tpu_torch.optimize.bootstrap import _decode_psi_samples, _vectorized_refits
from pharmsol_tpu_torch.optimize.diagnostics import _simulate
from pharmsol_tpu_torch.optimize.sse import _replicate_subjects

from test_covariate_effects import _population as _cov_population
from test_laplace import _population as _lap_population
from test_torch_diagnostics import port_draws
from test_torch_refits import jax_objective_refits

TRUE = np.array([1.2, 0.25, 12.0])
THETA0 = [0.4, 8.0]
_Pop = namedtuple("_Pop", ["theta", "omega", "transform"])


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _conc(t):
    ka, ke, v = TRUE
    return 100.0 * ka / (ka - ke) * (math.exp(-ke * t) - math.exp(-ka * t)) / v


def _design(n=10):
    subjects = []
    for i in range(n):
        b = pt.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t in (0.5, 1.0, 2.0, 4.0, 8.0, 12.0):
            b = b.observation(float(t), _conc(t), 0)
        subjects.append(b.build())
    return pt.Data(subjects)


def _oral():
    return pt.Analytical(pt.one_compartment_with_absorption,
                         out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)


def _model(lib):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _prop(lib, b=0.1):
    return lib.ResidualErrorModels().add(0, lib.ResidualErrorModel.proportional(b))


def test_replicate_walk_round_trips_original_values():
    s1 = (pt.Subject.builder("a").bolus(0.0, 50.0, 0)
          .observation(1.0, 3.5, 0).observation(2.0, 2.5, 0)
          .missing_observation(3.0, 0)
          .reset().infusion(0.0, 80.0, 0, 2.0)
          .observation(1.0, 4.5, 0).observation(4.0, 1.5, 0)
          .build())
    s2 = (pt.Subject.builder("b").bolus(0.0, 100.0, 0)
          .observation(0.5, 7.0, 0).observation(6.0, 0.7, 0)
          .build())
    data = pt.Data([s1, s2])
    rems = _prop(pt)
    cond = build_cond_ll(_oral(), data, rems)
    rebuilt = _replicate_subjects(cond.subjects, cond.obs_value.numpy(), cond.active.numpy())
    got = [(s.id, occ.index, e.time, e.value) for s in rebuilt for occ in s.occasions()
           for e in occ.observations()]
    want = [(s.id, occ.index, e.time, e.value) for s in data.subjects()
            for occ in s.occasions() for e in occ.observations()]
    assert got == want
    cond2 = build_cond_ll(_oral(), pt.Data(rebuilt), rems)
    np.testing.assert_array_equal(cond2.obs_value.numpy(), cond.obs_value.numpy())
    np.testing.assert_array_equal(cond2.active.numpy(), cond.active.numpy())


def test_sse_rejects_censored_and_bad_args():
    s = (pt.Subject.builder("c").bolus(0.0, 50.0, 0)
         .censored_observation(1.0, 0.1, 0, Censor.BLOQ)
         .observation(2.0, 1.0, 0).build())
    pop = _Pop(theta=TRUE, omega=np.array([0.1] * 3), transform=("log", "log", "log"))
    with pytest.raises(PharmsolError, match="censored"):
        sse(_oral(), pt.Data([s]), _prop(pt), pop, lambda d: None, n_sim=2)
    with pytest.raises(PharmsolError, match="n_sim"):
        sse(_oral(), _design(2), _prop(pt), pop, lambda d: None, n_sim=1)
    with pytest.raises(PharmsolError, match="on_error"):
        sse(_oral(), _design(2), _prop(pt), pop, lambda d: None, n_sim=2, on_error="bogus")
    with pytest.raises(PharmsolError, match="n_sim"):
        sse_laplace(_model(pt), _design(2), _prop(pt), THETA0, n_sim=1)
    with pytest.raises(PharmsolError, match="refit_iters"):
        sse_laplace(_model(pt), _design(2), _prop(pt), THETA0, refit_iters=0)


def test_sse_refits_each_simulated_dataset():
    """A stub fitter reads each replicate back: its estimate is the mean of
    the replicate's values, which are the port's simulations of that seed."""
    data = _design(4)
    pop = _Pop(theta=TRUE, omega=np.array([0.1] * 3), transform=("log", "log", "log"))

    class Stub:
        def __init__(self, d):
            vals = [e.value for s in d.subjects() for o in s.occasions()
                    for e in o.observations()]
            self.theta = np.array([np.mean(vals)])
            self.standard_errors = np.array([1.0])

    r = sse(_oral(), data, _prop(pt, 0.03), pop, Stub, n_sim=5, seed=3)
    cond, sims = _simulate(_oral(), data, _prop(pt, 0.03), pop, 5, 3, True, 32)
    act = cond.active.numpy()
    np.testing.assert_allclose(r.samples["theta"][:, 0], [s[act].mean() for s in sims],
                               rtol=1e-14)
    assert r.n_ok == 5 and r.ses.shape == (5, 1) and r.n_failed == 0


# twelve inner Newton steps instead of 25: the same objective on both sides,
# at half the cost
CASES = {"plain": dict(inner_steps=12),
         "covariate": dict(inner_steps=12, covariate_effects=[(0, "wt", "power", 70.0)])}


def _case_data(case):
    if case == "covariate":
        return _cov_population(n=6, seed=7, beta_true=0.75)[0]
    return _lap_population(n=6, seed=3)[0]


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for case, kw in CASES.items():
        if case == "covariate":
            out[case] = (_case_data(case), None, None)
            continue
        jd = _case_data(case)
        intro = {}
        jax_fit_laplace(_model(pst), jd, _prop(pst), THETA0, _introspect=intro,
                        _build_only=True, **kw)
        ones = jnp.ones((6,))
        jvg = jax.jit(jax.vmap(jax.value_and_grad(
            lambda z, y, f=intro["neg_laplace_wy"]: f(z, ones, y))))
        out[case] = (jd, intro, jvg)
    return out


@pytest.mark.parametrize("case", ["plain", "covariate"])
def test_replicate_simulations_and_refits_match(jax_side, case):
    jd, jintro, jvg = jax_side[case]
    kw = CASES[case]
    pop = _Pop(theta=np.array([0.28, 9.5]), omega=np.array([0.25, 0.12]),
               transform=("log", "log"))
    if case == "covariate":
        pop = type("Fit", (), dict(theta=pop.theta, omega=pop.omega, transform=pop.transform,
                                   omega_cov=None, beta=np.array([0.7]),
                                   covariate_effects=((0, "wt", "power", 70.0),)))()
    n_sim = 3
    _, want = jax_simulate(_model(pst), jd, _prop(pst), pop, n_sim, 5, True, 32)
    data = convert.data_from_reference(jd)
    _, sims = _simulate(_model(pt), data, _prop(pt), pop, n_sim, 5, True, 32, "cpu",
                        port_draws(jd, pop, n_sim, 5, 32, _prop(pt)))
    np.testing.assert_allclose(sims, want, rtol=1e-12, atol=1e-12)
    if case == "covariate":
        return  # the design operand's refits: test_torch_scm.py

    intro = {}
    fit_laplace(_model(pt), data, _prop(pt), THETA0, _introspect=intro, _build_only=True, **kw)
    psi0 = np.asarray(jintro["psi0"])
    ones = torch.ones((n_sim, 6), dtype=torch.float64)
    z, _, f = _vectorized_refits(lambda Z, y: intro["neg_laplace_wy_lanes"](Z, ones, y),
                                 torch.tensor(psi0), torch.tensor(sims), 2)
    jz, _, jf = jax_objective_refits(jvg, np.broadcast_to(psi0, (n_sim, psi0.size)),
                                     (np.asarray(want),), 2)
    assert np.all(np.isfinite(jz))
    np.testing.assert_allclose(z, jz, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(f, jf, rtol=1e-8)


def test_sse_laplace_samples_are_its_decoded_refits(jax_side):
    """With ``est_sigma=False`` the full optimum is (log theta, log omega)
    of the generating values, so the refits can be redone from them."""
    jd, _, _ = jax_side["plain"]
    data = convert.data_from_reference(jd)
    r = sse_laplace(_model(pt), data, _prop(pt), THETA0, n_sim=3, seed=5, refit_iters=1,
                    max_iters=2, compute_se=False, est_sigma=False, inner_steps=12,
                    device="cpu")
    assert r.n_ok == 3 and r.n_failed == 0 and set(r.samples) >= {"theta", "omega"}
    gen = r.generating
    full = _Pop(theta=gen["theta"], omega=gen["omega"], transform=("log", "log"))
    intro = {}
    fit_laplace(_model(pt), data, _prop(pt), THETA0, _introspect=intro, _build_only=True,
                est_sigma=False, inner_steps=12)
    _, sims = _simulate(_model(pt), data, _prop(pt), full, 3, 5, True, 32)
    z_opt = np.log(np.concatenate([gen["theta"], gen["omega"]]))
    z, _, _ = _vectorized_refits(
        lambda Z, y: intro["neg_laplace_wy_lanes"](Z, torch.ones(3, 6, dtype=torch.float64), y),
        torch.tensor(z_opt), torch.tensor(sims), 1)
    want = _decode_psi_samples(z, intro["layout"])
    np.testing.assert_allclose(r.samples["theta"], want["theta"], rtol=1e-9)
    assert "relbias" in r.summary()
