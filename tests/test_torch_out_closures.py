"""An ``out`` closure that returns a Python list, held against the JAX package.

``out=lambda x, p, t, cov: [x[0] / p[1]]`` is accepted by the JAX package on
every path; the port routes every ``out`` result through
``engine/sim.py::as_vector`` (the general engine's march, the single-subject
API and the per-subject batch) and through ``ops/fused_psi.py::
extract_linear_out`` (the fused plans' output coefficients), so such a model
gives the JAX package's values: the closed form (general and fused), the ODE
(general and fused), ``estimate_predictions`` and ``log_likelihood_batch``,
float64 within 1e-10 relative. The JAX side runs ``engine='xla'``, and
its ODE kernel in interpret mode for the port's fused ODE twin, which
marches that kernel's steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_batch as jax_batch
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert

RTOL = 1e-10
SUPPORT = np.array([[0.2, 1.0], [0.3, 2.0]])


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def list_out(x, p, t, cov):
    return [x[0] / p[1]]


def closed_form(lib):
    return lib.Analytical(lib.one_compartment, out=list_out, nstates=1, ndrugs=1, nout=1)


def ode(lib, stack):
    def rhs(x, p, t, b, rateiv, cov):
        return stack([-p[0] * x[0] + b[0] + rateiv[0]])

    return lib.ODE(rhs, out=list_out, nstates=1, ndrugs=1, nout=1)


def data():
    subjects = []
    for i, dose in enumerate((100.0, 80.0)):
        b = pst.Subject.builder(f"s{i}").bolus(0.0, dose, 0)
        if i:
            b = b.infusion(2.0, 40.0, 0, 1.5)
        for t in (0.5, 1.0, 3.0, 6.0):
            b = b.observation(t, 60.0 * np.exp(-0.25 * t) + i, 0)
        subjects.append(b.build())
    return pst.Data(subjects)


def ems(lib):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1, 0.0, 0.0), 1.0))


MODELS = {
    "closed_form": (lambda: closed_form(pst), lambda: closed_form(pt)),
    "ode": (lambda: ode(pst, jnp.stack), lambda: ode(pt, pt_stack)),
}


def pt_stack(v):
    import torch

    return torch.stack(v)


@pytest.mark.parametrize("engine", ["general", "fused"])
@pytest.mark.parametrize("name", list(MODELS))
def test_psi_matches_jax(name, engine):
    jmake, tmake = MODELS[name]
    jd = data()
    # the fused ODE twin marches the JAX ODE kernel's steps (interpret mode
    # on the CPU), not the general engine's
    jax_engine = "pallas" if (name, engine) == ("ode", "fused") else "xla"
    want = np.asarray(jax_psi(jmake(), jd, SUPPORT, ems(pst), engine=jax_engine))
    got = pt.log_likelihood_matrix(tmake(), convert.data_from_reference(jd), SUPPORT,
                                   ems(pt), engine=engine).numpy()
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_estimate_predictions_match_jax(name):
    jmake, tmake = MODELS[name]
    jm, tm = jmake(), tmake()
    jd = data()
    td = convert.data_from_reference(jd)
    for js, ts, p in zip(jd.subjects(), td.subjects(), SUPPORT):
        want = [q.prediction for q in jm.estimate_predictions(js, p).predictions()]
        got = [q.prediction for q in tm.estimate_predictions(ts, p).predictions()]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_log_likelihood_batch_matches_jax(name):
    jmake, tmake = MODELS[name]
    jd = data()
    jrems = pst.ResidualErrorModels().add(0, pst.ResidualErrorModel.combined(0.5, 0.1))
    want = np.asarray(jax_batch(jmake(), jd, SUPPORT, jrems))
    got = pt.log_likelihood_batch(tmake(), convert.data_from_reference(jd), SUPPORT,
                                  convert.residual_error_models_from_reference(jrems)).numpy()
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
