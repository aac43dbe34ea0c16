"""The port's general psi engine against the JAX package's ``engine='xla'``.

Float64 on the CPU, relative tolerance 1e-10: both engines run the same
closed forms in the same order (prepared kernels, observation before dose),
so they agree to a few ulps. Inputs are made with numpy from a seed, built
once with the JAX package and carried into the port with ``convert``.
"""

import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu.engine.analytical import KERNELS
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi
from pharmsol_tpu.utils.f32_budget import _NOMINAL

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


RTOL = 1e-10


def _regimen(kind, rng, n=3):
    """Subjects of one regimen: short, repeat, infusion or censored (the
    last two are Short with an infusion or a BLOQ and an ALOQ sample)."""
    subjects = []
    for i in range(n):
        b = pst.Subject.builder(f"{kind}{i}")
        if kind != "repeat":
            # the reference's "Short": one 100 mg dose, 9 observations / 12 h
            b = b.bolus(0.0, 100.0, 0)
            times = [0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0]
        else:
            # "Repeat": 100 mg every 12 h x 10, troughs before every other
            # dose and two samples after the last
            for k in range(10):
                b = b.bolus(12.0 * k, 100.0, 0)
            times = [12.0 * k - 0.5 for k in (2, 4, 6, 8)] + [109.0, 120.0]
        if kind == "infusion":
            b = b.infusion(3.0, 150.0, 0, 1.5)
        for t in times:
            b = b.observation(t, float(abs(4.0 + rng.randn())), 0)
        if kind == "censored":
            b = b.censored_observation(14.0, 0.2, 0, pst.Censor.BLOQ)
            b = b.censored_observation(0.25, 9.0, 0, pst.Censor.ALOQ)
        subjects.append(b.build())
    return pst.Data(subjects)


def _models(name):
    fn, nstates, nparams = KERNELS[name]
    central = 1 if name.endswith("_with_absorption") else 0

    def out(x, p, t, cov, c=central, v=nparams):
        return x[c:c + 1] / p[v]

    mj = pst.Analytical(fn, out=out, nstates=nstates, ndrugs=1, nout=1)
    mt = pt.Analytical(getattr(pt, name), out=out, nstates=nstates,
                       ndrugs=1, nout=1)
    return mj, mt, nparams


def _compare(name, kind, seed, n_support=16):
    rng = np.random.RandomState(seed)
    data = _regimen(kind, rng)
    mj, mt, nparams = _models(name)
    sp = np.abs(np.array(_NOMINAL[name] + [11.0])[None, :]
                * (1.0 + 0.15 * rng.randn(n_support, nparams + 1)))
    ems = pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1), 1.0))
    want = jax_psi(mj, data, sp, ems, engine="xla")
    got = pt.log_likelihood_matrix(
        mt, convert.data_from_reference(data), sp,
        convert.error_models_from_reference(ems), engine="general")
    assert got.dtype == pt.float_dtype() and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", list(KERNELS))
def test_general_engine_matches_jax(name):
    _compare(name, "short", seed=len(name))


@pytest.mark.parametrize("kind", ["infusion", "censored"])
@pytest.mark.parametrize("name", ["one_compartment",
                                  "two_compartments_with_absorption",
                                  "three_compartments_cl_with_absorption"])
def test_general_engine_infusion_and_censoring(name, kind):
    _compare(name, kind, seed=11)


def test_general_engine_custom_closure_and_two_outputs():
    """A user eq closure (no prepared split) and a two-output model."""
    rng = np.random.RandomState(5)
    subjects = []
    for i in range(3):
        b = pst.Subject.builder(f"m{i}").bolus(0.0, 100.0, 0)
        for t in (0.5, 2.0, 6.0, 12.0):
            b = b.observation(t, float(abs(4.0 + rng.randn())), 0)
            b = b.observation(t + 0.25, float(abs(1.0 + rng.randn())), 1)
        subjects.append(b.build())
    data = pst.Data(subjects)
    ems = (pst.AssayErrorModels()
           .add(0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1), 1.0))
           .add(1, pst.AssayErrorModel.proportional(pst.ErrorPoly(0.1, 0.2), 2.0)))

    def eq_j(x, p, t, rateiv, cov):
        return pst.one_compartment_with_absorption(x, p, t, rateiv, cov)

    def eq_t(x, p, t, rateiv, cov):
        return pt.one_compartment_with_absorption(x, p, t, rateiv, cov)

    def out(x, p, t, cov):
        return (x[1:2] / p[2], x[0:1] / p[3] + 0.05 * p[2])

    def out_j(x, p, t, cov):
        import jax.numpy as jnp

        return jnp.concatenate(out(x, p, t, cov))

    def out_t(x, p, t, cov):
        import torch

        return torch.cat(out(x, p, t, cov))

    sp = np.abs(np.array([1.1, 0.2, 11.0, 4.0])[None, :]
                * (1.0 + 0.15 * rng.randn(9, 4)))
    mj = pst.Analytical(eq_j, out=out_j, nstates=2, ndrugs=1, nout=2)
    mt = pt.Analytical(eq_t, out=out_t, nstates=2, ndrugs=1, nout=2)
    want = jax_psi(mj, data, sp, ems, engine="xla")
    got = pt.log_likelihood_matrix(
        mt, convert.data_from_reference(data), sp,
        convert.error_models_from_reference(ems)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
