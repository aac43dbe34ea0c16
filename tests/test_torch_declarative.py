"""The port's declarative model API (``ode_model``, ``analytical_model``,
``sde_model``) against the JAX package's.

The cases of ``tests/test_declarative.py`` that build models through the
declarative API, each built in both packages from the same callbacks (they
use only arithmetic and ``**``) and held on the same subject: predictions
within 1e-10 relative (the SDE at zero diffusion 1e-9), and, with
observations, ``estimate_log_likelihood`` as well; then the API's refusals,
raised as ``PharmsolError`` by both.
"""

import math

import numpy as np
import pytest

import pharmsol_tpu as pst
import pharmsol_tpu_torch as pt
from pharmsol_tpu.errors import PharmsolError as JaxPharmsolError
from pharmsol_tpu_torch.errors import PharmsolError


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def ode_named_callbacks(lib):
    """test_declarative.py::test_ode_model_named_callbacks."""
    model = lib.ode_model(
        name="one_cmt_oral",
        parameters=["ka", "ke", "v", "tlag"],
        states=["depot", "central"],
        outputs=["cp"],
        routes=[lib.Route.bolus("oral").to_state("depot")],
        dynamics=lambda s, p, t, cov: {
            "depot": -p.ka * s.depot,
            "central": p.ka * s.depot - p.ke * s.central,
        },
        out=lambda s, p, t, cov: {"cp": s.central / p.v},
        lag=lambda p, t, cov: {"oral": p.tlag},
    ).with_tolerances(1e-10, 1e-10)
    subject = (lib.Subject.builder("s").bolus(0.0, 100.0, "oral")
               .observation(3.0, 2.0, "cp").observation(6.0, 1.5, "cp").build())
    return model, subject, [1.0, 0.1, 10.0, 0.5]


def ode_covariates(lib):
    """test_declarative.py::test_ode_model_covariates."""
    model = lib.ode_model(
        parameters=["ke"],
        states=["central"],
        outputs=["cp"],
        routes=[lib.Route.bolus("iv").to_state("central")],
        covariates=["wt"],
        dynamics=lambda s, p, t, cov: {"central": -p.ke * cov.wt * s.central},
        out=lambda s, p, t, cov: {"cp": s.central},
    ).with_tolerances(1e-10, 1e-10)
    subject = (lib.Subject.builder("s").bolus(0.0, 1.0, "iv").observation(2.0, 0.1, "cp")
               .covariate("wt", 0.0, 1.0).covariate("wt", 2.0, 3.0).build())
    return model, subject, [0.5]


def analytical_derive(lib):
    """test_declarative.py::test_analytical_model_with_derive."""
    model = lib.analytical_model(
        structure="one_compartment",
        parameters=["cl", "vol"],
        states=["central"],
        outputs=["cp"],
        routes=[lib.Route.infusion("iv").to_state("central")],
        derive=lambda p, t, cov: {"ke": p.cl / p.vol},
        out=lambda s, p, t, cov: {"cp": s.central / p.vol},
    )
    subject = (lib.Subject.builder("s").infusion(0.0, 100.0, "iv", 2.0)
               .observation(1.0, 2.0, "cp").observation(5.0, 1.0, "cp").build())
    return model, subject, [2.0, 20.0]


def sde_zero_diffusion(lib):
    """test_declarative.py::test_sde_model_declarative, at zero diffusion."""
    model = lib.sde_model(
        parameters=["ke", "v", "g"],
        states=["central"],
        outputs=["cp"],
        routes=[lib.Route.bolus("iv").to_state("central")],
        drift=lambda s, p, t, cov: {"central": -p.ke * s.central},
        diffusion=lambda p, t, cov: {"central": p.g},
        out=lambda s, p, t, cov: {"cp": s.central / p.v},
        nparticles=16,
        seed=5,
    )
    subject = lib.Subject.builder("s").bolus(0, 100, "iv").observation(1.0, 8.0, "cp").build()
    return model, subject, [0.2, 10.0, 0.0]


def readme_quickstart(lib):
    """test_declarative.py::test_reference_readme_quickstart: the reference's
    front page (README.md:17-64), a covariate-derived kernel input and named
    parameters; missing observations (predictions only)."""
    model = lib.analytical_model(
        structure="one_compartment_with_absorption",
        parameters=["ka", "ke0", "v"],
        covariates=["wt"],
        states=["gut", "central"],
        outputs=["cp"],
        routes=[lib.Route.bolus("oral").to_state("gut")],
        derive=lambda p, t, cov: {"ke": p.ke0 * (cov.wt / 70.0) ** 0.75},
        out=lambda s, p, t, cov: {"cp": s.central / p.v},
    )
    subject = (lib.Subject.builder("patient_001").bolus(0.0, 500.0, "oral")
               .missing_observation(0.5, "cp").missing_observation(1.0, "cp")
               .missing_observation(2.0, "cp").missing_observation(4.0, "cp")
               .covariate("wt", 0.0, 75.0).build())
    params = lib.Parameters.with_model(model, [("ka", 1.2), ("ke0", 0.08), ("v", 194.0)])
    return model, subject, params


CASES = {
    "ode_named_callbacks": ode_named_callbacks,
    "ode_covariates": ode_covariates,
    "analytical_derive": analytical_derive,
    "sde_zero_diffusion": sde_zero_diffusion,
    "readme_quickstart": readme_quickstart,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_declarative_model_matches_the_jax_package(case):
    jm, js, jp = CASES[case](pst)
    tm, ts, tp = CASES[case](pt)
    assert list(tm.metadata().parameter_names) == list(jm.metadata().parameter_names)
    assert tm.nstates() == jm.nstates() and tm.ndrugs() == jm.ndrugs()
    tol = 1e-9 if case.startswith("sde") else 1e-10
    want = np.asarray(jm.estimate_predictions(js, jp).flat_predictions())
    got = np.asarray(tm.estimate_predictions(ts, tp).flat_predictions())
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-14)
    if case == "readme_quickstart":
        # the closure oracle with the allometric ke folded in by hand
        ke = 0.08 * (75.0 / 70.0) ** 0.75
        oracle = pt.Analytical(pt.one_compartment_with_absorption,
                               out=lambda x, p, t, cov: x[1:2] / p[2],
                               nstates=2, ndrugs=1, nout=1)
        s2 = (pt.Subject.builder("p").bolus(0.0, 500.0, 0)
              .missing_observation(0.5, 0).missing_observation(1.0, 0)
              .missing_observation(2.0, 0).missing_observation(4.0, 0).build())
        np.testing.assert_allclose(
            got, oracle.estimate_predictions(s2, [1.2, ke, 194.0]).flat_predictions(),
            rtol=1e-10)
        return

    def ems(lib):
        return lib.AssayErrorModels().add(
            "cp", lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))

    np.testing.assert_allclose(tm.estimate_log_likelihood(ts, tp, ems(pt)),
                               jm.estimate_log_likelihood(js, jp, ems(pst)), rtol=tol)
    if case == "ode_named_callbacks":
        ka, ke, v, tlag = tp
        te = 3.0 - tlag
        closed = 100 * ka / (ka - ke) * (math.exp(-ke * te) - math.exp(-ka * te)) / v
        np.testing.assert_allclose(got[0], closed, rtol=1e-6)


def _analytical(lib, **over):
    kw = dict(structure="one_compartment_with_absorption", parameters=["ka", "ke", "v"],
              states=["depot", "central"], outputs=["cp"],
              routes=[lib.Route.bolus("oral").to_state("depot")],
              out=lambda s, p, t, cov: {"cp": s.central / p.v})
    kw.update(over)
    return lib.analytical_model(**kw)


REFUSALS = {
    "unknown_structure": lambda lib: _analytical(lib, structure="one_compartment_twice"),
    "state_count": lambda lib: _analytical(lib, states=["central"]),
    "missing_kernel_parameter": lambda lib: _analytical(lib, parameters=["ka", "v"]).spec.propagate(
        *_propagate_args(lib)),
    "unknown_lag_route": lambda lib: _analytical(
        lib, lag=lambda p, t, cov: {"nasal": p.ka})._lag(*_route_fn_args(lib)),
    "missing_dynamics_state": lambda lib: lib.ode_model(
        parameters=["ke"], states=["a", "b"], outputs=["cp"],
        routes=[lib.Route.bolus("iv").to_state("a")],
        dynamics=lambda s, p, t, cov: {"a": -p.ke * s.a},
        out=lambda s, p, t, cov: {"cp": s.b})._diffeq(*_rhs_args(lib)),
}


def _arrays(lib):
    if lib is pt:
        import torch

        return lambda v: torch.tensor(v, dtype=torch.float64)
    import jax.numpy as jnp

    return lambda v: jnp.asarray(v, dtype=jnp.float64)


def _propagate_args(lib):
    a = _arrays(lib)
    return a([1.0, 0.0]), a([1.0, 2.0]), a(1.0), a([0.0]), a(0.0), None


def _route_fn_args(lib):
    a = _arrays(lib)
    return a([1.0, 0.1, 10.0]), a(0.0), None


def _rhs_args(lib):
    a = _arrays(lib)
    return a([1.0, 0.0]), a([0.1]), a(0.0), a([0.0]), a([0.0]), None


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_declarative_refusals_match_the_jax_package(case):
    with pytest.raises(JaxPharmsolError) as want:
        REFUSALS[case](pst)
    with pytest.raises(PharmsolError) as got:
        REFUSALS[case](pt)
    assert str(got.value) == str(want.value)
