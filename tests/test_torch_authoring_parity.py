"""Authoring parity in the port: the same model as hand-written closures, as
the declarative API and as DSL text gives the same predictions, and the DSL
model gives the JAX package's.

The corpus of ``tests/test_authoring_parity_corpus.py`` and
``tests/test_authoring_parity_full.py`` (marked ``slow`` in the JAX package;
this copy runs in the gate at their small size): an analytical structure
with a covariate-derived kernel input (the closure through ``seq_eq``), a
multi-output ODE, an SDE at zero diffusion, lag and fa written as flat
statements and as canonical route properties, and one ODE with every
feature (covariates linear and locf, derived parameters, two bolus routes
and an infusion route, lag and fa on one route, init, three states). The
port's three surfaces agree at the JAX corpus's tolerances (1e-10; the
multi-output closure 1e-8; the route forms 1e-12), its metadata views are
the same, and its DSL model's predictions (and, for the full-feature model,
log-likelihood) are the JAX package's within 1e-10 (the SDE 1e-9).
"""

import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
import pharmsol_tpu_torch as pt
from pharmsol_tpu.dsl import compile_model as jax_compile
from pharmsol_tpu_torch.dsl import compile_model

from test_authoring_parity_corpus import (
    ANALYTICAL_DSL, LAG_FLAT, LAG_PROPS, MULTI_OUT_DSL, SDE_DSL,
)
from test_authoring_parity_full import DSL_SRC as FULL_DSL
from test_authoring_parity_full import P as FULL_P


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def flat(model, subject, params):
    return np.asarray(model.estimate_predictions(subject, params).flat_predictions())


# -- case 1: analytical structure with derive + covariate -----------------------


def analytical_trio():
    decl = pt.analytical_model(
        structure="one_compartment_with_absorption",
        parameters=["ka", "cl", "v"],
        covariates=["wt"],
        states=["depot", "central"],
        outputs=["cp"],
        routes=[pt.Route.bolus("oral").to_state("depot")],
        derive=lambda p, t, cov: {"ke": p.cl * (cov.wt / 70.0) ** 0.75 / p.v},
        out=lambda s, p, t, cov: {"cp": s.central / p.v},
    )

    def seq(p, t, cov):
        ke = p[1] * (cov("wt", t) / 70.0) ** 0.75 / p[2]
        return torch.stack([p[0], ke, p[2]])

    # handwritten: kernel params [ka, ke]; seq rewrites column 1 to ke
    hand = pt.Analytical(pt.one_compartment_with_absorption, seq_eq=seq,
                         out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)
    return decl, hand


def cov_subject(lib, label_in, label_out):
    b = (lib.Subject.builder("s1").bolus(0.0, 200.0, label_in)
         .covariate("wt", 0.0, 62.0).covariate("wt", 24.0, 70.0))
    for t in (0.5, 1.0, 2.0, 6.0, 12.0, 24.0):
        b = b.observation(t, 0.0, label_out)
    return b.build()


def multi_out_trio():
    decl = pt.ode_model(
        parameters=["ka", "ke", "km", "kme", "vp", "vm"],
        states=["depot", "parent", "metabolite"],
        outputs=["cp", "cm"],
        routes=[pt.Route.bolus("oral").to_state("depot")],
        dynamics=lambda s, p, t, cov: {
            "depot": -p.ka * s.depot,
            "parent": p.ka * s.depot - (p.ke + p.km) * s.parent,
            "metabolite": p.km * s.parent - p.kme * s.metabolite,
        },
        out=lambda s, p, t, cov: {"cp": s.parent / p.vp, "cm": s.metabolite / p.vm},
    )
    hand = pt.ODE(
        lambda x, p, t, b, rateiv, cov: torch.stack([
            -p[0] * x[0] + b[0],
            p[0] * x[0] - (p[1] + p[2]) * x[1],
            p[2] * x[1] - p[3] * x[2],
        ]),
        out=lambda x, p, t, cov: torch.stack([x[1] / p[4], x[2] / p[5]]),
        nstates=3, ndrugs=1, nout=2,
    )
    return decl, hand


def multi_out_subject(lib, label_in, out_cp, out_cm):
    b = lib.Subject.builder("m1").bolus(0.0, 100.0, label_in)
    for t in (1.0, 4.0, 12.0):
        b = b.observation(t, 0.0, out_cp).observation(t, 0.0, out_cm)
    return b.build()


def sde_trio():
    decl = pt.sde_model(
        parameters=["ke", "v"],
        states=["central"],
        outputs=["cp"],
        routes=[pt.Route.bolus("iv").to_state("central")],
        drift=lambda s, p, t, cov: {"central": -p.ke * s.central},
        diffusion=lambda p, t, cov: {"central": 0.0},
        out=lambda s, p, t, cov: {"cp": s.central / p.v},
        nparticles=16,
    )
    hand = pt.SDE(
        drift=lambda x, p, t, rateiv, cov: torch.stack([-p[0] * x[0]]),
        diffusion=lambda p, t, cov: torch.zeros(1, dtype=torch.float64),
        out=lambda x, p, t, cov: x[:1] / p[1],
        nparticles=16, nstates=1, ndrugs=1, nout=1,
    )
    return decl, hand


def sde_subject(lib, label_in, label_out):
    return (lib.Subject.builder("z").bolus(0.0, 100.0, label_in)
            .observation(1.0, 0.0, label_out).observation(6.0, 0.0, label_out).build())


def lag_subject(lib, *_):
    return (lib.Subject.builder("l").bolus(0.0, 100.0, "oral")
            .observation(1.0, 0.0, "cp").observation(4.0, 0.0, "cp").build())


# -- case 5: every feature in one ODE ------------------------------------------


def full_trio():
    decl = pt.ode_model(
        name="full_feature",
        parameters=["ka", "ke", "kcp", "kpc", "v", "tlag_oral", "f_oral",
                    "base_depot", "base_central"],
        covariates=["wt", pt.CovariateDecl.locf("renal")],
        states=["depot", "central", "peripheral"],
        outputs=["cp"],
        routes=[
            pt.Route.bolus("oral").to_state("depot"),
            pt.Route.bolus("load").to_state("central"),
            pt.Route.infusion("iv").to_state("central"),
        ],
        dynamics=lambda s, p, t, cov: {
            "depot": -p.ka * s.depot,
            "central": p.ka * s.depot
            - (p.ke * (cov.wt / 70.0) ** 0.75 + p.kcp) * s.central
            + p.kpc * s.peripheral,
            "peripheral": p.kcp * s.central - p.kpc * s.peripheral,
        },
        out=lambda s, p, t, cov: {"cp": s.central / (p.v * (cov.wt / 70.0))},
        init=lambda p, t, cov: {
            "depot": p.base_depot + 0.05 * cov.wt,
            "central": p.base_central + 0.1 * cov.renal,
        },
        lag=lambda p, t, cov: {"oral": p.tlag_oral * torch.sqrt(cov.wt / 70.0)},
        fa=lambda p, t, cov: {
            "oral": torch.clamp(p.f_oral * (cov.renal / 90.0) ** 0.1, 0.0, 1.0)},
    )

    # dense layout: bolus inputs: oral=0, load=1; infusion inputs: iv=0
    def diffeq(x, p, t, b, rateiv, cov):
        adj_ke = p[1] * (cov("wt", t) / 70.0) ** 0.75
        return torch.stack([
            -p[0] * x[0] + b[0],
            p[0] * x[0] - (adj_ke + p[2]) * x[1] + p[3] * x[2] + rateiv[0] + b[1],
            p[2] * x[1] - p[3] * x[2],
        ])

    hand = pt.ODE(
        diffeq,
        lag=lambda p, t, cov: {0: p[5] * torch.sqrt(cov("wt", t) / 70.0)},
        fa=lambda p, t, cov: {0: torch.clamp(p[6] * (cov("renal", t) / 90.0) ** 0.1, 0.0, 1.0)},
        init=lambda p, t, cov: [p[7] + 0.05 * cov("wt", t), p[8] + 0.1 * cov("renal", t), 0.0],
        out=lambda x, p, t, cov: x[1:2] / (p[4] * (cov("wt", t) / 70.0)),
        nstates=3, ndrugs=2, nout=1,
    )
    return decl, hand


def full_subject(lib, named: bool):
    oral, load, iv, cp = ("oral", "load", "iv", "cp") if named else (0, 1, 0, 0)
    b = (lib.Subject.builder("full").bolus(0.0, 100.0, oral).bolus(0.5, 20.0, load)
         .infusion(6.0, 50.0, iv, 2.0).covariate("wt", 0.0, 80.0).covariate("wt", 24.0, 76.0)
         .covariate("renal!", 0.0, 85.0))
    for t in (1.0, 3.0, 7.0, 12.0, 24.0):
        b = b.observation(t, 1.0, cp)
    return b.build()


# name: (DSL source, trio builder or None, named subject, bare subject, params,
#        closure tolerance, tolerance against the JAX package)
CASES = {
    "analytical_covariate_derive": (
        ANALYTICAL_DSL, analytical_trio, lambda lib: cov_subject(lib, "oral", "cp"),
        lambda lib: cov_subject(lib, 0, 0), [1.3, 3.5, 30.0], 1e-10, 1e-10),
    "multi_output_ode": (
        MULTI_OUT_DSL, multi_out_trio, lambda lib: multi_out_subject(lib, "oral", "cp", "cm"),
        lambda lib: multi_out_subject(lib, 0, 0, 1), [1.2, 0.15, 0.08, 0.05, 30.0, 20.0],
        1e-8, 1e-10),
    "sde_zero_diffusion": (
        SDE_DSL, sde_trio, lambda lib: sde_subject(lib, "iv", "cp"),
        lambda lib: sde_subject(lib, 0, 0), [0.2, 25.0], 1e-10, 1e-9),
    "full_feature_ode": (
        FULL_DSL, full_trio, lambda lib: full_subject(lib, True),
        lambda lib: full_subject(lib, False), FULL_P, 1e-10, 1e-10),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_surfaces_agree_and_match_the_jax_package(case):
    src, trio, named, bare, p, tol_hand, tol_jax = CASES[case]
    dsl = compile_model(src).model
    decl, hand = trio()
    a = flat(dsl, named(pt), p)
    assert np.all(np.isfinite(a)) and np.all(a > 0)
    np.testing.assert_allclose(flat(decl, named(pt), p), a, rtol=1e-10)
    np.testing.assert_allclose(flat(hand, bare(pt), p), a, rtol=tol_hand)
    want = flat(jax_compile(src).model, named(pst), p)
    np.testing.assert_allclose(a, want, rtol=tol_jax)
    for m in (dsl, decl):
        assert list(m.metadata().parameter_names) == list(dsl.metadata().parameter_names)
        assert list(m.metadata().output_names) == list(dsl.metadata().output_names)
    if case == "analytical_covariate_derive":
        for m in (dsl, decl):
            md = m.metadata()
            assert list(md.covariate_names()) == ["wt"]
            assert md.analytical_kernel().value == "one_compartment_with_absorption"
    if case == "sde_zero_diffusion":
        # adaptive Euler-Maruyama at the reference's rtol=1e-2 (em.rs:104-170)
        np.testing.assert_allclose(a, [100.0 * np.exp(-0.2 * t) / 25.0 for t in (1.0, 6.0)],
                                   rtol=1e-2)
    if case == "full_feature_ode":
        def ems(lib, label):
            return lib.AssayErrorModels().add(
                label, lib.AssayErrorModel.additive(lib.ErrorPoly(0.3, 0.1), 1.0))

        ll = dsl.estimate_log_likelihood(named(pt), p, ems(pt, "cp"))
        np.testing.assert_allclose(decl.estimate_log_likelihood(named(pt), p, ems(pt, "cp")),
                                   ll, rtol=1e-10)
        np.testing.assert_allclose(hand.estimate_log_likelihood(bare(pt), p, ems(pt, 0)),
                                   ll, rtol=1e-10)
        want_ll = jax_compile(src).model.estimate_log_likelihood(named(pst), p, ems(pst, "cp"))
        np.testing.assert_allclose(ll, want_ll, rtol=1e-10)


def test_route_property_forms_agree():
    """lag/fa as flat statements and as canonical route properties."""
    p = [1.2, 0.2, 30.0, 0.5, 0.8]
    a = flat(compile_model(LAG_FLAT).model, lag_subject(pt), p)
    b = flat(compile_model(LAG_PROPS).model, lag_subject(pt), p)
    np.testing.assert_allclose(a, b, rtol=1e-12)
    assert np.all(a > 0)
    np.testing.assert_allclose(a, flat(jax_compile(LAG_PROPS).model, lag_subject(pst), p),
                               rtol=1e-10)
