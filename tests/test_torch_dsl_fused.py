"""Models written through the authoring surfaces on the fused paths, on the
CPU (the kernels' plain twins).

- The kernel-input decomposition (``plans/decompose.py::
  _decompose_kernel_inputs``): the remapped support and the row or segment
  multipliers and offsets equal the JAX function's within 1e-12, over a
  pure reorder, time-constant and time-varying covariates, multiplicative
  and additive effects, and a time-dependent derive.
- psi of DSL and declarative closed forms through the twin of K1a/K1b
  against the JAX package's ``engine='pallas'`` (its kernel in interpret
  mode) and the port's general engine, 1e-10; the port's counterparts of
  JAX ``tests/test_pallas_psi.py::test_pallas_engine_declarative_model``
  (:966), ``::test_pallas_engine_dsl_model`` (:996) and
  ``::test_pallas_engine_declarative_additive_derive`` (:1558).
- ``engine='auto'`` (forced onto the fused route, as on a card) takes the
  fused plan for each model of ``chip_smoke.py`` phase 23
  (``utils/authoring_cases.py``), and each gives the psi of the hand-written
  closure model it is held against on the card.
- The plan's refusals raise ``PharmsolError`` where the JAX plan raises.
- The NPAG fit over the DSL closed form lands on the closure model's fit.
"""

import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
import pharmsol_tpu_torch as pt
from pharmsol_tpu.dsl import compile_model as jax_compile
from pharmsol_tpu.errors import PharmsolError as JaxPharmsolError
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi
from pharmsol_tpu.likelihood.plans.decompose import _decompose_kernel_inputs as jax_decompose
from pharmsol_tpu_torch.dsl import compile_model
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood import matrix
from pharmsol_tpu_torch.likelihood.plans.analytical import _FusedPsiPlan
from pharmsol_tpu_torch.likelihood.plans.decompose import _decompose_kernel_inputs
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
from pharmsol_tpu_torch.likelihood.plans.sde import _FusedSdePsiPlan
from pharmsol_tpu_torch.utils import authoring_cases as ac
from pharmsol_tpu_torch.utils.f32_budget import (
    COVARIATE_MODEL_CENTRE, POPULATION_RANGES, covariate_model_case, population_10k_case,
    population_models,
)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _declarative(lib, derive, cov="wt", structure="one_compartment_with_absorption",
                 states=("gut", "central"), dose="gut", params=("ka", "ke0", "v")):
    return lib.analytical_model(
        structure=structure, parameters=list(params), covariates=[cov],
        states=list(states), outputs=["cp"],
        routes=[lib.Route.bolus("oral").to_state(dose)],
        derive=derive, out=lambda s, p, t, cov: {"cp": s.central / p.v})


def _subjects(lib, cov, knots, n=4, seed=5):
    """``n`` subjects: 500 into ``oral`` at 0, four observations; covariate
    ``cov`` at knots ``[(t, value(i)), ...]``."""
    rng = np.random.RandomState(seed)
    subs = []
    for i in range(n):
        b = lib.Subject.builder(f"q{i}").bolus(0.0, 500.0, "oral")
        for t, value in knots:
            b = b.covariate(cov, t, value(i))
        for t in (1.0, 2.0, 6.0, 12.0):
            b = b.observation(float(t), float(abs(2 + rng.randn())), "cp")
        subs.append(b.build())
    return lib.Data(subs)


TV_WT = [(0.0, lambda i: 70.0 + 2 * i), (12.0, lambda i: 60.0 + i)]
CONST_WT = [(0.0, lambda i: 70.0 + 5 * i)]
CONST_CRCL = [(0.0, lambda i: 60.0 + 10.0 * i)]
TV_CRCL = [(0.0, lambda i: 60.0 + 10.0 * i), (6.0, lambda i: 90.0 - 5.0 * i)]
SP3 = np.abs(np.array([1.2, 0.08, 190.0])[None, :]
             * (1 + 0.2 * np.random.RandomState(5).randn(6, 3)))


def allometric(p, t, cov):
    return {"ke": p.ke0 * (cov.wt / 70.0) ** 0.75}


def additive(p, t, cov):
    return {"ke": p.ke0 + 0.0008 * cov.crcl}


def in_time(p, t, cov):
    return {"ke": p.ke0 * (1.0 + 0.02 * t) + 0.0 * cov.wt}


# name: (model builder, data builder, support, expected (mode, offsets))
STREAM_CASES = {
    "reorder": (lambda lib: (compile_model if lib is pt else jax_compile)(ac.DSL_SHORT).model,
                lambda lib: ac.short_data(5, 3, lib=lib),
                ac.jittered(ac.SHORT_CENTRE, 6, 4), (None, False)),
    "time_varying_multiplier": (
        lambda lib: (compile_model if lib is pt else jax_compile)(ac.DSL_CREATININE).model,
        lambda lib: ac.creatinine_data(5, 3, lib=lib), ac.jittered(ac.CREATININE_CENTRE, 6, 4),
        ("segment", False)),
    "constant_multiplier": (lambda lib: _declarative(lib, allometric),
                            lambda lib: _subjects(lib, "wt", CONST_WT), SP3, ("row", False)),
    "constant_additive": (lambda lib: _declarative(lib, additive, cov="crcl"),
                          lambda lib: _subjects(lib, "crcl", CONST_CRCL), SP3, ("row", True)),
    "time_varying_additive": (lambda lib: _declarative(lib, additive, cov="crcl"),
                              lambda lib: _subjects(lib, "crcl", TV_CRCL), SP3,
                              ("segment", True)),
    "time_dependent": (lambda lib: _declarative(lib, in_time),
                       lambda lib: _subjects(lib, "wt", CONST_WT), SP3, ("segment", False)),
}


def _streams(lib, decompose, case):
    build, data, sp, _ = STREAM_CASES[case]
    model, d = build(lib), data(lib)
    return decompose(model._kernel_inputs, sp, model.lower(d.subjects()), 2, True)


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_kernel_input_streams_match_the_jax_function(case):
    got = _streams(pt, _decompose_kernel_inputs, case)
    want = _streams(pst, jax_decompose, case)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12, atol=1e-12)
    mode, offsets = STREAM_CASES[case][3]
    _, mult, off, mult_seg, off_seg = got
    assert (mult is not None, mult_seg is not None) == (mode == "row", mode == "segment")
    assert (off is not None or off_seg is not None) == offsets


def _fused_psi(model, data, sp, ems):
    return pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()


@pytest.mark.parametrize("case", ["constant_additive", "reorder", "time_varying_multiplier"])
def test_twin_matches_the_jax_kernel_and_the_general_engine(case):
    build, data, sp, (mode, _) = STREAM_CASES[case]
    model, d = build(pt), data(pt)
    ems = ac.ems_for()
    got = _fused_psi(model, d, sp, ems)
    want_general = pt.log_likelihood_matrix(model, d, sp, ems, engine="general").numpy()
    np.testing.assert_allclose(got, want_general, rtol=1e-10, atol=1e-10)
    want_jax = np.asarray(jax_psi(build(pst), data(pst), sp, ac.ems_for(pst), engine="pallas"))
    np.testing.assert_allclose(got, want_jax, rtol=1e-10, atol=1e-10)
    plan = _FusedPsiPlan(model, model.lower(d.subjects()), sp,
                         ems.lower(model.resolve_output_label, 1), pt.device(), pt.float_dtype())
    assert plan.mode == mode


def _jax_test_case(lib, which):
    """The models and data of JAX tests/test_pallas_psi.py:966, :996, :1558."""
    if which == "dsl":
        src = ac.DSL_CREATININE.replace("params = ka, cl, v", "params = ka, ke0, v") \
            .replace("ke = cl * pow(wt / 70.0, 0.75) / v", "ke = ke0 * (wt / 70.0) ^ 0.75") \
            .replace("covariates = wt@linear", "covariates = wt")
        model = (compile_model if lib is pt else jax_compile)(src).model
        return model, _subjects(lib, "wt", TV_WT, seed=6)
    if which == "declarative":
        return _declarative(lib, allometric), _subjects(lib, "wt", TV_WT, seed=5)
    return _declarative(lib, additive, cov="crcl"), _subjects(lib, "crcl", CONST_CRCL, seed=11)


@pytest.mark.parametrize("which", ["declarative", "declarative_additive", "dsl"])
def test_jax_pallas_engine_declarative_cases(which):
    model, data = _jax_test_case(pt, which)
    ems = ac.ems_for()
    got = _fused_psi(model, data, SP3, ems)
    want = pt.log_likelihood_matrix(model, data, SP3, ems, engine="general").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    jmodel, jdata = _jax_test_case(pst, which)
    np.testing.assert_allclose(got, np.asarray(jax_psi(jmodel, jdata, SP3, ac.ems_for(pst))),
                               rtol=1e-10, atol=1e-10)
    if which == "dsl":
        # a covariate-reading out() is still refused
        bad = compile_model(ac.DSL_CREATININE.replace("out(cp) = central / v",
                                                      "out(cp) = central / (v * wt / 70.0)"))
        with pytest.raises(PharmsolError, match=r"out\(\) reads a covariate"):
            _fused_psi(bad.model, data, np.abs(np.array([[1.2, 6.0, 30.0]])), ems)


# -- chip_smoke.py phase 23's models ------------------------------------------


def _closure_short():
    return pt.Analytical(pt.one_compartment_with_absorption,
                         out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)


def _closure_ode_short():
    return pt.ODE(lambda x, p, t, b, rateiv, cov: torch.stack([
        -p[1] * x[0] + b[0],
        p[1] * x[0] - (p[0] + p[2]) * x[1] + p[3] * x[2] + rateiv[0],
        p[2] * x[1] - p[3] * x[2],
    ]), out=lambda x, p, t, cov: x[1:2] / p[4], nstates=3, ndrugs=1, nout=1)


def _closure_readme(nparticles):
    md = (pt.metadata.new("ke_diffusion").parameters(["ke0", "v", "sigma_ke"])
          .states(["central", "ke_latent"]).outputs(["cp"])
          .route(pt.metadata.Route.bolus("iv").to_state("central")).particles(nparticles))
    return pt.SDE(
        drift=lambda x, p, t, rateiv, cov: torch.stack([-x[1] * x[0], -(x[1] - p[0])]),
        diffusion=lambda p, t, cov: [0.0, p[2]],
        init=lambda p, t, cov: [0.0, p[0]],
        out=lambda x, p, t, cov: x[0:1] / p[1],
        nparticles=nparticles, nstates=2, ndrugs=1, nout=1, seed=42,
    ).with_metadata(md)


def _readme_data(lib, n, seed):
    """The README's subject (100 into ``iv``) with its first two
    observations: the twin's particle loop goes with the span."""
    rng = np.random.RandomState(seed)
    values = np.array([8.0, 6.2]) * np.exp(0.15 * rng.randn(n, 2))
    subjects = []
    for i in range(n):
        b = lib.Subject.builder(f"r{i}").bolus(0.0, 100.0, "iv")
        for t, v in zip((1.0, 2.0), values[i]):
            b = b.observation(t, float(v), "cp")
        subjects.append(b.build())
    return lib.Data(subjects)


def phase23_cases():
    """name: (authored model, its data, support, ems, the closure model, its
    data, its support, its ems, plan class, what to check)."""
    short = ac.jittered(ac.SHORT_CENTRE, 7, 2)
    cov_sp = np.abs(np.asarray(COVARIATE_MODEL_CENTRE)[None, :]
                    * (1.0 + 0.15 * np.random.RandomState(9).randn(5, 4)))
    cov_closure, cov_data, _, cov_ems = covariate_model_case(6, 1, seed=3)
    _, cov_named, _, cov_named_ems = covariate_model_case(6, 1, seed=3, named=True)
    readme_sp = ac.jittered([0.2, 10.0, 0.05], 2, 8, 0.15)
    ode_sp = ac.jittered(ac.ODE_SHORT_CENTRE, 4, 2)
    return {
        "dsl_short_k1a": (compile_model(ac.DSL_SHORT).model, ac.short_data(12, 1), short,
                          ac.ems_for(), _closure_short(), ac.short_data(12, 1, named=False),
                          short[:, [2, 1, 0]], ac.ems_for(label=0), _FusedPsiPlan, None),
        "dsl_creatinine_k1b": (compile_model(ac.DSL_CREATININE).model,
                               ac.creatinine_data(12, 3), ac.jittered(ac.CREATININE_CENTRE, 7, 4),
                               ac.ems_for(), None, None, None, None, _FusedPsiPlan, "segment"),
        "declarative_covariates_k2e": (ac.covariates_ode_model(), cov_named, cov_sp,
                                       cov_named_ems, cov_closure, cov_data, cov_sp, cov_ems,
                                       _FusedOdePsiPlan, None),
        "dsl_ode_short_k2a": (compile_model(ac.DSL_ODE_SHORT).model,
                              ac.short_data(5, 1, infusion=True), ode_sp, ac.ems_for(),
                              _closure_ode_short(),
                              ac.short_data(5, 1, named=False, infusion=True), ode_sp,
                              ac.ems_for(label=0), _FusedOdePsiPlan, None),
        "declarative_readme_sde_k3a": (ac.readme_sde_model(nparticles=32), _readme_data(pt, 2, 7),
                                       readme_sp, ac.ems_for(), _closure_readme(32),
                                       _readme_data(pt, 2, 7), readme_sp, ac.ems_for(),
                                       _FusedSdePsiPlan, None),
    }


@pytest.mark.parametrize("case", ["dsl_short_k1a", "dsl_creatinine_k1b",
                                  "declarative_covariates_k2e", "dsl_ode_short_k2a",
                                  "declarative_readme_sde_k3a"])
def test_phase23_model_takes_the_fused_plan(case, monkeypatch):
    (model, data, sp, ems, closure, c_data, c_sp, c_ems, plan_cls,
     mode) = phase23_cases()[case]
    monkeypatch.setattr(matrix, "_auto_engine", lambda device: ("fused", "forced"))
    psi = pt.log_likelihood_matrix(model, data, sp, ems)
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "fused", decision
    assert torch.isfinite(psi).all()
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    plan = plan_cls(model, model.lower(data.subjects()), sp, lowered, pt.device(),
                    pt.float_dtype())
    if plan_cls is _FusedPsiPlan:
        assert plan.mode == mode
        if mode is None:  # K1a: no feature input
            assert all(v is None for v in plan.features.values())
    if closure is None:
        want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general")
        np.testing.assert_allclose(psi.numpy(), want.numpy(), rtol=1e-10, atol=1e-10)
        return
    want = pt.log_likelihood_matrix(closure, c_data, c_sp, c_ems, engine="fused")
    np.testing.assert_allclose(psi.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    if plan_cls is not _FusedPsiPlan:
        c_plan = plan_cls(closure, closure.lower(c_data.subjects()), c_sp,
                          c_ems.lower(closure.resolve_output_label, 1), pt.device(),
                          pt.float_dtype())
        gen = plan.rhs if plan_cls is _FusedOdePsiPlan else plan.gen
        c_gen = c_plan.rhs if plan_cls is _FusedOdePsiPlan else c_plan.gen
        # the same CUDA header, so the same library on the card; the
        # covariate example's declares its covariates in another order
        assert (gen.key == c_gen.key) == (case != "declarative_covariates_k2e")
        if plan_cls is _FusedSdePsiPlan:
            assert gen.zero_diffusion == frozenset({0})


# -- refusals -------------------------------------------------------------------


def _three_cmt(lib):
    return lib.analytical_model(
        structure="three_compartments", parameters=["ke0", "k12", "k13", "k21", "k31", "v"],
        covariates=["wt"], states=["central", "p1", "p2"], outputs=["cp"],
        routes=[lib.Route.bolus("oral").to_state("central")],
        derive=lambda p, t, cov: {"k10": p.ke0 * (cov.wt / 70.0) ** 0.75},
        out=lambda s, p, t, cov: {"cp": s.central / p.v})


def _power(p, t, cov):
    return {"ke": p.ke0 ** (cov.wt / 70.0)}


def _constant_ka(p, t, cov):
    return {"ka": 1.5, "ke": p.ke0 * (cov.wt / 70.0) ** 0.75}


# name: (model builder, support, the phrase both plans' messages hold)
REFUSALS = {
    "three_compartment_covariate_derive": (
        _three_cmt, np.array([[0.1, 0.3, 0.2, 0.25, 0.15, 20.0]] * 2), "3-compartment"),
    "not_affinely_separable": (lambda lib: _declarative(lib, _power), SP3,
                               "affinely separable"),
    "parameter_degenerate": (lambda lib: _declarative(lib, _constant_ka), SP3,
                             "parameter-degenerate"),
    "bolus_into_another_state": (
        lambda lib: _declarative(lib, allometric, dose="central"), SP3,
        "expects the bolus route to target state 0"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_plan_refusals_match_the_jax_plan(case):
    build, sp, phrase = REFUSALS[case]
    with pytest.raises(JaxPharmsolError, match=phrase):
        jax_psi(build(pst), _subjects(pst, "wt", TV_WT), sp, ac.ems_for(pst), engine="pallas")
    with pytest.raises(PharmsolError, match=phrase):
        _fused_psi(build(pt), _subjects(pt, "wt", TV_WT), sp, ac.ems_for())


# -- the population fit ------------------------------------------------------------


def test_npag_fit_over_the_dsl_model_lands_on_the_closure_fit():
    """fit_population over the DSL closed form (its kernel inputs a pure
    reindex: K1a's twin) against the same fit over the closure model:
    same cycles and support count, log-likelihood within 1e-8."""
    data, ems, _ = population_10k_case(40)
    named, named_ems, _ = population_10k_case(40, named=True)
    kw = dict(ranges=POPULATION_RANGES, init_points=32, max_cycles=4, engine="fused")
    want = pt.optimize.fit_population(population_models()[0], data, ems, **kw)
    got = pt.optimize.fit_population(compile_model(ac.DSL_POPULATION).model, named,
                                     named_ems, **kw)
    assert got.cycles == want.cycles
    assert got.support.shape == want.support.shape
    np.testing.assert_allclose(got.log_likelihood, want.log_likelihood, rtol=1e-8)
    np.testing.assert_allclose(got.support, want.support, rtol=1e-10)


def test_dsl_intrinsics_take_the_ode_kernel(monkeypatch):
    """A DSL ODE reading floor, ceil, round, sin, cos, tan, log10 and log2
    passes the RHS generator (``engine='auto'`` forced onto the fused
    route takes K2a's twin), and the twin matches the JAX kernel in
    interpret mode on the same model within 1e-9, as the JAX plan takes it
    to its kernel."""
    data = lambda lib: ac.short_data(3, 5, lib=lib)  # noqa: E731
    sp = ac.jittered(ac.INTRINSICS_CENTRE, 2, 6)
    model = compile_model(ac.DSL_INTRINSICS).model
    monkeypatch.setattr(matrix, "_auto_engine", lambda device: ("fused", "forced"))
    got = pt.log_likelihood_matrix(model, data(pt), sp, ac.ems_for()).numpy()
    assert pt.last_engine_decision(model)["engine"] == "fused"
    want = np.asarray(jax_psi(jax_compile(ac.DSL_INTRINSICS).model, data(pst), sp,
                              ac.ems_for(pst), engine="pallas"))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
