"""The port's slice end to end: ``log_likelihood_matrix`` against the JAX package.

64 subjects x 128 support points of the 2-cmt oral "Short" workload (with a
few subjects on richer regimens: a second dose, an infusion, censored and
missing observations, a second occasion), float64 on the CPU. Engine
routing, the fused path (its plain twin here) and the errors for what the
port does not support yet are checked too.
"""

import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood import matrix
from pharmsol_tpu_torch.ops import fused_psi


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


N_SUBJECTS, N_SUPPORT = 64, 128
TIMES = [0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0]


def _out(x, p, t, cov):
    return x[1:2] / p[4]


@pytest.fixture(scope="module")
def slice_inputs():
    rng = np.random.RandomState(2024)
    subjects = []
    for i in range(N_SUBJECTS):
        b = pst.Subject.builder(f"id{i}").bolus(0.0, 100.0, 0)
        if i % 4 == 1:
            b = b.bolus(6.0, 50.0, 0)
        if i % 8 == 2:
            b = b.infusion(2.0, 80.0, 0, 1.0)
        for t in TIMES:
            b = b.observation(t, float(abs(5.0 + rng.randn())), 0)
        if i % 8 == 3:
            b = b.censored_observation(14.0, 0.2, 0, pst.Censor.BLOQ)
            b = b.censored_observation(0.25, 9.0, 0, pst.Censor.ALOQ)
        if i % 8 == 5:
            b = b.missing_observation(5.0, 0)
        if i % 16 == 7:
            b = b.reset().bolus(0.0, 80.0, 0).observation(2.0, 3.0, 0)
        subjects.append(b.build())
    data = pst.Data(subjects)
    center = np.array([0.15, 1.2, 0.3, 0.2, 10.0])
    support = np.abs(center[None, :] * (1.0 + 0.2 * rng.randn(N_SUPPORT, 5)))
    ems = pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1), 1.0))
    model = pst.Analytical(pst.two_compartments_with_absorption, out=_out,
                           nstates=3, ndrugs=1, nout=1)
    want = jax_psi(model, data, support, ems, engine="xla")
    return (convert.data_from_reference(data), support,
            convert.error_models_from_reference(ems), want)


def _model():
    return pt.Analytical(pt.two_compartments_with_absorption, out=_out,
                         nstates=3, ndrugs=1, nout=1)


def test_auto_on_cpu_takes_general_and_matches_jax(slice_inputs):
    data, support, ems, want = slice_inputs
    model = _model()
    assert pt.last_engine_decision(model) is None
    psi = pt.log_likelihood_matrix(model, data, support, ems)
    assert isinstance(psi, torch.Tensor)
    assert psi.shape == (N_SUBJECTS, N_SUPPORT)
    assert psi.dtype == torch.float64 and psi.device.type == "cpu"
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general" and "CPU" in decision["reason"]
    np.testing.assert_allclose(psi.numpy(), want, rtol=1e-10, atol=0)


def test_fused_uses_the_twin_and_matches_jax(slice_inputs):
    data, support, ems, want = slice_inputs
    before = fused_psi.LAUNCHES
    psi = pt.log_likelihood_matrix(_model(), data, support, ems, engine="fused")
    assert fused_psi.LAUNCHES == before
    np.testing.assert_allclose(psi.numpy(), want, rtol=1e-10, atol=0)


def test_float32_slice_within_bench_criterion(slice_inputs):
    data, support, ems, want = slice_inputs
    pt.set_float_dtype(torch.float32)
    try:
        for engine in ("general", "fused"):
            psi = pt.log_likelihood_matrix(_model(), data, support, ems,
                                           engine=engine)
            assert psi.dtype == torch.float32
            rel = np.abs(psi.double().numpy() - want) / np.maximum(np.abs(want), 1e-3)
            assert rel.max() <= 1e-3, engine  # bench.py's f32 criterion
    finally:
        pt.set_float_dtype(torch.float64)


def test_auto_picks_fused_on_cuda_without_crossover():
    engine, reason = matrix._auto_engine(torch.device("cuda"))
    assert engine == "fused" and "CUDA" in reason
    assert matrix._auto_engine(torch.device("cpu"))[0] == "general"


def test_auto_records_why_the_fused_plan_rejected_a_model(slice_inputs, monkeypatch):
    """A model outside the plan's scope goes to the general engine with the
    reason kept (the CUDA routing, exercised here on the CPU)."""
    data, support, ems, want = slice_inputs
    monkeypatch.setattr(matrix, "_auto_engine",
                        lambda device: ("fused", "forced for the test"))

    def eq(x, p, t, rateiv, cov):  # not a named built-in kernel
        return pt.two_compartments_with_absorption(x, p, t, rateiv, cov)

    model = pt.Analytical(eq, out=_out, nstates=3, ndrugs=1, nout=1)
    psi = pt.log_likelihood_matrix(model, data, support, ems)
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general"
    assert "fused plan rejected the model" in decision["reason"]
    assert "named built-in kernel" in decision["reason"]
    np.testing.assert_allclose(psi.numpy(), want, rtol=1e-10, atol=0)
    with pytest.raises(PharmsolError, match="named built-in kernel"):
        pt.log_likelihood_matrix(model, data, support, ems, engine="fused")
    # the built-in kernel takes the fused path under the same routing
    model = _model()
    pt.log_likelihood_matrix(model, data, support, ems)
    assert pt.last_engine_decision(model)["engine"] == "fused"


def test_fused_plan_rejects_a_dose_into_another_input():
    model = pt.Analytical(pt.one_compartment_with_absorption,
                          out=lambda x, p, t, cov: x[1:2] / p[2],
                          nstates=2, ndrugs=2, nout=1)
    data = pt.Data([pt.Subject.builder("a").bolus(0.0, 100.0, 1)
                    .observation(1.0, 5.0, 0).build()])
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    sp = np.array([[1.0, 0.2, 10.0]])
    with pytest.raises(PharmsolError, match="input 0"):
        pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    general = pt.log_likelihood_matrix(model, data, sp, ems, engine="general")
    assert torch.isfinite(general).all()


@pytest.mark.parametrize("kw", ["seq_eq", "lag", "fa", "init"])
def test_unported_equations_raise(kw):
    """Closed-form and ODE models take seq (closed forms only), lag, fa and
    init. Since kernel K1c a seq read at a time-varying covariate together
    with lag runs in the fused closed-form plan too (its column planes), and
    equals the general engine."""
    fn = {
        "seq_eq": lambda p, t, cov: p,
        "lag": lambda p, t, cov: {0: 0.5},
        "fa": lambda p, t, cov: {0: 0.8},
        "init": lambda p, t, cov: torch.zeros(3),
    }[kw]
    name = "seq" if kw == "seq_eq" else kw
    model = pt.Analytical(pt.two_compartments_with_absorption, out=_out,
                          nstates=3, ndrugs=1, nout=1, **{kw: fn})
    assert getattr(model.spec, name) is fn
    if kw == "seq_eq":
        data = pt.Data([pt.Subject.builder("c").bolus(0.0, 100.0, 0)
                        .covariate("wt", 0.0, 70.0).covariate("wt", 6.0, 60.0)
                        .observation(1.0, 4.0, 0).observation(8.0, 2.0, 0).build()])
        lagged = pt.Analytical(
            pt.two_compartments_with_absorption, out=_out, nstates=3, ndrugs=1, nout=1,
            seq_eq=lambda p, t, cov: [p[0] * cov("wt", t) / 70.0, p[1], p[2], p[3],
                                      p[4], p[5]],
            lag=lambda p, t, cov: {0: p[5]})
        ems = pt.AssayErrorModels().add(
            0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
        sp = np.array([[0.15, 1.2, 0.3, 0.2, 10.0, 0.4]])
        fused = pt.log_likelihood_matrix(lagged, data, sp, ems, engine="fused")
        general = pt.log_likelihood_matrix(lagged, data, sp, ems, engine="general")
        torch.testing.assert_close(fused, general, rtol=1e-10, atol=1e-10)
        return
    ode = pt.ODE(lambda x, p, t, b, r, cov: x, out=_out, nstates=3, ndrugs=1, nout=1,
                 **{kw: fn})
    assert getattr(ode.spec, name) is fn


def test_covariates_raise(slice_inputs):
    """Closed-form and ODE models read covariates through their closures,
    in every engine: fused equals general (closed form 1e-10, ODE at the
    controller's error, 1e-4)."""
    _, support, ems, _ = slice_inputs
    data = pt.Data([pt.Subject.builder("c").bolus(0.0, 100.0, 0)
                    .covariate("wt", 0.0, 70.0).covariate("wt", 4.0, 60.0)
                    .observation(1.0, 4.0, 0).observation(4.0, 2.0, 0).build()])
    ode = pt.ODE(lambda x, p, t, b, r, cov: torch.stack(
        [-p[1] * x[0] + b[0], p[1] * x[0] - p[0] * (cov("wt", t) / 70.0) * x[1],
         0.0 * x[2]]),
        out=_out, nstates=3, ndrugs=1, nout=1)
    psi, psi_ode = {}, {}
    for engine in ("auto", "general", "fused"):
        psi[engine] = pt.log_likelihood_matrix(_model(), data, support, ems, engine=engine)
        psi_ode[engine] = pt.log_likelihood_matrix(ode, data, support, ems, engine=engine)
        assert torch.isfinite(psi_ode[engine]).all()
    torch.testing.assert_close(psi["fused"], psi["general"], rtol=1e-10, atol=0)
    assert torch.isfinite(psi["auto"]).all()
    torch.testing.assert_close(psi_ode["auto"], psi_ode["general"], rtol=0, atol=0)
    torch.testing.assert_close(psi_ode["fused"], psi_ode["general"], rtol=1e-4, atol=1e-4)


def test_unknown_engine_and_bad_support_raise(slice_inputs):
    data, support, ems, _ = slice_inputs
    with pytest.raises(PharmsolError, match="unknown psi engine"):
        pt.log_likelihood_matrix(_model(), data, support, ems, engine="xla")
    with pytest.raises(PharmsolError, match="2D"):
        pt.log_likelihood_matrix(_model(), data, support[0], ems)


def test_non_finite_cells_map_to_neg_inf(slice_inputs):
    data, support, ems, _ = slice_inputs
    sp = support[:4].copy()
    sp[1, 4] = 0.0  # v = 0: predictions are infinite
    for engine in ("general", "fused"):
        psi = pt.log_likelihood_matrix(_model(), data, sp, ems, engine=engine)
        assert torch.isneginf(psi[:, 1]).all()
        assert torch.isfinite(psi[:, [0, 2, 3]]).all()
        nan = pt.log_likelihood_matrix(_model(), data, sp, ems, engine=engine,
                                       on_error="nan")
        assert not torch.isfinite(nan[:, 1]).any()


@pytest.mark.parametrize("how", ["fifth_false", "fifth_true", "keyword"])
def test_progress_sits_in_the_jax_position(slice_inputs, how, capsys):
    """``progress`` is the fifth positional argument, as in the JAX package:
    psi is the JAX psi either way, a lost cell stays -inf (a positional True
    once landed in ``on_error`` and let NaN through), and the JAX package's
    two lines are printed on the general path."""
    data, support, ems, want = slice_inputs
    sp = support[:6].copy()
    sp[1, 4] = 0.0  # v = 0: the JAX package maps this column to -inf
    args = {"fifth_false": (False,), "fifth_true": (True,), "keyword": ()}[how]
    kw = {"progress": True} if how == "keyword" else {}
    psi = pt.log_likelihood_matrix(_model(), data, sp, ems, *args, **kw).numpy()
    out = capsys.readouterr().out
    keep = [0, 2, 3, 4, 5]
    np.testing.assert_allclose(psi[:, keep], np.asarray(want)[:, keep], rtol=1e-10)
    assert np.isneginf(psi[:, 1]).all() and not np.isnan(psi).any()
    if how == "fifth_false":
        assert out == ""
    else:
        first, last = out.splitlines()
        assert first == (f"Computing log-likelihood matrix: {N_SUBJECTS} subjects \u00d7 "
                         f"6 support points...")
        assert last.startswith(f"  done: {N_SUBJECTS * 6} cells in ") and "cells/s)" in last
    # the signature keeps the JAX order, with device last
    import inspect

    names = list(inspect.signature(pt.log_likelihood_matrix).parameters)
    assert names == ["equation", "subjects", "support_points", "error_models", "progress",
                     "on_error", "engine", "device"]
    # the fused path prints nothing, as the JAX package's pallas path
    pt.log_likelihood_matrix(_model(), data, sp, ems, True, engine="fused")
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# The ODE slice: the Short workload's 2-cmt oral model as an ODE
# ---------------------------------------------------------------------------


def _ode_rhs(xp):  # bench.py:210-214
    return lambda x, p, t, b, rateiv, cov: xp.stack([
        -p[1] * x[0] + b[0],
        p[1] * x[0] - (p[0] + p[2]) * x[1] + p[3] * x[2] + rateiv[0],
        p[2] * x[1] - p[3] * x[2],
    ])


@pytest.fixture(scope="module")
def ode_slice():
    """8 Short subjects (one with an infusion, one censored) x 24 supports,
    with non-default solver options set on the JAX model; psi of both JAX
    engines."""
    import jax.numpy as jnp

    rng = np.random.RandomState(77)
    subjects = []
    for i in range(8):
        b = pst.Subject.builder(f"o{i}").bolus(0.0, 100.0, 0)
        if i == 2:
            b = b.infusion(2.0, 80.0, 0, 1.0)
        for t in TIMES:
            b = b.observation(t, float(abs(5.0 + rng.randn())), 0)
        if i == 3:
            b = b.censored_observation(14.0, 0.2, 0, pst.Censor.BLOQ)
        subjects.append(b.build())
    data = pst.Data(subjects)
    center = np.array([0.15, 1.2, 0.3, 0.2, 10.0])
    support = np.abs(center[None, :] * (1.0 + 0.2 * rng.randn(24, 5)))
    ems = pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1), 1.0))
    model = (pst.ODE(_ode_rhs(jnp), out=_out, nstates=3, ndrugs=1, nout=1)
             .with_solver("tsit5").with_tolerances(1e-6, 1e-7).with_h0(1e-2)
             .with_max_steps(5000))
    want = {e: np.asarray(jax_psi(model, data, support, ems, engine=e))
            for e in ("xla", "pallas")}
    return (convert.data_from_reference(data), support,
            convert.error_models_from_reference(ems), model._opts, want)


def _ode_model(jax_opts):
    """The port's ODE with the JAX model's options carried across."""
    o = convert.ode_options_from_reference(jax_opts)
    return (pt.ODE(_ode_rhs(torch), out=_out, nstates=3, ndrugs=1, nout=1)
            .with_solver(o.solver).with_tolerances(o.rtol, o.atol)
            .with_h0(o.h0).with_max_steps(o.max_steps))


def test_ode_options_carry_across(ode_slice):
    *_, opts, _ = ode_slice
    o = convert.ode_options_from_reference(opts)
    assert (o.solver, o.rtol, o.atol, o.h0, o.max_steps) == ("tsit5", 1e-6, 1e-7, 1e-2, 5000)


@pytest.mark.parametrize("engine, jax_engine, rtol", [
    ("general", "xla", 1e-10), ("fused", "pallas", 1e-9)])
def test_ode_slice_matches_jax_in_both_engines(ode_slice, engine, jax_engine, rtol):
    data, support, ems, opts, want = ode_slice
    psi = pt.log_likelihood_matrix(_ode_model(opts), data, support, ems,
                                   engine=engine)
    assert psi.shape == (8, 24) and psi.dtype == torch.float64
    # the censored row uses the exact log-CDF here and the TPU kernel's
    # approximation there: hold it against the JAX general engine
    ref = want[jax_engine].copy()
    ref[3] = want["xla"][3]
    tol = rtol if engine == "general" else 1e-4
    np.testing.assert_allclose(psi.numpy()[3], ref[3], rtol=tol, atol=0)
    rows = [r for r in range(8) if r != 3]
    np.testing.assert_allclose(psi.numpy()[rows], ref[rows], rtol=rtol, atol=0)
    # default options differ: the carried options are what made it agree
    default = pt.ODE(_ode_rhs(torch), out=_out, nstates=3, ndrugs=1, nout=1)
    other = pt.log_likelihood_matrix(default, data, support, ems, engine=engine)
    assert np.abs(other.numpy() - want[jax_engine]).max() > 1e-8


def test_ode_auto_on_cpu_takes_general(ode_slice):
    data, support, ems, opts, want = ode_slice
    model = _ode_model(opts)
    psi = pt.log_likelihood_matrix(model, data, support, ems)
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general" and "CPU" in decision["reason"]
    np.testing.assert_allclose(psi.numpy(), want["xla"], rtol=1e-10, atol=0)


# ---------------------------------------------------------------------------
# The SDE slice: the reference's README model (examples/sde_readme.py)
# ---------------------------------------------------------------------------


def _sde_closures(xp):
    """drift, diffusion, init and out of the README model: a latent
    mean-reverting elimination rate, p = ke0, v, sigma_ke."""
    return dict(
        drift=lambda x, p, t, r, cov: xp.stack([-x[1] * x[0], -(x[1] - p[0])]),
        diffusion=lambda p, t, cov: [0.0 * p[2], p[2]],
        init=lambda p, t, cov: [0.0 * p[0], p[0]],
        out=lambda x, p, t, cov: x[0:1] / p[1],
    )


def _readme_metadata(md_module, nparticles):
    return (md_module.new("ke_diffusion").parameters(["ke0", "v", "sigma_ke"])
            .states(["central", "ke_latent"]).outputs(["cp"])
            .route(md_module.Route.bolus("iv").to_state("central"))
            .particles(nparticles))


@pytest.fixture(scope="module")
def sde_slice():
    """12 README subjects (labels through metadata) x 10 supports at
    sigma_ke = 0, with non-default options on the JAX model; the JAX
    package's xla psi."""
    import jax.numpy as jnp
    from pharmsol_tpu import metadata as jax_metadata

    rng = np.random.RandomState(31)
    subjects = []
    for i in range(12):
        b = pst.Subject.builder(f"r{i}").bolus(0.0, 100.0, "iv")
        for t, v in zip((1.0, 2.0, 4.0, 8.0), (8.0, 6.2, 4.1, 1.8)):
            b = b.observation(t, float(v * np.exp(0.15 * rng.randn())), "cp")
        subjects.append(b.build())
    data = pst.Data(subjects)
    support = np.abs(np.array([0.2, 10.0, 0.05]) * (1 + 0.15 * rng.randn(10, 3)))
    support[:, 2] = 0.0
    ems = pst.AssayErrorModels().add(
        "cp", pst.AssayErrorModel.additive(pst.ErrorPoly(0.3, 0.1), 0.5))
    model = (pst.SDE(**_sde_closures(jnp), nparticles=24, nstates=2, ndrugs=1, nout=1,
                     seed=42)
             .with_metadata(_readme_metadata(jax_metadata, 24))
             .with_em_control("coupled").with_noise("independent"))
    want = np.asarray(jax_psi(model, data, support, ems, engine="xla"))
    return (convert.data_from_reference(data), support,
            convert.error_models_from_reference(ems), model, want)


def _sde_model(jax_model):
    """The port's README SDE with the JAX model's options carried across."""
    from pharmsol_tpu_torch import metadata as pt_metadata

    opts = convert.sde_options_from_reference(jax_model)
    return (pt.SDE(**_sde_closures(torch), nstates=2, ndrugs=1, nout=1, **opts)
            .with_metadata(_readme_metadata(pt_metadata, opts["nparticles"])))


def test_sde_options_carry_across(sde_slice):
    *_, jax_model, _ = sde_slice
    model = _sde_model(jax_model)
    spec = model.spec
    assert (spec.nparticles, model._seed, spec.noise, spec.resampling, spec.em_control) == (
        24, 42, "independent", "stratified", "coupled")
    assert spec.bolus_dest == (0,)


@pytest.mark.parametrize("engine", ["general", "fused"])
def test_sde_slice_matches_jax_at_zero_diffusion(sde_slice, engine):
    """Both engines of the port against the JAX engine, 1e-9: the fused twin
    stops each march by the kernel's rule, the general engine by the JAX
    engine's, and at zero diffusion the two agree to rounding."""
    data, support, ems, jax_model, want = sde_slice
    psi = pt.log_likelihood_matrix(_sde_model(jax_model), data, support, ems, engine=engine)
    assert psi.shape == (12, 10) and psi.dtype == torch.float64
    np.testing.assert_allclose(psi.numpy(), want, rtol=1e-9, atol=0)


def test_sde_auto_on_cpu_takes_general(sde_slice):
    data, support, ems, jax_model, want = sde_slice
    model = _sde_model(jax_model)
    psi = pt.log_likelihood_matrix(model, data, support, ems)
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general" and "CPU" in decision["reason"]
    np.testing.assert_allclose(psi.numpy(), want, rtol=1e-9, atol=0)


def test_sde_slice_with_noise_in_both_engines(sde_slice):
    """With sigma_ke on, both port engines give finite psi of the slice's
    shape whose cell means agree within four standard errors (independent
    draws: torch generator against Philox)."""
    data, support, ems, jax_model, _ = sde_slice
    sp = support.copy()
    sp[:, 2] = 0.2
    model = _sde_model(jax_model).with_nparticles(200)
    general = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    fused = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    d = (fused - general).ravel()
    assert np.isfinite(d).all() and np.abs(d).max() > 0
    assert abs(d.mean()) <= 4 * d.std(ddof=1) / np.sqrt(d.size)
