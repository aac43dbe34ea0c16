"""The feature tier of the fused SDE plan and the twin of kernel K3b.

On the CPU ``engine='fused'`` builds ``_FusedSdePsiPlan`` and runs the plain
twin ``psi_sde_plain``; the CUDA kernel is held against that twin on the card
(``chip_smoke.py``, ``test_torch_cuda.py``), where both draw the same Philox
numbers. Here, float64:

- the twin against the JAX package's kernel in interpret mode, the way the
  JAX package's own tests run it on the CPU, at zero diffusion where the
  noise never enters: one case with a time-varying covariate, lag, fa and a
  covariate-dependent init, within 1e-9 relative (the JAX kernel pads to its
  8 x 128 tile and unrolls its rows and segments, so its interpret run is
  the slow part);
- the twin against the port's general engine on every mode of
  ``utils/f32_budget.py::SDE_FEATURE_CASES`` at zero diffusion (1e-9), and
  statistically with noise;
- what the plan builds (covariate modes, init planes, slot tables) and what
  it refuses, with ``engine='auto'`` recording the reason.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood import matrix
from pharmsol_tpu_torch.likelihood.plans.sde import _FusedSdePsiPlan
from pharmsol_tpu_torch.ops import fused_sde
from pharmsol_tpu_torch.utils.f32_budget import SDE_FEATURE_CASES, sde_feature_case


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _plan(model, data, sp, ems, dtype=torch.float64):
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedSdePsiPlan(model, grid, sp, lowered, torch.device("cpu"), dtype)


def _features_model(xp, cls):
    """One state, elimination scaled by a time-varying weight, lag, fa and an
    init that reads the weight; no diffusion."""
    return cls(drift=lambda x, p, t, r, cov: xp.stack([-p[0] * (cov("wt", t) / 70.0) * x[0]]),
               diffusion=lambda p, t, cov: [0.0 * p[0]],
               lag=lambda p, t, cov: {0: p[2]}, fa=lambda p, t, cov: {0: p[3]},
               init=lambda p, t, cov: [0.1 * p[1] * cov("wt", t) / 70.0],
               out=lambda x, p, t, cov: x[0:1] / p[1],
               nparticles=16, nstates=1, ndrugs=1, nout=1, seed=3)


def test_twin_matches_the_jax_kernel_in_interpret_mode():
    """4 x 8 cells, 16 particles, three segments: every feature input of the
    JAX kernel at once (an affine covariate stream, lag and fa planes with
    the split march, init planes)."""
    subs = []
    for i in range(4):
        sb = (pst.SubjectBuilder(f"f{i}").bolus(0.0, 100.0, 0)
              .covariate("wt", 0.0, 55.0 + 5.0 * i).covariate("wt", 0.5, 70.0 - 3.0 * i)
              .observation(0.5, 6.0 + 0.1 * i, 0).observation(1.2, 5.0 - 0.1 * i, 0))
        subs.append(sb.build())
    rng = np.random.default_rng(8)
    sp = np.column_stack([rng.uniform(0.8, 1.6, 8), rng.uniform(8, 14, 8),
                          rng.uniform(0.1, 0.9, 8), rng.uniform(0.4, 1.0, 8)])
    ems = pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.0, 0.0, 0.0), 0.5))
    want = np.asarray(jax_psi(_features_model(jnp, pst.SDE), pst.Data(subs), sp, ems,
                              engine="pallas"))
    model = _features_model(torch, pt.SDE)
    data, pems = convert.data_from_reference(pst.Data(subs)), \
        convert.error_models_from_reference(ems)
    plan = _plan(model, data, sp, pems)
    f = plan.features
    assert plan.cov_modes == ("affine",) and f["init_planes"] is not None
    assert f["lag_planes"] is not None and f["fa_planes"] is not None
    before = (fused_sde.LAUNCHES, fused_sde.FEATURE_LAUNCHES)
    got = pt.log_likelihood_matrix(model, data, sp, pems, engine="fused").numpy()
    assert (fused_sde.LAUNCHES, fused_sde.FEATURE_LAUNCHES) == before  # the twin ran
    assert np.isfinite(want).all() and _rel(got, want) <= 1e-9


@pytest.mark.parametrize("name", SDE_FEATURE_CASES)
def test_twin_matches_the_general_engine_at_zero_diffusion(name):
    model, data, sp, ems = sde_feature_case(name, 4, 6, seed=2, sigma=False)
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    assert np.isfinite(want).all() and _rel(got, want) <= 1e-9


def test_twin_and_general_engine_agree_statistically_with_lag():
    """With noise the twin (Philox) and the general engine (a torch
    generator) are independent estimates: the mean per-cell difference
    within four standard errors."""
    model, data, sp, ems = sde_feature_case("lag_fa", 6, 8, seed=4, nparticles=64)
    model = model.with_noise("independent")
    d = (pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
         - pt.log_likelihood_matrix(model, data, sp, ems, engine="general")).flatten()
    assert bool(torch.isfinite(d).all())
    assert abs(float(d.mean())) <= 4.0 * float(d.std()) / math.sqrt(d.numel())


def test_plan_builds_each_feature_input():
    cases = {name: _plan(*sde_feature_case(name, 3, 5)) for name in SDE_FEATURE_CASES}
    assert cases["cov_const"].cov_modes == ("const",)
    assert cases["cov_affine"].cov_modes == ("affine",)
    a, b = cases["cov_affine"].features["cov_streams"]["wt"]
    assert a.shape == b.shape == cases["cov_affine"].streams[0].shape
    assert cases["init_rows"].init is not None and cases["init_rows"].features["init_planes"] is None
    assert tuple(cases["init_planes"].features["init_planes"].shape) == (2, 3, 5)
    static = cases["lag_fa"].features
    assert static["lag_slots"] is None and tuple(static["lag_planes"].shape) == (1, 3, 5)
    dyn = cases["dyn_lag_fa"]
    assert dyn.lag_slots is not None and dyn.fa_slots is not None
    assert len(dyn.lag_slots) == 1 and len(dyn.lag_slots[0]) == dyn.M
    two = cases["two_inputs_inject"]
    assert two.dose_states == (0, 1) and tuple(two.features["lag_planes"].shape) == (2, 3, 5)
    for name in ("lag", "fa"):
        assert cases[name].features["cov_streams"] == {}


def _small(lag=None, drift=None, out=None):
    model = pt.SDE(drift=drift or (lambda x, p, t, r, cov: torch.stack([-p[0] * x[0]])),
                   diffusion=lambda p, t, cov: [0.0], lag=lag,
                   out=out or (lambda x, p, t, cov: x[0:1] / p[1]),
                   nparticles=8, nstates=1, ndrugs=1, nout=1)
    return model


@pytest.mark.parametrize("what, match", [
    ("knot_inside", "change points"),
    ("lag_overlap", "strictly before"),
    ("negative_lag", "negative lag"),
    ("out_reads_cov", "reads a covariate"),
    ("unknown_cov", "unknown covariate"),
])
def test_plan_refusals_raise_and_auto_records_them(what, match, monkeypatch):
    sb = (pt.Subject.builder("a").bolus(0.0, 100.0, 0).bolus(1.0, 50.0, 0)
          .covariate("wt", 0.0, 70.0).covariate("wt", 0.7, 80.0)
          .observation(0.5, 5.0, 0).observation(2.0, 4.0, 0))
    data = pt.Data([sb.build()])
    sp = np.array([[0.5, 10.0, 0.4]])
    drift = (lambda x, p, t, r, cov: torch.stack([-p[0] * cov("wt", t) / 70.0 * x[0]]))
    model = {
        # a knot at 0.7 h lies inside the segment 0.5-1 h
        "knot_inside": _small(drift=drift),
        "lag_overlap": _small(lag=lambda p, t, cov: {0: 1.5}),
        "negative_lag": _small(lag=lambda p, t, cov: {0: -0.2 * cov("wt", t) / 70.0}),
        "out_reads_cov": _small(out=lambda x, p, t, cov: x[0:1] / p[1] * cov("wt", t) / 70.0),
        "unknown_cov": _small(drift=lambda x, p, t, r, cov: torch.stack(
            [-p[0] * cov("crcl", t) * x[0]])),
    }[what]
    with pytest.raises(PharmsolError, match=match):
        pt.log_likelihood_matrix(model, data, sp, pt.AssayErrorModels().add(
            0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0)), engine="fused")
    monkeypatch.setattr(matrix, "_auto_engine", lambda device: ("fused", "forced"))
    ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    try:
        pt.log_likelihood_matrix(model, data, sp, ems)
    except Exception:
        assert what == "unknown_cov"  # the general engine refuses it too
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general" and "fused plan rejected" in decision["reason"]


def test_wrapper_checks_the_feature_inputs():
    model, data, sp, ems = sde_feature_case("dyn_lag_fa", 3, 4)
    plan = _plan(model, data, sp, ems)
    kw = plan.kernel_kwargs()
    R, M = plan.streams[0].shape
    ok = fused_sde.psi_sde(*plan.streams, plan.support, plan.gen, **kw)
    assert ok.shape == (R, 4)
    with pytest.raises(ValueError, match="slots must be"):
        fused_sde.psi_sde(*plan.streams, plan.support, plan.gen,
                          **dict(kw, lag_slots=((0,) * (M + 1),)))
    with pytest.raises(ValueError, match="planes, expected"):
        fused_sde.psi_sde(*plan.streams, plan.support, plan.gen,
                          **dict(kw, lag_planes=kw["lag_planes"][:1]))
    cov_model, cdata, csp, cems = sde_feature_case("cov_affine", 3, 4)
    cplan = _plan(cov_model, cdata, csp, cems)
    ckw = cplan.kernel_kwargs()
    with pytest.raises(ValueError, match="cov_streams has no stream"):
        fused_sde.psi_sde(*cplan.streams, cplan.support, cplan.gen, **dict(ckw, cov_streams={}))
    with pytest.raises(ValueError, match="cov_modes"):
        fused_sde.psi_sde(*cplan.streams, cplan.support, cplan.gen,
                          **dict(ckw, cov_modes=("const",)))
    with pytest.raises(ValueError, match="pass an \\(a, b\\) pair"):
        fused_sde.psi_sde(*cplan.streams, cplan.support, cplan.gen,
                          **dict(ckw, cov_streams={"wt": ckw["cov_streams"]["wt"][0]}))
