"""The CUDA fused psi kernels against their plain twins, on the card.

Marked ``cuda``: without a CUDA device these tests skip (the kernels have no
CPU mode). On the GPU machine run ``python -m pytest tests/test_torch_cuda.py``
(``chip_smoke.py`` runs the same checks at full width).
"""

import numpy as np
import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.likelihood.plans.analytical import _FusedPsiPlan
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
from pharmsol_tpu_torch.ops import fused_ode, fused_psi
from pharmsol_tpu_torch.ops.fused_psi import (
    STRUCTURES, psi_analytical, psi_analytical_plain,
)
from pharmsol_tpu_torch.utils.f32_budget import (
    F32_BUDGET, ODE_CASES, f32_error, kernel_case, ode_case,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused psi kernel has no CPU mode)")
    return torch.device("cuda")


def _plan(name, dtype, device):
    model, data, sp, ems = kernel_case(name)
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedPsiPlan(model, grid, sp, lowered, device, dtype)


def _run(plan, fn):
    return fn(*plan.streams, plan.support, structure=plan.structure,
              obs_outeq=plan.outeq, out_coef=plan.out_coef,
              out_bias=plan.out_bias)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_kernel_matches_twin_float64(cuda, name):
    plan = _plan(name, torch.float64, cuda)
    before = fused_psi.LAUNCHES
    got = _run(plan, psi_analytical)
    torch.cuda.synchronize()
    assert fused_psi.LAUNCHES == before + 1
    want = _run(plan, psi_analytical_plain)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_kernel_float32_within_budget(cuda, name):
    golden = _run(_plan(name, torch.float64, cuda), psi_analytical_plain)
    got = _run(_plan(name, torch.float32, cuda), psi_analytical)
    torch.cuda.synchronize()
    assert f32_error(got.cpu().numpy(), golden.cpu().numpy()) <= F32_BUDGET[name]


def test_entry_point_launches_once(cuda):
    model, data, sp, ems = kernel_case("two_compartments_with_absorption")
    before = fused_psi.LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    assert fused_psi.LAUNCHES == before + 1
    assert pt.last_engine_decision(model)["engine"] == "fused"
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general")
    np.testing.assert_allclose(psi.cpu().numpy(), want.numpy(), rtol=1e-10, atol=0)


def _ode_plan(name, dtype, device, solver="dopri5"):
    model, data, sp, ems = ode_case(name)
    model = model.with_solver(solver)
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedOdePsiPlan(model, grid, sp, lowered, device, dtype)


def _ode_run(plan, fn, merge=True):
    return fn(*plan.streams, plan.support, plan.rhs, **plan.kernel_kwargs(merge))


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("solver", ["dopri5", "tsit5"])
@pytest.mark.parametrize("name", list(ODE_CASES))
def test_ode_kernel_matches_twin_float64(cuda, name, solver, merge):
    plan = _ode_plan(name, torch.float64, cuda, solver)
    before = fused_ode.LAUNCHES
    got = _ode_run(plan, fused_ode.psi_ode, merge)
    torch.cuda.synchronize()
    assert fused_ode.LAUNCHES == before + 1
    want = _ode_run(plan, fused_ode.psi_ode_plain, merge)
    assert torch.isfinite(got).all()
    rel = ((got - want).abs() / want.abs().clamp(min=1.0)).max()
    assert float(rel) <= 1e-8


@pytest.mark.parametrize("name", list(ODE_CASES))
def test_ode_kernel_float32_within_budget(cuda, name):
    golden = _ode_run(_ode_plan(name, torch.float64, cuda), fused_ode.psi_ode_plain)
    got = _ode_run(_ode_plan(name, torch.float32, cuda), fused_ode.psi_ode)
    torch.cuda.synchronize()
    assert f32_error(got.cpu().numpy(), golden.cpu().numpy()) <= F32_BUDGET[name]


def test_ode_entry_point_launches_once(cuda):
    model, data, sp, ems = ode_case("ode_dopri5")
    before = fused_ode.LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    assert fused_ode.LAUNCHES == before + 1
    assert pt.last_engine_decision(model)["engine"] == "fused"
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general")
    rel = np.abs(psi.cpu().numpy() - want.numpy()) / np.maximum(np.abs(want.numpy()), 1.0)
    assert rel.max() <= 1e-4


def test_rejected_rhs_routes_auto_to_general(cuda):
    """An RHS the CUDA generator rejects takes the general engine with the
    reason kept, and never a silent twin."""
    model = pt.ODE(
        lambda x, p, t, b, r, cov: torch.stack([-p[0] * torch.sin(x[0]) + b[0]]),
        out=lambda x, p, t, cov: x[0:1] / p[1], nstates=1, ndrugs=1, nout=1)
    data = pt.Data([pt.Subject.builder("a").bolus(0.0, 100.0, 0)
                    .observation(1.0, 5.0, 0).build()])
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    sp = np.array([[0.2, 10.0], [0.3, 20.0]])
    before = fused_ode.LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general" and "`sin`" in decision["reason"]
    assert psi.device.type == "cuda" and torch.isfinite(psi).all()
    assert fused_ode.LAUNCHES == before
