"""The CUDA fused psi kernel against its plain twin, on the card.

Marked ``cuda``: without a CUDA device these tests skip (the kernel has no
CPU mode). On the GPU machine run ``python -m pytest tests/test_torch_cuda.py``
(``chip_smoke.py`` runs the same checks at full width).
"""

import numpy as np
import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.likelihood.plans.analytical import _FusedPsiPlan
from pharmsol_tpu_torch.ops import fused_psi
from pharmsol_tpu_torch.ops.fused_psi import (
    STRUCTURES, psi_analytical, psi_analytical_plain,
)
from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error, kernel_case

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
