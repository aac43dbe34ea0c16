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
    EXPM_CASES, F32_BUDGET, FEATURE_BUDGETS, FEATURE_CASES, K1C_CASES, ODE_CASES,
    ODE_FEATURE_CASES, POPULATION_RANGES, SDE_FEATURE_CASES, covariate_model_case, expm_case,
    f32_error, feature_budget_case, feature_case, k1c_case, kernel_case, ode_case,
    ode_feature_case, population_10k_case, population_models, sde_covariate_model_case,
    sde_feature_case, stiff_case,
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
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general", device="cpu")
    np.testing.assert_allclose(psi.cpu().numpy(), want.numpy(), rtol=1e-10, atol=0)


def _feature_plan(model, data, sp, ems, dtype, device):
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedPsiPlan(model, grid, sp, lowered, device, dtype)


def _run_features(plan, fn):
    return fn(*plan.streams, plan.support, **plan.kernel_kwargs())


@pytest.mark.parametrize("name", list(FEATURE_CASES))
def test_feature_kernel_matches_twin(cuda, name):
    """K1b in every mode: float64 within 1e-10 of its twin, float32 within
    the mode's budget row of the float64 twin; one K1b launch each."""
    model, data, sp, ems, mode = feature_case(name, n_subjects=24, n_support=40, seed=11)
    plan = _feature_plan(model, data, sp, ems, torch.float64, cuda)
    assert plan.mode == mode
    before = (fused_psi.LAUNCHES, fused_psi.FEATURE_LAUNCHES)
    got = _run_features(plan, psi_analytical)
    torch.cuda.synchronize()
    assert (fused_psi.LAUNCHES, fused_psi.FEATURE_LAUNCHES) == (before[0], before[1] + 1)
    want = _run_features(plan, psi_analytical_plain)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0)
    got32 = _run_features(_feature_plan(model, data, sp, ems, torch.float32, cuda),
                          psi_analytical)
    torch.cuda.synchronize()
    assert f32_error(got32.cpu().numpy(), want.cpu().numpy()) <= F32_BUDGET[FEATURE_CASES[name]]


@pytest.mark.parametrize("name", FEATURE_BUDGETS)
def test_feature_kernel_float32_within_budget(cuda, name):
    model, data, sp, ems = feature_budget_case(name)
    golden = _run_features(_feature_plan(model, data, sp, ems, torch.float64, cuda),
                           psi_analytical_plain)
    got = _run_features(_feature_plan(model, data, sp, ems, torch.float32, cuda),
                        psi_analytical)
    torch.cuda.synchronize()
    assert f32_error(got.cpu().numpy(), golden.cpu().numpy()) <= F32_BUDGET[name]


def test_entry_point_launches_k1b_once(cuda):
    model, data, sp, ems, _ = feature_case("row_lag_fa", n_subjects=16, n_support=24)
    before = fused_psi.FEATURE_LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    assert fused_psi.FEATURE_LAUNCHES == before + 1
    assert pt.last_engine_decision(model)["engine"] == "fused"
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general", device="cpu")
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
@pytest.mark.parametrize("name", [n for n in ODE_CASES if n not in ("ode_expm", "ode_bdf")])
def test_ode_kernel_matches_twin_float64(cuda, name, solver, merge):
    plan = _ode_plan(name, torch.float64, cuda, solver)
    # K2a, or K2e for the cases with lag, fa or a covariate
    before = fused_ode.LAUNCHES + fused_ode.FEATURE_LAUNCHES
    got = _ode_run(plan, fused_ode.psi_ode, merge)
    torch.cuda.synchronize()
    assert fused_ode.LAUNCHES + fused_ode.FEATURE_LAUNCHES == before + 1
    want = _ode_run(plan, fused_ode.psi_ode_plain, merge)
    assert torch.isfinite(got).all()
    rel = ((got - want).abs() / want.abs().clamp(min=1.0)).max()
    assert float(rel) <= 1e-8


@pytest.mark.parametrize("name", [n for n in ODE_CASES if n not in ("ode_expm", "ode_bdf")])
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
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general", device="cpu")
    rel = np.abs(psi.cpu().numpy() - want.numpy()) / np.maximum(np.abs(want.numpy()), 1.0)
    assert rel.max() <= 1e-4


def test_rejected_rhs_routes_auto_to_general(cuda):
    """An RHS the CUDA generator rejects (``torch.lgamma``, outside its
    operation set) takes the general engine with the reason kept, and never
    a silent twin; the ``tanh`` RHS this test held runs fused since the
    elementwise set, one K2a launch, equal to the general engine within the
    controller's error."""
    data = pt.Data([pt.Subject.builder("a").bolus(0.0, 100.0, 0)
                    .observation(1.0, 5.0, 0).build()])
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    sp = np.array([[0.2, 10.0], [0.3, 20.0]])
    model = pt.ODE(
        lambda x, p, t, b, r, cov: torch.stack([-p[0] * torch.lgamma(2.0 + x[0]) + b[0]]),
        out=lambda x, p, t, cov: x[0:1] / p[1], nstates=1, ndrugs=1, nout=1)
    before = fused_ode.LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general" and "`lgamma`" in decision["reason"]
    assert psi.device.type == "cuda" and torch.isfinite(psi).all()
    assert fused_ode.LAUNCHES == before
    taken = pt.ODE(
        lambda x, p, t, b, r, cov: torch.stack([-p[0] * torch.tanh(x[0]) + b[0]]),
        out=lambda x, p, t, cov: x[0:1] / p[1], nstates=1, ndrugs=1, nout=1)
    psi = pt.log_likelihood_matrix(taken, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    assert pt.last_engine_decision(taken)["engine"] == "fused"
    assert fused_ode.LAUNCHES == before + 1
    want = pt.log_likelihood_matrix(taken, data, sp, ems, engine="general", device="cpu")
    rel = np.abs(psi.cpu().numpy() - want.numpy()) / np.maximum(np.abs(want.numpy()), 1.0)
    assert rel.max() <= 1e-4


# ---------------------------------------------------------------------------
# The ODE feature tier (K2e): covariates, lag, fa and init
# ---------------------------------------------------------------------------


def _k2e_case(name):
    if name == "covariate_model":
        return covariate_model_case(16, 20, seed=3)
    return ode_feature_case(name, n_subjects=16, n_support=20, seed=5)


@pytest.mark.parametrize("name", list(ODE_FEATURE_CASES) + ["covariate_model"])
def test_k2e_matches_twin_float64(cuda, name):
    model, data, sp, ems = _k2e_case(name)
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    plan = _FusedOdePsiPlan(model, grid, sp, lowered, cuda, torch.float64)
    for merge in ((True, False) if plan.merge_runs is not None else (True,)):
        before = (fused_ode.LAUNCHES, fused_ode.FEATURE_LAUNCHES)
        got = _ode_run(plan, fused_ode.psi_ode, merge)
        torch.cuda.synchronize()
        assert (fused_ode.LAUNCHES, fused_ode.FEATURE_LAUNCHES) == (before[0], before[1] + 1)
        want = _ode_run(plan, fused_ode.psi_ode_plain, merge)
        assert torch.isfinite(got).all()
        rel = ((got - want).abs() / want.abs().clamp(min=1.0)).max()
        assert float(rel) <= 1e-8


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["ode_dopri5", "ode_lag_fa", "covariate_model", "lag_fa",
                                  "two_inputs_lag", "cov_linear"])
def test_explicit_psi_does_not_depend_on_the_grid(cuda, name, dtype):
    """K2a and K2e on the persistent grid at a ragged shape (37 subjects x 45
    supports): one block (128 lanes, each marching several cells, captures and
    lag passes one after the other), three blocks, and as many as the card
    holds (a lane marches one cell) give the same psi bit for bit; in float64
    every cell within 1e-8 of the twin, one K2a or K2e launch a call."""
    if name.startswith("ode_"):
        model, data, sp, ems = ode_case(name)
        subjects = data.subjects()
        data = pt.Data([subjects[i % len(subjects)] for i in range(37)])
        sp = np.concatenate([sp] * 4)[:45] * np.linspace(0.9, 1.1, 45)[:, None]
    elif name == "covariate_model":
        model, data, sp, ems = covariate_model_case(37, 45, seed=6)
    else:
        model, data, sp, ems = ode_feature_case(name, n_subjects=37, n_support=45, seed=6)
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    plan = _FusedOdePsiPlan(model, grid, sp, lowered, cuda, dtype)
    kw = plan.kernel_kwargs()
    before = fused_ode.LAUNCHES + fused_ode.FEATURE_LAUNCHES
    runs = [fused_ode.psi_ode(*plan.streams, plan.support, plan.rhs, blocks=b, **kw)
            for b in (1, 3, None)]
    torch.cuda.synchronize()
    assert fused_ode.LAUNCHES + fused_ode.FEATURE_LAUNCHES == before + 3
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(runs[0].view(bits), runs[1].view(bits))
    assert torch.equal(runs[0].view(bits), runs[2].view(bits))
    if dtype == torch.float64:
        want = _ode_run(plan, fused_ode.psi_ode_plain)
        assert torch.isfinite(want).all()
        rel = ((runs[0] - want).abs() / want.abs().clamp(min=1.0)).max()
        assert float(rel) <= 1e-8


def test_auto_takes_k2e_for_the_covariate_model(cuda):
    """The reference's covariate example through the entry point: the fused
    plan, one K2e launch, the general engine within the controller's error."""
    model, data, sp, ems = covariate_model_case(64, 32, seed=1)
    before = fused_ode.FEATURE_LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    assert fused_ode.FEATURE_LAUNCHES == before + 1
    assert pt.last_engine_decision(model)["engine"] == "fused"
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general", device="cuda")
    rel = (psi - want).abs() / want.abs().clamp(min=1.0)
    assert torch.isfinite(psi).all() and float(rel.max()) <= 1e-4


# ---------------------------------------------------------------------------
# The SDE kernel (K3a): the same Philox numbers as its twin
# ---------------------------------------------------------------------------


def _readme_sde(nparticles, em_control="independent"):
    return pt.SDE(lambda x, p, t, r, cov: torch.stack([-x[1] * x[0], -(x[1] - p[0])]),
                  lambda p, t, cov: [0.0, p[2]],
                  init=lambda p, t, cov: [0.0, p[0]],
                  out=lambda x, p, t, cov: x[0:1] / p[1],
                  nparticles=nparticles, nstates=2, ndrugs=1, nout=1, seed=42,
                  em_control=em_control)


def _readme_inputs(R, S, sigma, seed=0):
    rng = np.random.RandomState(seed)
    subjects = []
    for i in range(R):
        b = pt.Subject.builder(f"r{i}").bolus(0.0, 100.0, 0)
        for t, v in zip((1.0, 2.0, 4.0, 8.0), (8.0, 6.2, 4.1, 1.8)):
            b = b.observation(t, float(v * np.exp(0.15 * rng.randn())), 0)
        subjects.append(b.build())
    sp = np.abs(np.array([0.2, 10.0, 0.05]) * (1 + 0.15 * rng.randn(S, 3)))
    sp[:, 2] *= sigma / 0.05
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.3, 0.1), 0.5))
    return pt.Data(subjects), sp, ems


def _sde_plan(model, data, sp, ems, dtype, device):
    from pharmsol_tpu_torch.likelihood.plans.sde import _FusedSdePsiPlan

    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedSdePsiPlan(model, grid, sp, lowered, device, dtype)


def _sde_run(plan, plain=False):
    from pharmsol_tpu_torch.ops import fused_sde

    fn = fused_sde.psi_sde_plain if plain else fused_sde.psi_sde
    return fn(*plan.streams, plan.support, plan.gen, **plan.kernel_kwargs())


def _cell_rel(got, want):
    got, want = got.double(), want.double()
    return (got - want).abs() / want.abs().clamp(min=1.0)


@pytest.mark.parametrize("sigma, em_control, P", [
    (0.0, "independent", 1000), (0.05, "independent", 300),
    # 3 x 2100 float64 values: above 48 KB, the launch opts in to more shared memory
    (0.2, "coupled", 2100)])
def test_sde_kernel_matches_twin_float64(cuda, sigma, em_control, P):
    from pharmsol_tpu_torch.ops import fused_sde

    data, sp, ems = _readme_inputs(3, 5, sigma)
    plan = _sde_plan(_readme_sde(P, em_control), data, sp, ems, torch.float64, cuda)
    before = fused_sde.LAUNCHES
    got = _sde_run(plan)
    torch.cuda.synchronize()
    assert fused_sde.LAUNCHES == before + 1
    want = _sde_run(plan, plain=True)
    assert torch.isfinite(got).all()
    assert float(_cell_rel(got, want).max()) <= 1e-9


def test_sde_kernel_float32_matches_the_float32_twin(cuda):
    data, sp, ems = _readme_inputs(4, 5, 0.05, seed=1)
    plan = _sde_plan(_readme_sde(500), data, sp, ems, torch.float32, cuda)
    rel = _cell_rel(_sde_run(plan), _sde_run(plan, plain=True))
    assert float((rel <= 1e-4).double().mean()) >= 0.99


def test_sde_philox_words_match_the_twin(cuda):
    from pharmsol_tpu_torch.ops import fused_sde, philox

    data, sp, ems = _readme_inputs(1, 1, 0.0)
    gen = _sde_plan(_readme_sde(8), data, sp, ems, torch.float64, cuda).gen
    ctr = torch.as_tensor(np.random.RandomState(3).randint(0, 2 ** 32, (4096, 4), dtype=np.int64),
                          device=cuda)
    for seed in (0, 7, (1 << 33) + 1):
        want = torch.stack(philox.philox4x32(*ctr.unbind(1), philox.seed_key(seed)), 1)
        assert torch.equal(fused_sde.philox_words(ctr, seed, gen), want)


def test_sde_entry_point_launches_once(cuda):
    from pharmsol_tpu_torch.ops import fused_sde

    data, sp, ems = _readme_inputs(3, 4, 0.0)
    model = _readme_sde(100)
    before = fused_sde.LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    assert fused_sde.LAUNCHES == before + 1
    assert pt.last_engine_decision(model)["engine"] == "fused"
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general", device="cpu")
    np.testing.assert_allclose(psi.cpu().numpy(), want.numpy(), rtol=1e-9, atol=0)


def test_sde_rejected_drift_routes_auto_to_general(cuda):
    """A vector-style drift, which the SDE plans of both packages refuse,
    takes the general engine with the reason kept; the ``tanh`` drift this
    test held runs fused since the elementwise set, one K3a launch, equal
    to the general engine at zero diffusion."""
    from pharmsol_tpu_torch.ops import fused_sde

    data = pt.Data([pt.Subject.builder("a").bolus(0.0, 100.0, 0)
                    .observation(1.0, 5.0, 0).build()])
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    sp = np.array([[0.2, 10.0]])
    model = pt.SDE(lambda x, p, t, r, cov: -p[0] * torch.tanh(x),
                   lambda p, t, cov: [0.0], out=lambda x, p, t, cov: x[0:1] / p[1],
                   nparticles=16, nstates=1, ndrugs=1, nout=1)
    before = fused_sde.LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general" and "vector-style code" in decision["reason"]
    assert psi.device.type == "cuda" and torch.isfinite(psi).all()
    assert fused_sde.LAUNCHES == before
    taken = pt.SDE(lambda x, p, t, r, cov: torch.stack([-p[0] * torch.tanh(x[0])]),
                   lambda p, t, cov: [0.0], out=lambda x, p, t, cov: x[0:1] / p[1],
                   nparticles=16, nstates=1, ndrugs=1, nout=1)
    psi = pt.log_likelihood_matrix(taken, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    assert pt.last_engine_decision(taken)["engine"] == "fused"
    assert fused_sde.LAUNCHES == before + 1
    want = pt.log_likelihood_matrix(taken, data, sp, ems, engine="general", device="cpu")
    np.testing.assert_allclose(psi.cpu().numpy(), want.numpy(), rtol=1e-9, atol=0)


def _assert_noise_cells(got, want, dtype):
    """Kernel and twin on the same Philox numbers: float64 99.9% of cells
    within 1e-9, float32 99% within 1e-4."""
    rel = _cell_rel(got, want).flatten()
    assert bool(torch.isfinite(rel).all())
    tol, share = (1e-9, 0.999) if dtype == torch.float64 else (1e-4, 0.99)
    assert float((rel <= tol).double().mean()) >= share


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sde_kernel_with_every_component_noisy_matches_twin(cuda, dtype):
    """No diffusion component is a literal zero: every state draws its
    normals (independent control, three slots)."""
    data, sp, ems = _readme_inputs(3, 5, 0.05, seed=2)
    model = pt.SDE(lambda x, p, t, r, cov: torch.stack([-x[1] * x[0], -(x[1] - p[0])]),
                   lambda p, t, cov: [0.05 * p[1], p[2]],
                   init=lambda p, t, cov: [0.0, p[0]],
                   out=lambda x, p, t, cov: x[0:1] / p[1],
                   nparticles=600, nstates=2, ndrugs=1, nout=1, seed=5)
    plan = _sde_plan(model, data, sp, ems, dtype, cuda)
    assert plan.gen.zero_diffusion == frozenset() and plan.em_control == "independent"
    _assert_noise_cells(_sde_run(plan), _sde_run(plan, plain=True), dtype)


def test_sde_kernel_with_diffusion_zero_at_run_time_matches_twin(cuda):
    """The README diffusion [0, sigma] with sigma = 0 on some supports: the
    second component stays noisy (it is zero only at run time), and its
    cells match the twin as at zero diffusion, the others as with noise."""
    data, sp, ems = _readme_inputs(4, 6, 0.05, seed=3)
    sp[::2, 2] = 0.0
    plan = _sde_plan(_readme_sde(700), data, sp, ems, torch.float64, cuda)
    assert plan.gen.zero_diffusion == frozenset({0})
    got, want = _sde_run(plan), _sde_run(plan, plain=True)
    assert float(_cell_rel(got[:, ::2], want[:, ::2]).max()) <= 1e-10
    _assert_noise_cells(got[:, 1::2], want[:, 1::2], torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["lag_fa", "two_inputs_inject"])
def test_k3b_split_march_with_a_structural_zero_matches_twin(cuda, name, dtype):
    """K3b's split march (lagged doses firing inside segments) on a model
    whose first diffusion component is a literal zero."""
    from pharmsol_tpu_torch.likelihood.plans.sde import _FusedSdePsiPlan
    from pharmsol_tpu_torch.ops import fused_sde

    model, data, sp, ems = sde_feature_case(name, 6, 7, seed=8, nparticles=500)
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    plan = _FusedSdePsiPlan(model, grid, sp, lowered, cuda, dtype)
    assert plan.gen.zero_diffusion == frozenset({0})
    kw = plan.kernel_kwargs()
    assert kw["lag_planes"] is not None
    before = fused_sde.FEATURE_LAUNCHES
    got = fused_sde.psi_sde(*plan.streams, plan.support, plan.gen, **kw)
    torch.cuda.synchronize()
    assert fused_sde.FEATURE_LAUNCHES == before + 1
    _assert_noise_cells(got, fused_sde.psi_sde_plain(*plan.streams, plan.support, plan.gen,
                                                     **kw), dtype)


@pytest.mark.parametrize("family", ["sde", "ode"])
def test_general_engine_on_the_card_takes_closures_with_constants(cuda, family):
    """Closures returning lists with Python constants (``[0.0, p[2]]``): the
    general engine puts every component on the working device."""
    data, sp, ems = _readme_inputs(3, 4, 0.0)
    if family == "sde":
        model = _readme_sde(64)
    else:
        model = pt.ODE(lambda x, p, t, b, r, cov: [-p[0] * x[0] + b[0], 0.0],
                       out=lambda x, p, t, cov: x[0:1] / p[1], nstates=2, ndrugs=1, nout=1)
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda", engine="general")
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general", device="cpu")
    assert psi.device.type == "cuda"
    np.testing.assert_allclose(psi.cpu().numpy(), want.numpy(), rtol=1e-9, atol=0)


# ---------------------------------------------------------------------------
# K2d (linear ODE models with expm) and the population fit
# ---------------------------------------------------------------------------


def _expm_plan(name, dtype, device):
    model, data, sp, ems = ode_case(name) if name == "ode_expm" else expm_case(
        name, 9, 20, seed=17)
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedOdePsiPlan(model, grid, sp, lowered, device, dtype)


@pytest.mark.parametrize("name", list(EXPM_CASES) + ["ode_expm"])
def test_k2d_matches_twin(cuda, name):
    """float64 within 1e-10 of the twin, float32 within the ``ode_expm`` row
    of the float64 twin, the same lost cells, one K2d launch a call and no
    K2a or K2e launch."""
    plan = _expm_plan(name, torch.float64, cuda)
    before = (fused_ode.LAUNCHES, fused_ode.FEATURE_LAUNCHES, fused_ode.EXPM_LAUNCHES)
    got = _ode_run(plan, fused_ode.psi_ode)
    got32 = _ode_run(_expm_plan(name, torch.float32, cuda), fused_ode.psi_ode)
    torch.cuda.synchronize()
    assert (fused_ode.LAUNCHES, fused_ode.FEATURE_LAUNCHES, fused_ode.EXPM_LAUNCHES) == (
        before[0], before[1], before[2] + 2)
    want = _ode_run(plan, fused_ode.psi_ode_plain)
    lost = ~torch.isfinite(want)
    assert bool(lost.any()) == (name == "poison")
    assert torch.equal(~torch.isfinite(got), lost) and torch.equal(~torch.isfinite(got32), lost)
    torch.testing.assert_close(got[~lost], want[~lost], rtol=1e-10, atol=0)
    assert f32_error(got32[~lost].cpu().numpy(),
                     want[~lost].cpu().numpy()) <= F32_BUDGET["ode_expm"]


def test_k2d_entry_point_launches_once_and_matches_the_general_engine(cuda):
    model, data, sp, ems = expm_case("transit", 12, 16, seed=4)
    before = fused_ode.EXPM_LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    assert fused_ode.EXPM_LAUNCHES == before + 1
    assert pt.last_engine_decision(model)["engine"] == "fused"
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general", device="cpu")
    np.testing.assert_allclose(psi.cpu().numpy(), want.numpy(), rtol=1e-9, atol=0)


def test_nonlinear_rhs_with_expm_routes_auto_to_general(cuda):
    model = pt.ODE(lambda x, p, t, b, r, cov: torch.stack([-p[0] * x[0] / (p[1] + x[0]) + b[0]]),
                   out=lambda x, p, t, cov: x[0:1] / p[2], nstates=1, ndrugs=1,
                   nout=1).with_solver("expm")
    data = pt.Data([pt.Subject.builder("a").bolus(0.0, 100.0, 0)
                    .observation(1.0, 5.0, 0).build()])
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    before = fused_ode.EXPM_LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, np.array([[10.0, 15.0, 30.0]]), ems,
                                   device="cuda")
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general" and "AFFINE" in decision["reason"]
    assert torch.isneginf(psi).all() and fused_ode.EXPM_LAUNCHES == before


def test_rhs_jvp_on_the_card_matches_torch_func_jvp(cuda):
    plan = _expm_plan("transit", torch.float64, cuda)
    gen, n = plan.rhs, 512
    rng = np.random.RandomState(2)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=cuda)

    x, v = dev(rng.randn(n, gen.n_states) * 20.0), dev(rng.randn(n, gen.n_states))
    p, t = dev(rng.uniform(0.05, 3.0, (n, gen.n_params))), dev(rng.uniform(0.0, 24.0, n))
    rate = dev(rng.uniform(0.0, 50.0, (n, gen.ninput)))

    def closure(xs):  # the closure in its style, on n lanes
        return torch.stack(fused_ode.call_rhs(
            gen, list(xs), list(p.t()), t, [torch.zeros_like(t)] * gen.ninput, list(rate.t()),
            None, (n,), torch.float64, cuda))

    want_f, want_jv = torch.func.jvp(closure, (x.t().contiguous(),), (v.t().contiguous(),))
    f, jv = fused_ode.rhs_jvp_on_device(gen, x, p, t, rate, v)
    torch.testing.assert_close(f, want_f.t(), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(jv, want_jv.t(), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# The closure styles: vector-style spellings and the elementwise set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, solver", [("short", "dopri5"), ("tmdd", "bdf"),
                                          ("transit", "expm")])
def test_style_vector_spelling_runs_the_list_style_library(cuda, name, solver):
    """A vector-style spelling's plan has the list-style header key; through
    the entry point it launches the same kernel once and gives the
    list-style model's psi in every cell."""
    from pharmsol_tpu_torch.utils import style_cases as sc

    vector, _ = sc.VECTOR_SPELLINGS[name]
    if name == "tmdd":
        model, data, sp, ems = stiff_case("tmdd", 6, 8, seed=3, solver="bdf")
    else:  # the 2-cmt oral RHS and the transit chain, list-style
        model, data, sp, ems = expm_case(name, 6, 8, seed=3)
        model = model.with_solver(solver)
    spelled = pt.ODE(vector, init=model._init, out=model._out, nstates=model.nstates(),
                     ndrugs=1, nout=model.nouteqs()).with_solver(solver)
    grid, lowered = model.lower(data.subjects()), ems.lower(model.resolve_output_label, 1)
    keys = [_FusedOdePsiPlan(m, grid, sp, lowered, cuda, torch.float64).rhs
            for m in (model, spelled)]
    assert keys[0].key == keys[1].key and (keys[0].style, keys[1].style) == ("lanes", "stacked")
    want = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    counts = (fused_ode.LAUNCHES, fused_ode.EXPM_LAUNCHES, fused_ode.BDF_LAUNCHES)
    got = pt.log_likelihood_matrix(spelled, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    assert pt.last_engine_decision(spelled)["engine"] == "fused"
    launched = [a - b for a, b in zip((fused_ode.LAUNCHES, fused_ode.EXPM_LAUNCHES,
                                       fused_ode.BDF_LAUNCHES), counts)]
    assert launched == {"dopri5": [1, 0, 0], "expm": [0, 1, 0], "bdf": [0, 0, 1]}[solver]
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel, solver", [("K2a", "dopri5"), ("K2e", "dopri5"),
                                            ("K2b", "kvaerno3"), ("K2c", "bdf")])
def test_style_math_model_kernel_matches_twin(cuda, kernel, solver):
    """The math model (every operation of the elementwise set, a state
    exponent; K2e with a time-varying weight and a lag) against its twin,
    float64: K2a and K2e within 1e-8, K2b and K2c every cell 1e-6 and 99%
    within 1e-8."""
    from pharmsol_tpu_torch.utils.style_cases import math_case

    model, data, sp, ems = math_case(8, 6, seed=9, solver=solver, features=kernel != "K2a")
    grid, lowered = model.lower(data.subjects()), ems.lower(model.resolve_output_label, 1)
    plan = _FusedOdePsiPlan(model, grid, sp, lowered, cuda, torch.float64)
    assert "pm_tanh(" in plan.rhs.source and "pm_erfc(" in plan.rhs.source
    got, want = _ode_run(plan, fused_ode.psi_ode), _ode_run(plan, fused_ode.psi_ode_plain)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    rel = _cell_rel(got, want)
    if kernel in ("K2a", "K2e"):
        assert float(rel.max()) <= 1e-8
    else:
        assert float(rel.max()) <= 1e-6 and float((rel <= 1e-8).double().mean()) >= 0.99


def test_style_tanh_sde_kernel_matches_twin(cuda):
    """K3a on a drift with a tanh term: at zero diffusion every cell within
    1e-10 of the twin."""
    from pharmsol_tpu_torch.utils.style_cases import readme_tanh_drift

    data, sp, ems = _readme_inputs(3, 4, 0.0)
    base = _readme_sde(200)
    model = pt.SDE(readme_tanh_drift, base._diffusion, init=base._init, out=base._out,
                   nparticles=200, nstates=2, ndrugs=1, nout=1, seed=42)
    plan = _sde_plan(model, data, sp, ems, torch.float64, cuda)
    assert "pm_tanh(" in plan.gen.source
    assert float(_cell_rel(_sde_run(plan), _sde_run(plan, plain=True)).max()) <= 1e-10


@pytest.mark.parametrize("which", ["closed", "expm"])
def test_small_fit_on_the_card_matches_the_cpu_fit(cuda, which):
    """``fit_population`` with no device argument runs on the card (every
    psi call one K1a or one K2d launch, the burn-in on the card from the
    port's threshold) and lands where the CPU fit lands."""
    from pharmsol_tpu_torch.optimize import weights
    from pharmsol_tpu_torch.utils.profiling import reset_stages, stage_counts

    data, ems, _ = population_10k_case(400)
    closed, ode = population_models()
    model = closed if which == "closed" else ode
    kw = dict(ranges=POPULATION_RANGES, init_points=128, max_cycles=4)
    reset_stages()
    before = (fused_psi.LAUNCHES, fused_ode.EXPM_LAUNCHES)
    assert pt.device().type == "cuda"  # the default: nothing here asked for the CPU
    got = pt.optimize.fit_population(model, data, ems, **kw)
    torch.cuda.synchronize()
    stages = stage_counts()
    calls = stages["npag/psi_device"][0]
    launched = (fused_psi.LAUNCHES - before[0], fused_ode.EXPM_LAUNCHES - before[1])
    assert launched == ((calls, 0) if which == "closed" else (0, calls))
    assert 400 * 128 >= weights._DEVICE_MIN_CELLS and stages["npag/weights_device"][0] >= 1
    want = pt.optimize.fit_population(model, data, ems, device="cpu", engine="general", **kw)
    assert got.cycles == want.cycles
    assert abs(got.log_likelihood - want.log_likelihood) <= 1e-6 * abs(want.log_likelihood)
    fast = lambda fit: float(fit.weights[fit.support[:, 1] > 0.2].sum())  # noqa: E731
    assert abs(fast(got) - fast(want)) <= 1e-3


# -- stiff ODE models: the SDIRK tier (K2b) and the BDF tier (K2c) ----------


def _stiff_plan(name, solver, dtype, device, smoke_shape=False, **kw):
    from pharmsol_tpu_torch.utils.f32_budget import STIFF_CASES, stiff_case

    if smoke_shape:
        # the shape and seed at which chip_smoke.py holds these two: five dose
        # classes x 48 supports are 240 different marches, enough for a share
        model, data, sp, ems = stiff_case(
            name, 64, 48, seed=20261016 + list(STIFF_CASES).index(name), solver=solver)
    else:
        model, data, sp, ems = stiff_case(name, 9, 20, seed=17, solver=solver)
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedOdePsiPlan(model, grid, sp, lowered, device, dtype, **kw)


@pytest.mark.parametrize("solver", ["bdf", "trbdf2", "kvaerno3", "kvaerno5"])
@pytest.mark.parametrize("name", ["two_cmt", "lag_infusion", "tmdd", "cov_affine",
                                  "two_outputs_cens", "poison"])
def test_stiff_kernels_match_twin(cuda, name, solver):
    """K2b and K2c: float64 within 1e-8 of the twin (the K2a/K2e rule),
    merged and per segment where the plan merges, the same lost cells, one
    launch of the solver's tier a call and no other. On the TMDD right-hand
    side the twin's Jacobian (``torch.func.jvp``) and the kernel's
    (``rhs_jvp``) differ in the last bits and a step decision at a rounding
    tie flips in a few cells of a thousand: there every cell is within 1e-6
    and 99% of them within 1e-8, chip_smoke.py's rule."""
    plan = _stiff_plan(name, solver, torch.float64, cuda,
                       smoke_shape=name in ("tmdd", "poison"))
    for merge in ((True, False) if plan.merge_runs is not None else (False,)):
        before = (fused_ode.LAUNCHES, fused_ode.FEATURE_LAUNCHES, fused_ode.EXPM_LAUNCHES,
                  fused_ode.SDIRK_LAUNCHES, fused_ode.BDF_LAUNCHES)
        got = _ode_run(plan, fused_ode.psi_ode, merge)
        torch.cuda.synchronize()
        after = (fused_ode.LAUNCHES, fused_ode.FEATURE_LAUNCHES, fused_ode.EXPM_LAUNCHES,
                 fused_ode.SDIRK_LAUNCHES, fused_ode.BDF_LAUNCHES)
        assert tuple(a - b for a, b in zip(after, before)) == (
            (0, 0, 0, 0, 1) if solver == "bdf" else (0, 0, 0, 1, 0))
        want = _ode_run(plan, fused_ode.psi_ode_plain, merge)
        lost = ~torch.isfinite(want)
        assert bool(lost.any()) == (name == "poison") and not bool(lost.all())
        assert torch.equal(~torch.isfinite(got), lost)
        rel = ((got - want).abs() / want.abs().clamp(min=1.0))[~lost]
        if name in ("tmdd", "poison"):
            assert float(rel.max()) <= 1e-6
            assert float((rel <= 1e-8).double().mean()) >= 0.99
        else:
            assert float(rel.max()) <= 1e-8


STIFF_SOLVERS = ("bdf", "trbdf2", "kvaerno3", "kvaerno5")


@pytest.fixture(scope="module")
def stiff_libraries():
    """Every (case, implicit solver) library of ``STIFF_CASES``, built at once
    (one nvcc each) before the tests below load them one by one."""
    from pharmsol_tpu_torch.ops import _build
    from pharmsol_tpu_torch.utils.f32_budget import STIFF_CASES, stiff_case

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused psi kernel has no CPU mode)")
    targets = []
    for name in STIFF_CASES:
        for solver in STIFF_SOLVERS:
            model, data, sp, ems = stiff_case(name, 1, 2, seed=1, solver=solver)
            plan = _FusedOdePsiPlan(model, model.lower(data.subjects()), sp,
                                    ems.lower(model.resolve_output_label, model.nouteqs()),
                                    torch.device("cuda"), torch.float64)
            targets.append(_build.generated_target(_build.ode_kind(solver), plan.rhs))
    _build.build_many(targets)


def _stiff_rule(got, want, name):
    """The kernel-twin rule of the implicit tiers: the same lost cells, every
    other cell within 1e-8 relative; on the TMDD and the poison case (a
    rounding tie in a step decision flips in a few cells of a thousand) every
    cell within 1e-6 and 99% of them within 1e-8."""
    lost = ~torch.isfinite(want)
    assert torch.equal(~torch.isfinite(got), lost)
    rel = ((got - want).abs() / want.abs().clamp(min=1.0))[~lost]
    if rel.numel() == 0:
        return
    if name in ("tmdd", "poison"):
        assert float(rel.max()) <= 1e-6
        assert float((rel <= 1e-8).double().mean()) >= 0.99
    else:
        assert float(rel.max()) <= 1e-8


@pytest.mark.parametrize("solver", STIFF_SOLVERS)
@pytest.mark.parametrize("name", ["two_cmt", "binding_init", "separated_rates", "lag_infusion",
                                  "michaelis_menten", "tmdd", "cov_affine", "two_outputs_cens",
                                  "poison"])
def test_implicit_kernels_match_twin_on_one_ragged_row(cuda, stiff_libraries, name, solver):
    """K2b and K2c's persistent grid on one subject x 200 supports (six
    warps and a ragged seventh), merged and per segment where the plan
    merges, against the unchanged twin under the kernel-twin rule."""
    from pharmsol_tpu_torch.utils.f32_budget import STIFF_CASES, stiff_case

    model, data, sp, ems = stiff_case(name, 1, 200, seed=31 + list(STIFF_CASES).index(name),
                                      solver=solver)
    plan = _FusedOdePsiPlan(model, model.lower(data.subjects()), sp,
                            ems.lower(model.resolve_output_label, model.nouteqs()), cuda,
                            torch.float64)
    for merge in ((True, False) if plan.merge_runs is not None else (False,)):
        got = _ode_run(plan, fused_ode.psi_ode, merge)
        torch.cuda.synchronize()
        assert tuple(got.shape) == (1, 200)
        _stiff_rule(got, _ode_run(plan, fused_ode.psi_ode_plain, merge), name)


@pytest.mark.parametrize("name, solver", [("tmdd", "bdf"), ("tmdd", "kvaerno5"),
                                          ("tmdd", "trbdf2"), ("lag_infusion", "kvaerno3"),
                                          ("poison", "bdf"), ("poison", "kvaerno5")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_implicit_psi_does_not_depend_on_the_grid(cuda, name, solver, dtype):
    """Three persistent grids (one block: every lane marches several cells;
    two blocks; as many as the card holds, where a lane marches one) give the
    same psi bit for bit: a cell's result does not depend on the lane that
    marched it. In float64 the poison case loses the same cells as the twin
    (float32 is held to the float64 twin's budget elsewhere)."""
    plan = _stiff_plan(name, solver, dtype, cuda, smoke_shape=True)
    kw = plan.kernel_kwargs()
    runs = [fused_ode.psi_ode(*plan.streams, plan.support, plan.rhs, blocks=b, **kw)
            for b in (1, 2, None)]
    torch.cuda.synchronize()
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(runs[0].view(bits), runs[1].view(bits))
    assert torch.equal(runs[0].view(bits), runs[2].view(bits))
    if name == "poison" and dtype == torch.float64:
        want = _ode_run(plan, fused_ode.psi_ode_plain)
        lost = ~torch.isfinite(want)
        assert bool(lost.any()) and not bool(lost.all())
        assert torch.equal(~torch.isfinite(runs[0]), lost)


def test_implicit_grid_is_sized_by_the_occupancy_query(cuda):
    """The implicit library reports its resident blocks per SM; the explicit
    library reports its own through its query (K2a and K2e, dopri5 and
    tsit5) and has not the implicit one."""
    from pharmsol_tpu_torch.ops import _build

    plan = _stiff_plan("tmdd", "bdf", torch.float64, cuda)
    lib = _build.generated_target(_build.ode_kind("bdf"), plan.rhs).path
    _ode_run(plan, fused_ode.psi_ode)
    query = fused_ode.implicit_occupancy_of(lib)
    for is_f64 in (False, True):
        for cap in (3, 5):
            assert 1 <= query(is_f64, False, cap) <= 16
    assert fused_ode.explicit_occupancy_of(lib) is None
    explicit = _ode_plan("ode_dopri5", torch.float64, cuda)
    _ode_run(explicit, fused_ode.psi_ode)
    explicit_lib = _build.generated_target(_build.ODE, explicit.rhs).path
    assert fused_ode.implicit_occupancy_of(explicit_lib) is None
    query = fused_ode.explicit_occupancy_of(explicit_lib)
    for is_f64 in (False, True):
        for feature in (False, True):
            for code in (0, 1):
                assert 1 <= query(is_f64, feature, code) <= 16


@pytest.mark.parametrize("cap", [1, 3, 5])
def test_bdf_order_cap_reaches_the_kernel(cuda, cap):
    plan = _stiff_plan("tmdd", "bdf", torch.float64, cuda, bdf_max_order=cap)
    got = _ode_run(plan, fused_ode.psi_ode)
    torch.cuda.synchronize()
    want = _ode_run(plan, fused_ode.psi_ode_plain)
    assert torch.isfinite(want).all()
    assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) <= 1e-8


@pytest.mark.parametrize("solver", ["bdf", "trbdf2", "kvaerno3", "kvaerno5"])
def test_stiff_kernel_float32_within_the_bdf_budget(cuda, solver):
    golden = _ode_run(_stiff_plan("tmdd", solver, torch.float64, cuda), fused_ode.psi_ode_plain)
    got = _ode_run(_stiff_plan("tmdd", solver, torch.float32, cuda), fused_ode.psi_ode)
    torch.cuda.synchronize()
    assert f32_error(got.cpu().numpy(), golden.cpu().numpy()) <= F32_BUDGET["ode_bdf"]


@pytest.mark.parametrize("solver", ["bdf", "esdirk34"])
def test_stiff_entry_point_launches_once_and_matches_the_general_engine(cuda, solver):
    from pharmsol_tpu_torch.utils.f32_budget import stiff_case

    model, data, sp, ems = stiff_case("tmdd", 6, 10, seed=4, solver=solver)
    before = (fused_ode.SDIRK_LAUNCHES, fused_ode.BDF_LAUNCHES)
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device="cuda")
    torch.cuda.synchronize()
    assert (fused_ode.SDIRK_LAUNCHES - before[0], fused_ode.BDF_LAUNCHES - before[1]) == (
        (0, 1) if solver == "bdf" else (1, 0))
    assert pt.last_engine_decision(model)["engine"] == "fused"
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general", device="cpu")
    rel = np.abs(psi.cpu().numpy() - want.numpy()) / np.maximum(np.abs(want.numpy()), 1.0)
    assert rel.max() <= 1e-3


# ---------------------------------------------------------------------------
# K3b: the SDE feature tier; K1c: the rest of the closed-form feature tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [False, True])
@pytest.mark.parametrize("name", list(SDE_FEATURE_CASES))
def test_k3b_matches_twin_float64(cuda, name, sigma):
    """Every mode of SDE_FEATURE_CASES: kernel and twin draw the same Philox
    numbers; every cell within 1e-10 at zero diffusion, 99.9% within 1e-9
    with noise."""
    from pharmsol_tpu_torch.likelihood.plans.sde import _FusedSdePsiPlan
    from pharmsol_tpu_torch.ops import fused_sde

    model, data, sp, ems = sde_feature_case(name, 7, 9, seed=4, nparticles=300, sigma=sigma)
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    plan = _FusedSdePsiPlan(model, grid, sp, lowered, cuda, torch.float64)
    kw = plan.kernel_kwargs()
    before = (fused_sde.LAUNCHES, fused_sde.FEATURE_LAUNCHES)
    got = fused_sde.psi_sde(*plan.streams, plan.support, plan.gen, **kw)
    torch.cuda.synchronize()
    feature = name != "init_rows"
    assert (fused_sde.LAUNCHES, fused_sde.FEATURE_LAUNCHES) == (
        before[0] + (not feature), before[1] + feature)
    want = fused_sde.psi_sde_plain(*plan.streams, plan.support, plan.gen, **kw)
    rel = ((got - want).abs() / want.abs().clamp(min=1.0)).flatten()
    assert bool(torch.isfinite(rel).all())
    if sigma:
        assert float((rel <= 1e-9).double().mean()) >= 0.999
    else:
        assert float(rel.max()) <= 1e-10


def test_k3b_entry_point_launches_once(cuda):
    from pharmsol_tpu_torch.ops import fused_sde

    model, data, sp, ems = sde_covariate_model_case(6, 5, nparticles=200)
    before = (fused_sde.LAUNCHES, fused_sde.FEATURE_LAUNCHES)
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device=cuda, engine="fused")
    torch.cuda.synchronize()
    assert (fused_sde.LAUNCHES, fused_sde.FEATURE_LAUNCHES) == (before[0], before[1] + 1)
    assert tuple(psi.shape) == (6, 5) and bool(torch.isfinite(psi).all())


@pytest.mark.parametrize("name", list(K1C_CASES))
def test_k1c_matches_twin(cuda, name):
    """Every case of K1C_CASES: float64 within 1e-10 relative, float32
    against the float64 twin within the case's budget row; one K1c launch."""
    model, data, sp, ems = k1c_case(name, 33, 41, seed=6)
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    out = {}
    for dtype in (torch.float64, torch.float32):
        plan = _FusedPsiPlan(model, grid, sp, lowered, cuda, dtype)
        kw = plan.kernel_kwargs()
        before = fused_psi.K1C_LAUNCHES
        out[dtype] = psi_analytical(*plan.streams, plan.support, **kw)
        torch.cuda.synchronize()
        assert fused_psi.K1C_LAUNCHES == before + 1
        if dtype == torch.float64:
            twin = psi_analytical_plain(*plan.streams, plan.support, **kw)
    torch.testing.assert_close(out[torch.float64], twin, rtol=1e-10, atol=0)
    assert f32_error(out[torch.float32].double().cpu().numpy(),
                     twin.cpu().numpy()) <= F32_BUDGET[K1C_CASES[name]]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["row_lag_fa", "segment", "levels", "planes", "init_planes"])
def test_feature_grid_walks_rows_per_support(cuda, name, dtype):
    """K1b's persistent grid at R and S that are not multiples of the
    128-support tile (R = 301, S = 300: three tiles, the last one ragged) with
    1 and 3 blocks a tile and the card's full grid (each block walking more
    rows than the grid has): the same psi bit for bit, float64 within 1e-10
    of the twin."""
    model, data, sp, ems, mode = feature_case(name, n_subjects=301, n_support=300, seed=13)
    plan = _feature_plan(model, data, sp, ems, dtype, cuda)
    assert plan.mode == mode
    kw = plan.kernel_kwargs()
    runs = [psi_analytical(*plan.streams, plan.support, **kw, blocks=b) for b in (3, 9, None)]
    torch.cuda.synchronize()
    bits = [r.view(torch.int64 if dtype == torch.float64 else torch.int32) for r in runs]
    assert torch.equal(bits[0], bits[1]) and torch.equal(bits[0], bits[2])
    if dtype == torch.float64:
        want = psi_analytical_plain(*plan.streams, plan.support, **kw)
        torch.testing.assert_close(runs[2], want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("kernel", ["K1b", "K1c"])
def test_lag_and_fa_rows_on_the_card(cuda, kernel):
    """A covariate-free lag and fa reach the kernel as one row per support
    (row stride 0): against the same values as [R, S] planes, bit for bit,
    and against the twin within 1e-10 (float64)."""
    if kernel == "K1b":
        model, data, sp, ems, _ = feature_case("row_lag_fa", n_subjects=77, n_support=150,
                                               seed=14)
    else:
        model, data, sp, ems = k1c_case("depth_levels", 77, 150, seed=14)
    plan = _feature_plan(model, data, sp, ems, torch.float64, cuda)
    kw = plan.kernel_kwargs()
    R, S = plan.streams[0].shape[0], sp.shape[0]
    assert tuple(kw["lag_plane"].shape) == (1, S)
    rows = psi_analytical(*plan.streams, plan.support, **kw)
    planes = psi_analytical(*plan.streams, plan.support, **dict(kw, **{
        k: kw[k].expand(R, S).contiguous() for k in ("lag_plane", "fa_plane")
        if kw[k] is not None}))
    torch.cuda.synchronize()
    assert torch.equal(rows.view(torch.int64), planes.view(torch.int64))
    want = psi_analytical_plain(*plan.streams, plan.support, **kw)
    torch.testing.assert_close(rows, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("name", ["dynamic_lag_fa", "fa_only"])
def test_k1c_slot_tables_on_a_single_row(cuda, name):
    """One subject with one occasion (R = 1) and a lag or fa that changes
    with time or a covariate: the per-dose slot planes, [1, S] each, reach
    the kernel with a row stride of S; one K1c launch through
    ``log_likelihood_matrix``, float64 within 1e-10 of the twin."""
    model, data, sp, ems = k1c_case(name, 1, 140, seed=6)
    plan = _feature_plan(model, data, sp, ems, torch.float64, cuda)
    assert plan.streams[0].shape[0] == 1
    assert plan.lag_slots is not None or plan.fa_slots is not None
    kw = plan.kernel_kwargs()
    got = psi_analytical(*plan.streams, plan.support, **kw)
    torch.testing.assert_close(got, psi_analytical_plain(*plan.streams, plan.support, **kw),
                               rtol=1e-10, atol=0)
    before = fused_psi.K1C_LAUNCHES
    psi = pt.log_likelihood_matrix(model, data, sp, ems, device=cuda, engine="fused")
    torch.cuda.synchronize()
    assert fused_psi.K1C_LAUNCHES == before + 1
    torch.testing.assert_close(psi, plan.finalize(got), rtol=1e-10, atol=0)


@pytest.mark.parametrize("case", ["levels", "levels_3cmt", "depth_levels", "depth_3cmt"])
def test_level_tables_prepared_once_per_support(cuda, case):
    """Levels mode (K1b's level tables, K1c's lag_depth): the level models
    prepared once per (level, support) into the table that the launch's
    prologue kernel fills, loaded at each change of depth; float64 within
    1e-10 of the twin on a grid of 5 blocks and on the card's full grid,
    the two bit for bit alike."""
    if case.startswith("levels"):
        model, data, sp, ems, _ = feature_case(case, n_subjects=70, n_support=260, seed=15)
    else:
        model, data, sp, ems = k1c_case(case, 70, 260, seed=15)
    plan = _feature_plan(model, data, sp, ems, torch.float64, cuda)
    assert plan.mode == "levels"
    kw = plan.kernel_kwargs()
    got = psi_analytical(*plan.streams, plan.support, **kw, blocks=5)
    full = psi_analytical(*plan.streams, plan.support, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, psi_analytical_plain(*plan.streams, plan.support, **kw),
                               rtol=1e-10, atol=0)
    assert torch.equal(got.view(torch.int64), full.view(torch.int64))


def test_feature_grid_is_sized_by_the_occupancy_query(cuda):
    """The kernel's occupancy query answers for every structure, dtype and
    tier, K1a, K1b and K1c (1-16 blocks of 128 an SM), refuses a tier it does
    not have, and the level table's width per structure is positive."""
    from pharmsol_tpu_torch.ops import _build

    lib = _build.load_library()
    import ctypes

    for code in range(len(STRUCTURES)):
        assert lib.fused_psi_prep_fields(code) > 0
        for is_f64 in (0, 1):
            for tier in (0, 1, 2):
                blocks = ctypes.c_int(0)
                assert lib.fused_psi_occupancy(is_f64, code, tier,
                                               ctypes.addressof(blocks)) == 0
                assert 1 <= blocks.value <= 16
            assert lib.fused_psi_occupancy(is_f64, code, 3, ctypes.addressof(blocks)) != 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["one_compartment_with_absorption",
                                  "two_compartments_with_absorption",
                                  "three_compartments_cl_with_absorption", "three_outputs"])
def test_k1a_grid_walks_rows_per_support(cuda, case, dtype):
    """K1a's persistent grid at R = 301 and S = 300 (three tiles of 128
    supports, the last one ragged) with 1 and 3 blocks a tile, more blocks
    than the grid has rows, and the card's full grid: one K1a launch each,
    the same psi bit for bit, float64 within 1e-10 of the twin."""
    from test_torch_k1_host import K1A_GRID_CASES, k1a_case

    structure, _, _, opts = K1A_GRID_CASES[case]
    model, data, sp, ems = k1a_case(structure, 301, 300, seed=17, **opts)
    plan = _feature_plan(model, data, sp, ems, dtype, cuda)
    kw = plan.kernel_kwargs()
    before = fused_psi.LAUNCHES
    runs = [psi_analytical(*plan.streams, plan.support, **kw, blocks=b)
            for b in (3, 9, 3 * 301 + 1, None)]
    torch.cuda.synchronize()
    assert fused_psi.LAUNCHES == before + 4
    bits = [r.view(torch.int64 if dtype == torch.float64 else torch.int32) for r in runs]
    assert all(torch.equal(bits[0], b) for b in bits[1:])
    if dtype == torch.float64:
        want = psi_analytical_plain(*plan.streams, plan.support, **kw)
        torch.testing.assert_close(runs[3], want, rtol=1e-10, atol=0)


# -- the replicate layer and the device NCA batch (no kernel of the table) ---------


def _replicate_pieces(device):
    """The Laplace objective's pieces over 6 one-compartment subjects on
    ``device`` (no fit) and bootstrap weights for 4 lanes."""
    rng = np.random.default_rng(5)
    subjects = []
    for i in range(6):
        ke = 0.25 * np.exp(0.3 * rng.standard_normal())
        v = 10.0 * np.exp(0.15 * rng.standard_normal())
        b = pt.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t in (0.5, 2.0, 6.0, 12.0, 24.0):
            b = b.observation(t, float(100.0 * np.exp(-ke * t) / v
                                       * (1 + 0.08 * rng.standard_normal())), 0)
        subjects.append(b.build())
    model = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)
    rems = pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.proportional(0.2))
    intro = {}
    pt.optimize.fit_laplace(model, pt.Data(subjects), rems, [0.4, 8.0], _introspect=intro,
                            _build_only=True, device=device)
    W = rng.integers(0, 3, size=(4, 6)).astype(float)
    return intro, W


def test_batched_objective_and_refits_on_the_card_match_the_cpu(cuda):
    """One batched objective + gradient at 4 lanes (1e-12 / 1e-10) and a
    4-lane refit of 5 steps (1e-8; on the card replayed from its CUDA graph,
    as the API runs it), card against CPU, float64."""
    from pharmsol_tpu_torch.optimize._lbfgs import batch_value_and_grad_fn
    from pharmsol_tpu_torch.optimize.bootstrap import _vectorized_refits

    out = {}
    for dev in ("cpu", "cuda"):
        intro, W = _replicate_pieces(dev)
        w = torch.tensor(W, device=dev)
        fn = intro["neg_laplace_w_lanes"]
        z = intro["psi0"].expand(4, -1).clone()
        v, g = batch_value_and_grad_fn(lambda Z: fn(Z, w))(z)
        Z, G, F = _vectorized_refits(fn, intro["psi0"], w, 5, intro["lanes_value_and_grad"])
        out[dev] = (v.cpu().numpy(), g.cpu().numpy(), Z, F)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-12)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(out["cuda"][3], out["cpu"][3], rtol=1e-8)


def test_cuda_graph_replays_equal_the_eager_evaluations(cuda):
    """``_lbfgs.cuda_graphed``: the first call eager, the second captured,
    every later one a replay; each result equal to the eager one on the same
    input (a log-barrier objective, batched and scalar); a new shape raises."""
    from pharmsol_tpu_torch.optimize._lbfgs import batch_value_and_grad_fn, value_and_grad_fn

    c = torch.tensor([3.0, 2.0, 4.0], dtype=torch.float64, device=cuda)[:, None]

    def fn(Z):
        return torch.sum((Z - c) ** 2, dim=-1) - 4.0 * torch.sum(torch.log(Z), dim=-1)

    eager, graph = batch_value_and_grad_fn(fn), batch_value_and_grad_fn(fn, graph=True)
    one, one_graph = (value_and_grad_fn(lambda z: fn(z[None])[0]),
                      value_and_grad_fn(lambda z: fn(z[None])[0], graph=True))
    for k in range(4):
        z = torch.full((3, 2), 0.5 + k, dtype=torch.float64, device=cuda)
        for a, b in zip(eager(z), graph(z)):
            torch.testing.assert_close(b, a, rtol=0, atol=0)
        v, g = one(z[0])
        vv, gg = one_graph(z[0])
        assert vv == v
        torch.testing.assert_close(gg, g, rtol=0, atol=0)
    with pytest.raises(ValueError, match="captured for"):
        graph(torch.full((3, 3), 1.5, dtype=torch.float64, device=cuda))


def test_batch_nca_device_on_the_card_matches_the_host(cuda):
    from pharmsol_tpu_torch.nca.batch import batch_nca
    from pharmsol_tpu_torch.nca.batch_device import batch_nca_device

    rng = np.random.RandomState(2)
    t = np.linspace(0.25, 24.0, 32)
    ka = 1.2 * np.exp(0.2 * rng.randn(500))
    ke = 0.2 * np.exp(0.3 * rng.randn(500))
    v = 30.0 * np.exp(0.2 * rng.randn(500))
    c = np.abs(100.0 * ka[:, None] / (ka - ke)[:, None] * (
        np.exp(-ke[:, None] * t[None, :]) - np.exp(-ka[:, None] * t[None, :])) / v[:, None]) + 1e-9
    host = batch_nca(t, c, dose=100.0)
    dev = batch_nca_device(t, c, dose=100.0, device=cuda)
    assert set(dev) == set(host)
    for key, h in host.items():
        nan = np.isnan(h)
        np.testing.assert_array_equal(np.isnan(dev[key]), nan, err_msg=key)
        np.testing.assert_allclose(dev[key][~nan], h[~nan], rtol=1e-9, err_msg=key)
