"""The device split of the fused plans' feature tiers
(``pharmsol_tpu_torch/parallel/mesh.py`` through
``likelihood/plans/split.py``), float64 on the CPU.

Each case puts a feature's row-carrying tensors on the split: K1b's
parameter planes ``[L, n_micro, R, S]`` (rows on axis 2) and init planes
``[N, R, S]`` (axis 1); K1c's per-row lag planes with the post-fire slot
stream, and its dynamic lag/fa slot planes; K2e's lag/fa planes ``[n, R,
S]`` (axis 1), its init planes with a covariate stream, and its dynamic
slot planes; K3b's lag planes, init planes and dynamic slot planes at zero
diffusion. Five occasion rows divide neither mesh ((8, 1): three shards of
the last row repeated; (4, 2)). The split plain twins are held within 1e-12
relative to the whole twin, and within 1e-10 relative to the JAX package on
the same numpy-seeded inputs: its ``engine='xla'`` psi for the closed forms
and the SDE, its ODE Pallas kernel in interpret mode (``engine='pallas'``,
how the JAX package's own tests run it) for K2e, whose fused march differs
from the segment march within the solver's tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.parallel import log_likelihood_matrix_sharded, population_mesh
from pharmsol_tpu_torch.utils import f32_budget as fb

N_ROWS, N_SUPPORT = 5, 4


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _closed(name):
    return lambda lib, stack: fb.feature_case(name, N_ROWS, N_SUPPORT, lib=lib)[:4]


def _k1c(name):
    return lambda lib, stack: fb.k1c_case(name, N_ROWS, N_SUPPORT, lib=lib)


def _ode(name):
    return lambda lib, stack: fb.ode_feature_case(name, N_ROWS, N_SUPPORT, lib=lib, stack=stack)


def _sde(name):
    return lambda lib, stack: fb.sde_feature_case(name, N_ROWS, N_SUPPORT, lib=lib, stack=stack,
                                                  sigma=False)


# name -> (case(lib, stack), the JAX engine held against, {launch argument
# the case must split: its row axis})
CASES = {
    "k1b_param_planes": (_closed("planes"), "xla", {"param_planes": 2}),
    "k1b_init_planes": (_closed("init_planes"), "xla", {"init_planes": 1, "init_mask": 0}),
    "k1c_row_lag_planes": (_k1c("post_dynamic_lag"), "xla",
                           {"lag_plane": 0, "seg_postdepth": 0}),
    "k1c_dynamic_slots": (_k1c("dynamic_lag_fa"), "xla", {"lag_plane": 0, "fa_plane": 0}),
    "k2e_lag_fa_planes": (_ode("lag_fa"), "pallas", {"lag_plane": 1, "fa_plane": 1}),
    "k2e_init_planes_cov": (_ode("init_planes"), "pallas",
                            {"init_planes": 1, "cov_streams": 0}),
    "k2e_dynamic_slots_cov": (_ode("dyn_cov_lag"), "pallas",
                              {"lag_plane": 1, "cov_streams": 0}),
    "k3b_lag_planes": (_sde("lag"), "xla", {"lag_planes": 1}),
    "k3b_init_planes_cov": (_sde("init_planes"), "xla", {"init_planes": 1, "cov_streams": 0}),
    "k3b_dynamic_slots": (_sde("dyn_lag_fa"), "xla", {"lag_planes": 1, "fa_planes": 1}),
}
SLOTS = ("k1c_dynamic_slots", "k2e_dynamic_slots_cov", "k3b_dynamic_slots")


def _split_arguments(model, data, sp, ems) -> tuple:
    """The fused plan's launch: (keyword arguments, row axes)."""
    from pharmsol_tpu_torch.likelihood.matrix import _fused_plan

    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    plan = _fused_plan(model, grid, np.asarray(sp, np.float64), lowered,
                       torch.device("cpu"), torch.float64)
    _, _, kwargs, axes = plan.launch_spec()
    return plan, kwargs, axes


def _rel(got, want) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.any()
    return float((np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1.0)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_split_feature_tier_matches_whole_and_jax(case):
    make, jax_engine, split = CASES[case]
    model, data, sp, ems = make(pt, torch.stack)
    plan, kwargs, axes = _split_arguments(model, data, sp, ems)
    assert plan.R == N_ROWS
    for key, axis in split.items():
        assert kwargs[key] is not None and axes[key] == axis, key
    if case in SLOTS:
        assert kwargs["lag_slots"] is not None
    whole = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused", device="cpu")
    jm, jdata, jsp, jems = make(pst, jnp.stack)
    want = np.asarray(jax_psi(jm, jdata, jsp, jems, engine=jax_engine))
    for shape in ((8, 1), (4, 2)):
        mesh = population_mesh(shape=shape, devices=["cpu"] * (shape[0] * shape[1]))
        got = log_likelihood_matrix_sharded(model, data, sp, ems, mesh=mesh, engine="fused")
        assert got.shape == (N_ROWS, N_SUPPORT) and got.dtype == torch.float64
        assert _rel(got, whole) <= 1e-12, shape
        assert _rel(got, want) <= 1e-10, shape
