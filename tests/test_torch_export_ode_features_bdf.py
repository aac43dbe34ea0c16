"""``export_psi`` of the features model of
``test_torch_export_ode_features.py`` (a time-varying covariate in the RHS,
a lag, an fa, an infusion) under bdf: the covariate is read by the RHS
program and by its symbolic Jacobian, whose lanes carry a trailing axis of
the Jacobian's columns (``engine/lanes.py::RhsLanes.bind``). The artifact's
psi is held within 1e-10 relative to the port's eager ``engine='general'``
and to the JAX package's artifact, float64 on the CPU. Newton converges
under a slightly wrong Jacobian, so psi cannot show a wrong covariate read
there: the lane programs' RHS and Jacobian are also held to the eager
engine's ``vmap`` and ``jacfwd`` at times before, between and after the
knots (1e-12 of the largest entry)."""

import numpy as np
import torch
from test_torch_export_ode import _on_the_cpu  # noqa: F401
from test_torch_export_ode_features import SUPPORT, _check_features, _model

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.engine.grid import CovView
from pharmsol_tpu_torch.engine.lanes import RhsLanes
from pharmsol_tpu_torch.engine.ode import lane_jacobian, lane_rhs


def test_export_features_bdf(tmp_path):
    _check_features("bdf", tmp_path, 1e-10)


def test_exported_jacobian_reads_the_covariate_per_lane():
    def close(got, want):
        return float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())

    rhs = _model(pt, torch)._diffeq
    # 2 rows, one covariate with knots at 0 and 3 h; the second row's fixed
    cov = CovView(torch.tensor([[[0.0, 3.0]], [[0.0, 3.0]]], dtype=torch.float64),
                  torch.tensor([[[60.0, 75.0]], [[70.0, 64.0]]], dtype=torch.float64),
                  torch.tensor([[False], [True]]), ["wt"])
    rng = np.random.RandomState(3)
    S, R = SUPPORT.shape[0], 2
    p = torch.as_tensor(SUPPORT)
    x = torch.as_tensor(rng.rand(S, R, 2) * 10.0)
    t = torch.tensor([[-1.0, 0.5], [1.7, 2.9], [4.0, 1.2]], dtype=torch.float64)
    rateiv = torch.as_tensor(rng.rand(S, R, 1))
    f, jac = RhsLanes(rhs, 2, SUPPORT.shape[1], 1, ("wt",), jacobian=True).bind(p, rateiv, cov)
    assert close(f(x, t), lane_rhs(rhs, 2, cov)(x, p, t, rateiv))
    assert close(jac(x, t), lane_jacobian(rhs, 2, cov)(x, p, t, rateiv))
