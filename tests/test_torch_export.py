"""The port's ahead-of-time psi artifacts (``pharmsol_tpu_torch/ops/export.py``).

The JAX package's ``tests/test_aux.py::test_export_roundtrip`` on the port:
``export_psi`` traces the general engine's psi program at the grid's padded
shapes (``torch.export``), the artifact is saved, loaded and run, and its
psi is held within 1e-12 relative to the port's ``log_likelihood_matrix``
and to the JAX package's exported artifact run on the same numpy inputs
(float64, on the CPU). An ODE model under ``expm`` exports too; the
adaptive solvers and the SDE particle filter are held in
``test_torch_export_ode*.py`` and ``test_torch_export_sde.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.ops import export_psi as jax_export_psi
from pharmsol_tpu.ops import load_exported as jax_load_exported

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.likelihood.matrix import log_likelihood_matrix
from pharmsol_tpu_torch.ops import export_psi, load_exported

REL = 1e-12


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _subjects(lib, n=3, times=(1.0, 4.0, 8.0)):
    out = []
    for i in range(n):
        b = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t in times:
            b = b.observation(t, 40 * math.exp(-0.2 * t), 0)
        out.append(b.build())
    return out


def _ems(lib):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def _one_cmt(lib):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def test_export_roundtrip(tmp_path):
    model = _one_cmt(pt)
    subjects = _subjects(pt)
    grid = model.lower(subjects)
    lowered = _ems(pt).lower(model.resolve_output_label, model.nouteqs())
    path = str(tmp_path / "psi.pt2")
    blob = export_psi(model, grid, (4, 2), lowered, path=path, device="cpu")
    assert len(blob) > 100
    fn = load_exported(path)
    support = np.array([[0.1, 1.0], [0.2, 1.5], [0.15, 2.0], [0.3, 1.0]])
    psi = fn(grid.rows, grid.row_subject, support, lowered.kind, lowered.factor,
             lowered.poly)
    assert isinstance(psi, torch.Tensor) and psi.shape == (3, 4)
    want = log_likelihood_matrix(model, pt.Data(subjects), support, _ems(pt), device="cpu")
    assert _rel(psi, want) <= REL
    # the bytes load as well as the path
    assert _rel(load_exported(blob)(grid.rows, grid.row_subject, support, lowered.kind,
                                    lowered.factor, lowered.poly), want) <= REL

    # the JAX package's artifact of the same program, on the same inputs
    jm = _one_cmt(pst)
    jgrid = jm.lower(_subjects(pst))
    jlow = _ems(pst).lower(jm.resolve_output_label, jm.nouteqs())
    jfn = jax_load_exported(jax_export_psi(jm, jgrid, (4, 2), jlow))
    jpsi = jfn(jgrid.rows, jnp.asarray(jgrid.row_subject), jnp.asarray(support),
               jnp.asarray(jlow.kind), jnp.asarray(jlow.factor), jnp.asarray(jlow.poly))
    assert _rel(psi, jpsi) <= REL


def test_export_expm_ode():
    """``expm`` exports: every squaring masked, the affine RHS's Jacobian by
    its columns."""
    def rhs(x, p, t, b, rateiv, cov):
        return torch.stack([-p[0] * x[0] + b[0], p[0] * x[0] - p[1] * x[1]])

    model = pt.ODE(rhs, out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1,
                   nout=1).with_solver("expm")
    subjects = _subjects(pt, n=2, times=(1.0, 4.0))
    grid = model.lower(subjects)
    lowered = _ems(pt).lower(model.resolve_output_label, model.nouteqs())
    fn = load_exported(export_psi(model, grid, (3, 3), lowered, device="cpu"))
    support = np.array([[1.2, 0.2, 10.0], [0.8, 0.15, 12.0], [1.5, 0.3, 8.0]])
    psi = fn(grid.rows, grid.row_subject, support, lowered.kind, lowered.factor,
             lowered.poly)
    want = log_likelihood_matrix(model, pt.Data(subjects), support, _ems(pt),
                                 engine="general", device="cpu")
    assert _rel(psi, want) <= REL
