"""``export_psi`` of ODE models under the explicit adaptive solvers
(``pharmsol_tpu_torch/ops/export.py``).

The 2-state oral model of ``test_torch_export.py`` on 2 subjects: the
artifact is traced (one ``while_loop`` per segment, the RHS as its traced
lane program), saved, loaded and run on the CPU in float64, and its psi is
held within 1e-12 relative to the port's eager ``engine='general'`` (the
same operations on the same step sequence) and within 1e-10 to the JAX
package's ``export_psi`` artifact of the same model run on the same numpy
inputs. A closure that branches on a state in Python is refused by both
packages. The implicit solvers are in ``test_torch_export_ode_sdirk.py``,
``test_torch_export_ode_kvaerno5.py`` and ``test_torch_export_ode_bdf.py``,
the features in ``test_torch_export_ode_features.py``.
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
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood.matrix import log_likelihood_matrix
from pharmsol_tpu_torch.ops import export_psi, load_exported

SUPPORT = np.array([[1.2, 0.2, 10.0], [0.8, 0.15, 12.0], [1.5, 0.3, 8.0]])


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _rhs(xp):
    return lambda x, p, t, b, rateiv, cov: xp.stack([-p[0] * x[0] + b[0],
                                                     p[0] * x[0] - p[1] * x[1]])


def _model(lib, xp, solver, rhs=None):
    return lib.ODE(rhs or _rhs(xp), out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2,
                   ndrugs=1, nout=1).with_solver(solver)


def _subjects(lib):
    out = []
    for i in range(2):
        b = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0 + 20.0 * i, 0)
        for t in (1.0, 4.0):
            b = b.observation(t, 40 * math.exp(-0.2 * t), 0)
        out.append(b.build())
    return out


def _ems(lib):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def _exported(solver, tmp_path):
    """(the loaded artifact's psi, the eager general engine's psi)."""
    model = _model(pt, torch, solver)
    subjects = _subjects(pt)
    grid = model.lower(subjects)
    lowered = _ems(pt).lower(model.resolve_output_label, model.nouteqs())
    path = str(tmp_path / f"{solver}.pt2")
    export_psi(model, grid, SUPPORT.shape, lowered, path=path, device="cpu")
    psi = load_exported(path)(grid.rows, grid.row_subject, SUPPORT, lowered.kind,
                              lowered.factor, lowered.poly)
    want = log_likelihood_matrix(model, pt.Data(subjects), SUPPORT, _ems(pt),
                                 engine="general", device="cpu")
    assert isinstance(psi, torch.Tensor) and psi.shape == (2, 3)
    return psi, want


def _jax_artifact_psi(solver):
    jm = _model(pst, jnp, solver)
    jgrid = jm.lower(_subjects(pst))
    jlow = _ems(pst).lower(jm.resolve_output_label, jm.nouteqs())
    jfn = jax_load_exported(jax_export_psi(jm, jgrid, SUPPORT.shape, jlow))
    return jfn(jgrid.rows, jnp.asarray(jgrid.row_subject), jnp.asarray(SUPPORT),
               jnp.asarray(jlow.kind), jnp.asarray(jlow.factor), jnp.asarray(jlow.poly))


@pytest.mark.parametrize("solver", ["dopri5", "tsit5"])
def test_export_explicit_solver(solver, tmp_path):
    psi, want = _exported(solver, tmp_path)
    assert np.all(np.isfinite(psi.numpy()))
    assert _rel(psi, want) <= 1e-12
    assert _rel(psi, _jax_artifact_psi(solver)) <= 1e-10


def test_export_refuses_a_python_branch_on_the_state():
    def branchy(xp):
        def rhs(x, p, t, b, rateiv, cov):
            if x[0] > 1.0:
                return xp.stack([-p[0] * x[0] + b[0], p[0] * x[0] - p[1] * x[1]])
            return xp.stack([b[0], -p[1] * x[1]])
        return rhs

    model = _model(pt, torch, "dopri5", rhs=branchy(torch))
    lowered = _ems(pt).lower(model.resolve_output_label, model.nouteqs())
    with pytest.raises(PharmsolError, match=r"export_psi: .*branches on a traced value "
                                            r"\(a Python `if`"):
        export_psi(model, model.lower(_subjects(pt)), SUPPORT.shape, lowered, device="cpu")

    jm = _model(pst, jnp, "dopri5", rhs=branchy(jnp))
    jlow = _ems(pst).lower(jm.resolve_output_label, jm.nouteqs())
    with pytest.raises(Exception):
        jax_export_psi(jm, jm.lower(_subjects(pst)), SUPPORT.shape, jlow)
