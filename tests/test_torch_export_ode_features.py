"""``export_psi`` of an ODE model with every feature: a time-varying
covariate read in the RHS (the artifact reads each lane's row at the lane's
time, ``engine/lanes.py::CovLanes``), an absorption lag and a
bioavailability per support (each support's own segments) and an infusion.
Under dopri5 the covariate is read by the RHS program (bdf, whose symbolic
Jacobian reads it too, is in ``test_torch_export_ode_features_bdf.py``).
The artifact's psi is held to the port's eager ``engine='general'`` (1e-12
relative under dopri5) and within 1e-10 to the JAX package's artifact of the
same model on the same numpy inputs, float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_export_ode import _ems, _on_the_cpu, _rel  # noqa: F401

import pharmsol_tpu as pst
from pharmsol_tpu.ops import export_psi as jax_export_psi
from pharmsol_tpu.ops import load_exported as jax_load_exported

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.likelihood.matrix import log_likelihood_matrix
from pharmsol_tpu_torch.ops import export_psi, load_exported

# ka, ke, v, lag, fa
SUPPORT = np.array([[1.2, 0.2, 10.0, 0.3, 0.8], [0.8, 0.15, 12.0, 0.6, 0.9],
                    [1.5, 0.3, 8.0, 0.1, 0.7]])


def _model(lib, xp):
    def rhs(x, p, t, b, rateiv, cov):
        ke = p[1] * (cov("wt", t) / 70.0) ** 0.75
        return xp.stack([-p[0] * x[0] + b[0], p[0] * x[0] - ke * x[1] + rateiv[0]])

    return lib.ODE(rhs, lag=lambda p, t, cov: {0: p[3]}, fa=lambda p, t, cov: {0: p[4]},
                   out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)


def _subjects(lib):
    rng = np.random.RandomState(20)
    out = []
    for i in range(2):
        b = (lib.Subject.builder(f"f{i}").bolus(0.0, 100.0, 0).infusion(1.5, 40.0, 0, 1.0)
             .covariate("wt", 0.0, 60.0 + 20.0 * rng.rand())
             .covariate("wt", 3.0, 60.0 + 20.0 * rng.rand()))
        for t in (1.5, 4.0):
            b = b.observation(t, float(5.0 * np.exp(-0.2 * t) * np.exp(0.1 * rng.randn())), 0)
        out.append(b.build())
    return out


def _check_features(solver, tmp_path, eager_tol):
    model = _model(pt, torch).with_solver(solver)
    subjects = _subjects(pt)
    grid = model.lower(subjects)
    lowered = _ems(pt).lower(model.resolve_output_label, model.nouteqs())
    path = str(tmp_path / "features.pt2")
    export_psi(model, grid, SUPPORT.shape, lowered, path=path, device="cpu")
    psi = load_exported(path)(grid.rows, grid.row_subject, SUPPORT, lowered.kind,
                              lowered.factor, lowered.poly)
    assert np.all(np.isfinite(psi.numpy()))
    want = log_likelihood_matrix(model, pt.Data(subjects), SUPPORT, _ems(pt),
                                 engine="general", device="cpu")
    assert _rel(psi, want) <= eager_tol

    jm = _model(pst, jnp).with_solver(solver)
    jgrid = jm.lower(_subjects(pst))
    jlow = _ems(pst).lower(jm.resolve_output_label, jm.nouteqs())
    jfn = jax_load_exported(jax_export_psi(jm, jgrid, SUPPORT.shape, jlow))
    jpsi = jfn(jgrid.rows, jnp.asarray(jgrid.row_subject), jnp.asarray(SUPPORT),
               jnp.asarray(jlow.kind), jnp.asarray(jlow.factor), jnp.asarray(jlow.poly))
    assert _rel(psi, jpsi) <= 1e-10


def test_export_features_dopri5(tmp_path):
    _check_features("dopri5", tmp_path, 1e-12)
