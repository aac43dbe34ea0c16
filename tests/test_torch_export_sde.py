"""``export_psi`` of an SDE model: the particle filter traced with its
Euler-Maruyama marches as ``while_loop`` programs, the drift and diffusion
as the closures' traced lane programs and every draw from the Philox
counters of the model's seed (``engine/sde.py::_Noise``).

The 1-state SDE on 2 subjects, float64 on the CPU, one artifact for every
case (the diffusion's scale is a support column):

- at zero diffusion the artifact's psi equals the port's eager
  ``engine='general'`` and the JAX package's ``export_psi`` artifact of the
  same model within 1e-9 relative (no draw reaches a particle);
- with noise it equals the eager filter driven by the same Philox noise
  (``simulate_occasion_sde_ll(..., philox_seed=seed)``) within 1e-12;
- two calls of the artifact are equal bit for bit;
- a drift that reads a time-varying covariate (each lane's row at the
  lane's time, with a trailing particle axis) gives, at zero diffusion, the
  eager engine's and the JAX artifact's psi within 1e-9.
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
from pharmsol_tpu_torch.engine.grid import to_tensors
from pharmsol_tpu_torch.engine.sde import simulate_occasion_sde_ll
from pharmsol_tpu_torch.likelihood.matrix import log_likelihood_matrix
from pharmsol_tpu_torch.ops import export_psi, load_exported

SEED = 11
# ke, v, the diffusion's scale
SUPPORT = np.array([[0.2, 10.0, 0.05], [0.15, 12.0, 0.08], [0.3, 8.0, 0.03]])
QUIET = SUPPORT * np.array([1.0, 1.0, 0.0])


def _sde(lib, xp):
    return lib.SDE(drift=lambda x, p, t, rateiv, cov: xp.stack([-p[0] * x[0] + rateiv[0]]),
                   diffusion=lambda p, t, cov: xp.stack([p[2] * 1.0]),
                   out=lambda x, p, t, cov: x[0:1] / p[1], nparticles=16, nstates=1,
                   ndrugs=1, nout=1, seed=SEED)


def _sde_cov(lib, xp):
    def drift(x, p, t, rateiv, cov):
        return xp.stack([-p[0] * (cov("wt", t) / 70.0) ** 0.75 * x[0] + rateiv[0]])

    return lib.SDE(drift=drift, diffusion=lambda p, t, cov: xp.stack([p[2] * 1.0]),
                   out=lambda x, p, t, cov: x[0:1] / p[1], nparticles=16, nstates=1,
                   ndrugs=1, nout=1, seed=SEED)


def _subjects(lib, covariates=False):
    out = []
    for i in range(2):
        b = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0 + 20.0 * i, 0)
        if covariates:
            b = b.covariate("wt", 0.0, 60.0 + 15.0 * i).covariate("wt", 2.5, 80.0 - 10.0 * i)
        for t in (1.0, 4.0):
            b = b.observation(t, 10.0 * math.exp(-0.2 * t), 0)
        out.append(b.build())
    return out


def _ems(lib):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def _rel(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


@pytest.fixture(scope="module")
def artifact():
    """(the loaded artifact's psi at a support, the model, its grid and
    lowered error models), traced once for the module on the CPU."""
    model = _sde(pt, torch)
    grid = model.lower(_subjects(pt))
    lowered = _ems(pt).lower(model.resolve_output_label, model.nouteqs())
    fn = load_exported(export_psi(model, grid, SUPPORT.shape, lowered, device="cpu"))

    def psi(support):
        return fn(grid.rows, grid.row_subject, support, lowered.kind, lowered.factor,
                  lowered.poly)

    return psi, model, grid, lowered


def test_export_sde_at_zero_diffusion(artifact):
    psi_of = artifact[0]
    psi = psi_of(QUIET)
    assert psi.shape == (2, 3) and np.all(np.isfinite(psi.numpy()))
    want = log_likelihood_matrix(_sde(pt, torch), pt.Data(_subjects(pt)), QUIET, _ems(pt),
                                 engine="general", device="cpu")
    assert _rel(psi, want) <= 1e-9

    jm = _sde(pst, jnp)
    jgrid = jm.lower(_subjects(pst))
    jlow = _ems(pst).lower(jm.resolve_output_label, jm.nouteqs())
    jfn = jax_load_exported(jax_export_psi(jm, jgrid, QUIET.shape, jlow))
    jpsi = jfn(jgrid.rows, jnp.asarray(jgrid.row_subject), jnp.asarray(QUIET),
               jnp.asarray(jlow.kind), jnp.asarray(jlow.factor), jnp.asarray(jlow.poly))
    assert _rel(psi, jpsi) <= 1e-9


def test_export_sde_with_noise_against_the_eager_philox_march(artifact):
    psi_of, model, grid, lowered = artifact
    psi = psi_of(SUPPORT)
    rows = to_tensors(grid.rows, "cpu", torch.float64)
    ll = simulate_occasion_sde_ll(
        model.spec, rows, torch.as_tensor(SUPPORT),
        *(torch.as_tensor(np.asarray(a)) for a in (lowered.kind, lowered.factor, lowered.poly)),
        None, grid.cov_names, philox_seed=SEED)
    want = torch.zeros((2, 3), dtype=torch.float64).index_add(
        0, torch.as_tensor(np.asarray(grid.row_subject)), ll.t())
    assert np.all(np.isfinite(psi.numpy()))
    assert _rel(psi, want) <= 1e-12
    # the noise reaches the particles: not the zero-diffusion psi
    assert _rel(psi, psi_of(QUIET)) > 1e-6


def test_export_sde_calls_are_bitwise_equal(artifact):
    psi_of = artifact[0]
    assert torch.equal(psi_of(SUPPORT), psi_of(SUPPORT))


def test_export_sde_reads_a_covariate_at_zero_diffusion():
    model = _sde_cov(pt, torch)
    grid = model.lower(_subjects(pt, covariates=True))
    lowered = _ems(pt).lower(model.resolve_output_label, model.nouteqs())
    fn = load_exported(export_psi(model, grid, QUIET.shape, lowered, device="cpu"))
    psi = fn(grid.rows, grid.row_subject, QUIET, lowered.kind, lowered.factor, lowered.poly)
    assert psi.shape == (2, 3) and np.all(np.isfinite(psi.numpy()))
    want = log_likelihood_matrix(model, pt.Data(_subjects(pt, covariates=True)), QUIET,
                                 _ems(pt), engine="general", device="cpu")
    assert _rel(psi, want) <= 1e-9

    jm = _sde_cov(pst, jnp)
    jgrid = jm.lower(_subjects(pst, covariates=True))
    jlow = _ems(pst).lower(jm.resolve_output_label, jm.nouteqs())
    jfn = jax_load_exported(jax_export_psi(jm, jgrid, QUIET.shape, jlow))
    jpsi = jfn(jgrid.rows, jnp.asarray(jgrid.row_subject), jnp.asarray(QUIET),
               jnp.asarray(jlow.kind), jnp.asarray(jlow.factor), jnp.asarray(jlow.poly))
    assert _rel(psi, jpsi) <= 1e-9
