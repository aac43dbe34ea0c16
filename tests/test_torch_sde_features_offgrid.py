"""The fused SDE plan's twin (kernel K3b) with a lagged dose off the
observation grid.

Both kernels, the JAX package's and the port's, restart the Euler-Maruyama
step controller at a dose's own time (a breakpoint of their streams) and
again at its fire; both general engines restart it only at the fire. So at
zero diffusion the twin equals the JAX kernel (run in interpret mode, as the
JAX package's own tests run it on the CPU) within 1e-9, while fused and
general psi part by the controller's error, in both packages alike. The
gap is pinned here, between 1e-5 and 1e-3 relative, float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _offgrid_case(xp, cls, lib):
    """One state, fast elimination, lag; a second dose at 0.73 h that no
    observation shares, and one observation at 1.2 h; no diffusion."""
    model = cls(drift=lambda x, p, t, r, cov: xp.stack([-p[0] * x[0]]),
                diffusion=lambda p, t, cov: [0.0 * p[0]],
                lag=lambda p, t, cov: {0: p[3]},
                out=lambda x, p, t, cov: x[0:1] / p[2],
                nparticles=16, nstates=1, ndrugs=1, nout=1, seed=3)
    data = lib.Data([lib.Subject.builder("g0").bolus(0.0, 100.0, 0).bolus(0.73, 60.0, 0)
                     .observation(1.2, 8.0, 0).build()])
    rng = np.random.default_rng(5)
    sp = np.column_stack([rng.uniform(2.0, 4.0, 4), rng.uniform(0.1, 0.3, 4),
                          rng.uniform(8, 14, 4), rng.uniform(0.1, 0.4, 4)])
    ems = lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.0, 0.0, 0.0), 0.5))
    return model, data, sp, ems


def test_twin_matches_the_jax_kernel_with_a_dose_off_the_observation_grid():
    """Both kernels restart the step controller at the dose's own time (a
    breakpoint of their streams) and again at its fire: equal to rounding."""
    model, data, sp, ems = _offgrid_case(jnp, pst.SDE, pst)
    want = np.asarray(jax_psi(model, data, sp, ems, engine="pallas"))
    model, data, sp, ems = _offgrid_case(torch, pt.SDE, pt)
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    assert np.isfinite(want).all() and _rel(got, want) <= 1e-9


def test_dose_off_the_observation_grid_pins_the_engines_divergence():
    """The general engines restart the controller only at the fire, so with
    a dose off the observation grid fused and general psi differ by the
    controller's error at zero diffusion, in both packages alike: the port's
    general engine equals JAX ``engine='xla'``, and its twin stays between
    1e-5 and 1e-3 (relative) from it."""
    model, data, sp, ems = _offgrid_case(jnp, pst.SDE, pst)
    want = np.asarray(jax_psi(model, data, sp, ems, engine="xla"))
    model, data, sp, ems = _offgrid_case(torch, pt.SDE, pt)
    general = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    fused = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    assert np.isfinite(general).all() and _rel(general, want) <= 1e-9
    assert 1e-5 <= _rel(fused, general) <= 1e-3
