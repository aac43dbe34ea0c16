"""The single-subject API of the port against the JAX package for ODE and
SDE models (float64, CPU): ``estimate_predictions`` (predictions, states and
metadata), ``estimate_log_likelihood`` and ``simulate_subject`` on the cases
of ``utils/f32_budget.py`` built in both packages (the right-hand sides
stacked by each framework, the subjects carried across by
``convert.data_from_reference``).

ODE: dopri5 with covariates and with lag (whose segments sort per support
point: the states are gathered at the shifted positions), tsit5, expm
(1e-10 relative) and bdf (stiff, 1e-8). SDE at zero diffusion (1e-9): the
port draws its noise from its own generator, so its predictions equal the
JAX package's only when the diffusion is zero, the deliberate divergence
of the SDE engines.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pharmsol_tpu as pst

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.utils import f32_budget as fb

from test_torch_single_subject import compare_subject

CASES = {
    # name: (builder of (model, data, support, ems) given lib and stack, rtol)
    "dopri5_covariates": (lambda **kw: fb.ode_feature_case("cov_linear", 2, 2, **kw), 1e-10),
    "dopri5_lag": (lambda **kw: fb.ode_feature_case("lag_fa", 2, 2, **kw), 1e-10),
    "tsit5": (lambda **kw: fb.ode_feature_case("tsit5_cov", 2, 2, **kw), 1e-10),
    # one subject each: the JAX package compiles these programs for ~10 s
    "expm": (lambda **kw: fb.expm_case("two_cmt", 1, 1, **kw), 1e-10),
    "bdf": (lambda **kw: fb.stiff_case("two_cmt", 1, 1, solver="bdf", **kw), 1e-8),
    "sde_zero_diffusion": (lambda **kw: fb.sde_feature_case("cov_affine", 2, 2, sigma=False,
                                                            **kw), 1e-9),
    "sde_lag_fa_zero_diffusion": (lambda **kw: fb.sde_feature_case("lag_fa", 2, 2, sigma=False,
                                                                   **kw), 1e-9),
}


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name):
    build, rtol = CASES[name]
    jm, jd, sp, jems = build(lib=pst, stack=jnp.stack)[:4]
    tm = build()[0]
    for i, js in enumerate(jd.subjects()):
        compare_subject(jm, tm, js, sp[i], jems, rtol)


def test_sde_predictions_are_particle_means():
    """With diffusion the clouds spread: the prediction is the mean over the
    particles, reproducible per seed, and differs from the zero-diffusion
    prediction by the noise alone (the port's generator is not the JAX
    package's, so only the statistics are shared)."""
    m, d, sp, _ = fb.sde_feature_case("cov_const", 1, 2, nparticles=256)
    s = d.subjects()[0]
    a = m.estimate_predictions(s, sp[0])
    m.clear_cache()
    b = m.estimate_predictions(s, sp[0])
    assert a is not b and a.flat_predictions() == b.flat_predictions()
    quiet = sp[0].copy()
    quiet[3] = 0.0
    q = np.asarray(m.estimate_predictions(s, quiet).flat_predictions())
    got = np.asarray(a.flat_predictions())
    assert np.all(np.isfinite(got)) and not np.array_equal(got, q)
    np.testing.assert_allclose(got, q, rtol=0.2)
