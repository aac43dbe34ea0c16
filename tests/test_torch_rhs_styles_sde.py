"""SDE drifts with the RHS generator's elementwise set against the JAX SDE
kernel.

A drift that reads ``tanh`` and ``log1p`` (both taken by the JAX SDE plan's
lane shims, and by the port's since the elementwise set): the port's twin of
kernel K3a against JAX ``engine='pallas'`` in interpret mode at zero
diffusion within 1e-9, float64 on the CPU, and against the port's general
engine there (1e-9). One interpret-mode case: the JAX kernel compiles for
most of this file's time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.ops import fused_sde


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _ems(lib):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def _sde(xp, cls):
    """A decay whose elimination a tanh damps and a log1p term adds to;
    zero diffusion."""
    return cls(drift=lambda x, p, t, r, cov: xp.stack([
        -p[0] * x[0] * (1.0 + 0.2 * xp.tanh(0.05 * x[0])) - 0.05 * xp.log1p(x[0]) + r[0]]),
        diffusion=lambda p, t, cov: [0.0 * p[0]],
        out=lambda x, p, t, cov: x[0:1] / p[1],
        nparticles=8, nstates=1, ndrugs=1, nout=1, seed=3)


def test_tanh_and_log1p_drift_matches_the_jax_sde_kernel():
    subs = []
    for i in range(3):
        sb = pst.SubjectBuilder(f"s{i}").bolus(0.0, 100.0, 0)
        if i % 2 == 0:
            sb = sb.infusion(0.5, 20.0, 0, 0.5)
        for t in (0.3, 0.8, 1.5):
            sb = sb.observation(t, float(8 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subs.append(sb.build())
    data = pst.Data(subs)
    rng = np.random.default_rng(4)
    sp = np.column_stack([rng.uniform(0.2, 0.6, 4), rng.uniform(8, 14, 4)])
    want = np.asarray(jax_psi(_sde(jnp, pst.SDE), data, sp, _ems(pst), engine="pallas"))
    model, pdata = _sde(torch, pt.SDE), convert.data_from_reference(data)
    before = fused_sde.LAUNCHES
    got = pt.log_likelihood_matrix(model, pdata, sp, _ems(pt), engine="fused").numpy()
    assert fused_sde.LAUNCHES == before  # the twin ran: CPU tensors
    assert "pm_tanh(" in model._sde_cache[next(iter(model._sde_cache))].source
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    general = pt.log_likelihood_matrix(model, pdata, sp, _ems(pt), engine="general").numpy()
    np.testing.assert_allclose(got, general, rtol=1e-9, atol=0)
