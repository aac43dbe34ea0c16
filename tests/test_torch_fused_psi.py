"""The fused psi kernel's plain twin against the JAX package's Pallas kernel.

On the CPU the wrapper ``psi_analytical`` runs the plain twin; the CUDA
kernel itself is held against that twin on the card (``chip_smoke.py`` and
``test_torch_cuda.py``). Here, in float64:

- the twin against JAX ``psi_oral(..., interpret=True)`` at R=8, S=128 with
  the JAX suite's own tolerance (rtol=5e-9, atol=1e-9), over the 12
  structures and the infusion and two-output+bias variants;
- censored cells against the JAX *general* engine at 1e-10 (the TPU kernel's
  log-CDF is an approximation) and against the JAX kernel at 1e-4 absolute;
- the twin against the port's own general engine at a ragged R=5, S=37.

Inputs are made with numpy from a seed; the segment streams of both sides
come from their own package's lowering of the same subjects.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi
from pharmsol_tpu.ops.pallas_psi import psi_oral
from pharmsol_tpu.ops.pallas_psi import streams_from_grid as jax_streams
from pharmsol_tpu.utils.f32_budget import _NOMINAL

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.ops import fused_psi
from pharmsol_tpu_torch.ops.fused_psi import (
    STRUCTURES,
    psi_analytical,
    psi_analytical_plain,
    streams_from_grid,
)
from pharmsol_tpu_torch.utils.f32_budget import F32_BUDGET, f32_error, kernel_case


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


RTOL, ATOL = 5e-9, 1e-9  # tests/test_pallas_psi.py:53


def _data(rng, n, infusion=False, censored=False, two_outputs=False):
    subjects = []
    for i in range(n):
        b = pst.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).bolus(12.0, 60.0, 0)
        if infusion:
            b = b.infusion(3.0, 150.0, 0, 1.5)
        for t in (0.5, 1.0, 2.0, 4.0, 8.0, 12.0, 13.0, 24.0):
            b = b.observation(t, float(abs(3.0 + rng.randn())), 0)
        if censored:
            b = b.censored_observation(30.0, 0.1, 0, pst.Censor.BLOQ)
            b = b.censored_observation(0.25, 9.0, 0, pst.Censor.ALOQ)
        if two_outputs:
            b = b.observation(1.5, 2.0 + 0.1 * i, 1).observation(9.0, 1.0, 1)
        subjects.append(b.build())
    return pst.Data(subjects)


def _ems(nout=1):
    ems = pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1), 1.0))
    if nout == 2:
        ems = ems.add(1, pst.AssayErrorModel.proportional(
            pst.ErrorPoly(0.1, 0.2), 2.0))
    return ems


def _streams(data, ems, nout=1):
    """(JAX streams, port streams as float64 tensors), each 8 x [R, M]."""
    mj = pst.Analytical(pst.one_compartment, nstates=1, ndrugs=1, nout=nout)
    mt = pt.Analytical(pt.one_compartment, nstates=1, ndrugs=1, nout=nout)
    gj = mj.lower(data.subjects())
    gt = mt.lower(convert.data_from_reference(data).subjects())
    lt = convert.error_models_from_reference(ems).lower(
        mt.resolve_output_label, nout)
    sj = jax_streams(gj.rows, ems.lower(mj.resolve_output_label, nout))
    st = [torch.as_tensor(a) for a in streams_from_grid(gt.rows, lt)]
    return sj, st


def _support(name, rng, S):
    """[S, n_params + 1] supports jittered around the budget's centres, the
    volume last."""
    center = np.array(_NOMINAL[name] + [11.0])
    return np.abs(center[None, :] * (1.0 + 0.15 * rng.randn(S, center.size)))


def _central_over_v(name):
    from pharmsol_tpu.engine.analytical import KERNELS

    fn, nstates, nparams = KERNELS[name]
    central = 1 if name.endswith("_with_absorption") else 0

    def out(x, p, t, cov):
        return x[central:central + 1] / p[nparams]

    return nstates, out


def _jax_kernel(sj, support, name, with_rate=False, with_cens=False, **kw):
    dt, bol, rate, mask, val, sig, cens, outeq = (jnp.asarray(a) for a in sj)
    return np.asarray(psi_oral(
        dt, bol, rate if with_rate else None, mask, val, sig,
        cens if with_cens else None, jnp.asarray(support), structure=name,
        interpret=True, **kw))


def _twin(st, support, name, with_rate=False, with_cens=False, **kw):
    dt, bol, rate, mask, val, sig, cens, outeq = st
    return psi_analytical(
        dt, bol, rate if with_rate else None, mask, val, sig,
        cens if with_cens else None, torch.as_tensor(support),
        structure=name, **kw).numpy()


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_twin_matches_jax_kernel(name):
    rng = np.random.RandomState(len(name))
    data = _data(rng, 8)
    sj, st = _streams(data, _ems())
    sp = _support(name, rng, 128)
    want = _jax_kernel(sj, sp, name)
    before = fused_psi.LAUNCHES
    got = _twin(st, sp, name)
    assert fused_psi.LAUNCHES == before  # the CPU runs the twin, not a launch
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_twin_matches_jax_kernel_infusion():
    name = "two_compartments_with_absorption"
    rng = np.random.RandomState(1)
    sj, st = _streams(_data(rng, 8, infusion=True), _ems())
    assert np.any(sj[2])
    sp = _support(name, rng, 128)
    want = _jax_kernel(sj, sp, name, with_rate=True)
    got = _twin(st, sp, name, with_rate=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_twin_matches_jax_kernel_two_outputs_and_bias():
    name = "two_compartments_with_absorption"
    rng = np.random.RandomState(2)
    sj, st = _streams(_data(rng, 8, two_outputs=True), _ems(2), nout=2)
    S = 128
    coef = np.zeros((2, 3, S))
    coef[0, 1] = 1.0 / (10.0 + rng.rand(S))
    coef[1, 2] = 1.0 / (20.0 + rng.rand(S))
    coef[1, 1] = 0.01 * rng.rand(S)
    bias = np.stack([np.zeros(S), 0.2 + 0.1 * rng.rand(S)])
    sp = np.ascontiguousarray(_support(name, rng, S)[:, :4])
    want = _jax_kernel(sj, sp, name, obs_outeq=jnp.asarray(sj[7]),
                       out_coef=jnp.asarray(coef), out_bias=jnp.asarray(bias))
    got = _twin(st, sp, name, obs_outeq=st[7], out_coef=torch.as_tensor(coef),
                out_bias=torch.as_tensor(bias))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["one_compartment_with_absorption",
                                  "two_compartments_with_absorption",
                                  "three_compartments"])
def test_twin_censored_matches_jax_general_engine(name):
    rng = np.random.RandomState(3)
    data = _data(rng, 8, infusion=True, censored=True)
    ems = _ems()
    sj, st = _streams(data, ems)
    assert np.any(sj[6])
    sp = _support(name, rng, 128)
    got = _twin(st, sp, name, with_rate=True, with_cens=True)
    # the JAX general engine: exact log-CDF (one occasion row per subject)
    nstates, out = _central_over_v(name)
    model = pst.Analytical(getattr(pst, name), out=out, nstates=nstates,
                           ndrugs=1, nout=1)
    want = jax_psi(model, data, sp, ems, engine="xla")
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    if name == "two_compartments_with_absorption":
        # the TPU kernel's approximate log-CDF: about 6e-5 absolute
        approx = _jax_kernel(sj, sp, name, with_rate=True, with_cens=True)
        np.testing.assert_allclose(got, approx, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_twin_matches_port_general_engine_ragged(name):
    """R=5 rows, S=37 supports: no padding anywhere."""
    rng = np.random.RandomState(40 + len(name))
    data = convert.data_from_reference(
        _data(rng, 5, infusion=True, censored=True))
    ems = convert.error_models_from_reference(_ems())
    nstates, out = _central_over_v(name)
    model = pt.Analytical(getattr(pt, name), out=out, nstates=nstates,
                          ndrugs=1, nout=1)
    sp = _support(name, rng, 37)
    general = pt.log_likelihood_matrix(model, data, sp, ems, engine="general")
    fused = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    assert fused.shape == (5, 37)
    torch.testing.assert_close(fused, general, rtol=1e-10, atol=0)


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_twin_float32_within_budget(name):
    """The plain float32 version stays inside the committed f32 budget on
    the budget's own case (the CUDA kernel is held to it on the card)."""
    model, data, sp, ems = kernel_case(name)
    golden = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    pt.set_float_dtype(torch.float32)
    try:
        got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    finally:
        pt.set_float_dtype(torch.float64)
    assert got.dtype == torch.float32
    assert f32_error(got.numpy(), golden.numpy()) <= F32_BUDGET[name]


def test_wrapper_checks_its_inputs():
    name = "one_compartment"
    R, M, S = 3, 4, 5
    z = torch.zeros((R, M), dtype=torch.float64)
    one = torch.ones((R, M), dtype=torch.float64)
    sp = torch.ones((S, 2), dtype=torch.float64)
    ok = psi_analytical_plain(one, z, None, one, one, one, None, sp, name)
    assert ok.shape == (R, S)
    with pytest.raises(ValueError, match="unknown fused psi structure"):
        psi_analytical(one, z, None, one, one, one, None, sp, "four_compartments")
    with pytest.raises(ValueError, match="seg_bolus"):
        psi_analytical(one, z[:, :2], None, one, one, one, None, sp, name)
    with pytest.raises(ValueError, match="expected torch.float64"):
        psi_analytical(one, z.float(), None, one, one, one, None, sp, name)
    with pytest.raises(ValueError, match="contiguous"):
        psi_analytical(one, z.t().contiguous().t(), None, one, one, one,
                       None, sp, name)
    with pytest.raises(ValueError, match="plus v"):
        psi_analytical(one, z, None, one, one, one, None,
                       sp[:, :1].contiguous(), name)
    with pytest.raises(ValueError, match="obs_outeq"):
        psi_analytical(one, z, None, one, one, one, None, sp, name,
                       out_coef=torch.ones((2, 1, S), dtype=torch.float64))
