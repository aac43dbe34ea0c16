"""The port's general ODE engine against the JAX package's ``engine='xla'``.

Both march the same segments with the same embedded pair, I-controller, h0
and cross-segment warm start, lane by lane, so they agree to rounding: psi
within 1e-10 relative, float64 on the CPU. Each model's RHS is written once
per framework from the same formula; inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")
    # lanes of a few dozen cells under a Python loop: torch's intra-op pool
    # only costs here (2-3x on the implicit solvers' small batched solves)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bolus_infusion(xp):
    return lambda x, p, t, b, r, cov: xp.stack([
        -p[0] * x[0] + b[0],
        p[0] * x[0] - p[1] * x[1] + r[0],
    ])


def _michaelis_menten(xp):
    return lambda x, p, t, b, r, cov: xp.stack([
        -p[0] * x[0] / (p[1] + x[0]) + b[0] + r[0],
    ])


def _short(xp):  # bench.py:210-215: 2-cmt oral as an ODE
    return lambda x, p, t, b, r, cov: xp.stack([
        -p[1] * x[0] + b[0],
        p[1] * x[0] - (p[0] + p[2]) * x[1] + p[3] * x[2] + r[0],
        p[2] * x[1] - p[3] * x[2],
    ])


def _subjects(n, infusion_every=3, times=(0.5, 1.0, 2.0, 4.0, 8.0)):
    out = []
    for i in range(n):
        sb = pst.SubjectBuilder(f"s{i}").bolus(0.0, 100.0, 0)
        if infusion_every and i % infusion_every == 0:
            sb = sb.infusion(2.0, 50.0, 0, 1.0)
        for t in times:
            sb = sb.observation(t, float(5 * np.exp(-0.3 * t) + 0.1 * i), 0)
        out.append(sb.build())
    return pst.Data(out)


def _case(name, S=12):
    """(rhs factory, out, nstates, support, data) of one model."""
    rng = np.random.default_rng({"bolus_infusion": 0, "michaelis_menten": 3,
                                 "short": 5}[name])
    if name == "bolus_infusion":
        sp = np.column_stack([rng.uniform(0.5, 2.0, S), rng.uniform(0.05, 0.5, S),
                              rng.uniform(30, 90, S)])
        return _bolus_infusion, (lambda x, p, t, cov: x[1:2] / p[2]), 2, sp, _subjects(6)
    if name == "michaelis_menten":
        sp = np.column_stack([rng.uniform(5.0, 20.0, S), rng.uniform(5.0, 30.0, S),
                              rng.uniform(20, 60, S)])
        return _michaelis_menten, (lambda x, p, t, cov: x[0:1] / p[2]), 1, sp, _subjects(6)
    center = np.array([0.15, 1.2, 0.3, 0.2, 10.0])
    sp = np.abs(center[None, :] * (1.0 + 0.2 * rng.standard_normal((S, 5))))
    data = _subjects(6, infusion_every=0,
                     times=(0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0))
    return _short, (lambda x, p, t, cov: x[1:2] / p[4]), 3, sp, data


def _ems():
    return pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1), 1.0))


def _models(name, solver):
    rhs, out, n, sp, data = _case(name)
    jm = pst.ODE(rhs(jnp), out=out, nstates=n, ndrugs=1, nout=1).with_solver(solver)
    tm = pt.ODE(rhs(torch), out=out, nstates=n, ndrugs=1, nout=1).with_solver(solver)
    return jm, tm, sp, data


@pytest.mark.parametrize("solver", ["dopri5", "tsit5"])
@pytest.mark.parametrize("name", ["bolus_infusion", "michaelis_menten", "short"])
def test_general_engine_matches_jax_xla(name, solver):
    jm, tm, sp, data = _models(name, solver)
    want = np.asarray(jax_psi(jm, data, sp, _ems(), engine="xla"))
    got = pt.log_likelihood_matrix(tm, convert.data_from_reference(data), sp,
                                   convert.error_models_from_reference(_ems()),
                                   engine="general")
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)


def test_exhausted_step_budget_gives_neg_inf_in_both_packages():
    jm, tm, sp, data = _models("bolus_infusion", "dopri5")
    jm = jm.with_max_steps(3)
    tm = tm.with_max_steps(3)
    want = np.asarray(jax_psi(jm, data, sp, _ems(), engine="xla"))
    got = pt.log_likelihood_matrix(tm, convert.data_from_reference(data), sp,
                                   convert.error_models_from_reference(_ems()),
                                   engine="general").numpy()
    assert np.isneginf(want).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10, atol=0)


@pytest.mark.parametrize("solver", ["kvaerno5", "bdf", "expm", "trbdf2", "bogus"])
def test_unsupported_solver_raises(solver):
    _, tm, sp, data = _models("bolus_infusion", "dopri5")
    if solver != "bogus":
        # ported: the solver runs in the general engine and gives the JAX
        # package's psi (under expm michaelis_menten, not affine, is -inf in
        # both; the implicit solvers integrate it)
        for name in ("bolus_infusion", "michaelis_menten"):
            jm, tm, sp, data = _models(name, solver)
            want = np.asarray(jax_psi(jm, data, sp, _ems(), engine="xla"))
            got = pt.log_likelihood_matrix(tm, convert.data_from_reference(data), sp,
                                           convert.error_models_from_reference(_ems()),
                                           engine="general").numpy()
            np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
            fin = np.isfinite(want)
            assert fin.all() == (name == "bolus_infusion" or solver != "expm")
            assert fin.any() == fin.all()
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10, atol=0)
        return
    tm = tm.with_solver(solver)
    for engine in ("auto", "general", "fused"):
        with pytest.raises(PharmsolError, match="unknown ODE solver"):
            pt.log_likelihood_matrix(tm, convert.data_from_reference(data), sp,
                                     convert.error_models_from_reference(_ems()),
                                     engine=engine)


def test_rhs_difference_bolus_honors_a_scaled_mapping():
    """A bolus mapped through the RHS (here 0.8 * b into state 0 and 0.2 * b
    into state 1) is applied as f(x, b) - f(x, 0), as the JAX engine does."""
    def rhs(xp):
        return lambda x, p, t, b, r, cov: xp.stack([
            -p[0] * x[0] + 0.8 * b[0],
            p[0] * x[0] - p[1] * x[1] + 0.2 * b[0],
        ])

    _, out, n, sp, data = _case("bolus_infusion")
    jm = pst.ODE(rhs(jnp), out=out, nstates=n, ndrugs=1, nout=1)
    tm = pt.ODE(rhs(torch), out=out, nstates=n, ndrugs=1, nout=1)
    want = np.asarray(jax_psi(jm, data, sp, _ems(), engine="xla"))
    got = pt.log_likelihood_matrix(tm, convert.data_from_reference(data), sp,
                                   convert.error_models_from_reference(_ems()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)


def test_rhs_list_with_python_constants_matches_jax():
    """An RHS returning a list whose components include a Python constant
    (a state that does not move): the segment march and the bolus by RHS
    difference both stack it on the working dtype and device."""
    _, _, _, sp, data = _case("bolus_infusion")
    out = lambda x, p, t, cov: x[0:1] / p[2]  # noqa: E731
    jm = pst.ODE(lambda x, p, t, b, r, cov: jnp.stack([-p[0] * x[0] + b[0] + r[0], 0.0]),
                 out=out, nstates=2, ndrugs=1, nout=1)
    tm = pt.ODE(lambda x, p, t, b, r, cov: [-p[0] * x[0] + b[0] + r[0], 0.0],
                out=out, nstates=2, ndrugs=1, nout=1)
    want = np.asarray(jax_psi(jm, data, sp, _ems(), engine="xla"))
    got = pt.log_likelihood_matrix(tm, convert.data_from_reference(data), sp,
                                   convert.error_models_from_reference(_ems()),
                                   engine="general")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("kw", ["lag", "fa", "init"])
def test_unported_ode_equations_raise(kw):
    """Lag, fa and init of ODE models are ported: each alone on the
    bolus + infusion model matches JAX ``engine='xla'`` (lag shifts each
    subject's bolus; the infusion is never lagged)."""
    fn = {"lag": lambda p, t, cov: {0: 0.1 + 0.2 * p[0]},
          "fa": lambda p, t, cov: {0: 0.6 + 0.1 * p[1]},
          "init": lambda p, t, cov: [0.0, 0.05 * p[2]]}[kw]
    _, out, _, sp, data = _case("bolus_infusion")
    jm = pst.ODE(_bolus_infusion(jnp), out=out, nstates=2, ndrugs=1, nout=1, **{kw: fn})
    tm = pt.ODE(_bolus_infusion(torch), out=out, nstates=2, ndrugs=1, nout=1, **{kw: fn})
    want = np.asarray(jax_psi(jm, data, sp, _ems(), engine="xla"))
    got = pt.log_likelihood_matrix(tm, convert.data_from_reference(data), sp,
                                   convert.error_models_from_reference(_ems()),
                                   engine="general").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
