"""The closure styles and the elementwise set against the JAX package.

Float64 on the CPU, inputs from numpy seeds:

- **Vector style**: the JAX package's own vector-style model
  (``tests/test_pallas_ode.py:1102``: ``jnp.zeros_like(x)`` and ``.at[i]``
  writes, which its plan runs through ``make_stacked_rhs``) against the
  port's spelling (``torch.zeros_like(x)`` and writes) under dopri5: the
  port's twin (``"stacked"`` style, called under ``vmap``) against JAX
  ``engine='pallas'`` in interpret mode within 1e-9, its general engine
  against JAX ``engine='xla'`` within 1e-10.
- **The math model** (``utils/style_cases.py::math_case``: every operation
  of the elementwise set and a state-dependent power, a time-varying weight
  and a lag): the general engine against JAX ``engine='xla'`` within 1e-10
  under dopri5 and bdf (kvaerno3: ``test_torch_rhs_styles_sdirk.py``, its
  general engine takes most of a file's time), and the fused twin against
  the general engine within the controller's error (1e-4; 1e-3 for bdf).
- **``x.sum()``**: a reduction over the states, held to JAX
  ``engine='xla'`` (general engine 1e-10, twin within the controller's
  error). JAX ``engine='pallas'`` is not the reference here: its stacked
  arrays are ``[n, rows, sp]``, so ``x.sum()`` sums across lanes as well,
  and its psi parts from its own ``xla`` engine's by far more than the
  controller's error; the port sums the states of one lane.
- **SDE drifts** with ``tanh`` and ``log1p``: ``test_torch_rhs_styles_sde.py``
  (the JAX SDE kernel in interpret mode takes most of a file's time).
- **Refusals**: a ``math`` function of a traced value and a write at a
  data-dependent index are refused by both packages' fused plans.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import jax.scipy.special as jss
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
from pharmsol_tpu_torch.ops import fused_ode
from pharmsol_tpu_torch.utils import style_cases as sc

# the JAX package's functions under the math model's names
JAX_F = SimpleNamespace(
    tanh=jnp.tanh, sinh=jnp.sinh, cosh=jnp.cosh, asin=jnp.arcsin, acos=jnp.arccos,
    atan=jnp.arctan, atan2=jnp.arctan2, sigmoid=jax.nn.sigmoid, log1p=jnp.log1p,
    expm1=jnp.expm1, erf=jss.erf, erfc=jss.erfc, square=jnp.square,
    rsqrt=jax.lax.rsqrt, reciprocal=jnp.reciprocal, sign=jnp.sign)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _ems(lib):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def _plan(model, data, sp, ems):
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedOdePsiPlan(model, grid, sp, lowered, torch.device("cpu"), torch.float64)


# ---------------------------------------------------------------------------
# Vector style: the JAX package's stacked-array model
# ---------------------------------------------------------------------------


def _jax_vector(x, p, t, b, rateiv, cov):  # tests/test_pallas_ode.py:1109-1113
    dx = jnp.zeros_like(x)
    dx = dx.at[0].set(-p[0] * x[0] + b[0])
    dx = dx.at[1].set(p[0] * x[0] - p[1] * x[1] + rateiv[0])
    return dx


def _port_vector(x, p, t, b, rateiv, cov):
    dx = torch.zeros_like(x)
    dx[0] = -p[0] * x[0] + b[0]
    dx[1] = p[0] * x[0] - p[1] * x[1] + rateiv[0]
    return dx


def _vector_case():
    """The data and supports of tests/test_pallas_ode.py:1115-1129."""
    subs = []
    for i in range(5):
        sb = pst.SubjectBuilder(f"s{i}").bolus(0.0, 100.0, 0)
        if i % 2 == 0:
            sb = sb.infusion(1.0, 30.0, 0, 0.8)
        for t in (0.5, 1.5, 3.0, 6.0):
            sb = sb.observation(t, float(5 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subs.append(sb.build())
    rng = np.random.default_rng(4)
    sp = np.column_stack([rng.uniform(0.8, 1.6, 6), rng.uniform(0.15, 0.4, 6),
                          rng.uniform(8, 14, 6)])
    return pst.Data(subs), sp


def test_vector_style_matches_the_jax_stacked_kernel():
    from pharmsol_tpu.likelihood.matrix import _PallasOdePsiPlan
    from pharmsol_tpu.ops.pallas_psi import SUB_TILE

    data, sp = _vector_case()
    out = lambda x, p, t, cov: x[1:2] / p[2]  # noqa: E731
    jm = pst.ODE(_jax_vector, out=out, nstates=2, ndrugs=1, nout=1)
    tm = pt.ODE(_port_vector, out=out, nstates=2, ndrugs=1, nout=1)
    jplan = _PallasOdePsiPlan(jm, jm.lower(data.subjects()), sp,
                              _ems(pst).lower(jm.resolve_output_label, 1),
                              row_multiple=SUB_TILE)
    pdata = convert.data_from_reference(data)
    assert jplan.rhs_style == _plan(tm, pdata, sp, _ems(pt)).rhs.style == "stacked"
    want_pallas = np.asarray(jax_psi(jm, data, sp, _ems(pst), engine="pallas"))
    want_xla = np.asarray(jax_psi(jm, data, sp, _ems(pst), engine="xla"))
    before = fused_ode.LAUNCHES
    twin = pt.log_likelihood_matrix(tm, pdata, sp, _ems(pt), engine="fused").numpy()
    assert fused_ode.LAUNCHES == before  # the twin ran: CPU tensors
    general = pt.log_likelihood_matrix(tm, pdata, sp, _ems(pt), engine="general").numpy()
    assert np.isfinite(twin).all() and twin.shape == (5, 6)
    assert _rel(twin, want_pallas) <= 1e-9
    assert _rel(general, want_xla) <= 1e-10


# ---------------------------------------------------------------------------
# The math model: every operation of the elementwise set
# ---------------------------------------------------------------------------

MATH_SHAPE = dict(n_subjects=2, n_support=2, seed=5, times=(0.5, 1.0, 2.0))


@pytest.mark.parametrize("solver", ["dopri5", "bdf"])
def test_math_model_matches_jax_xla_and_its_twin(solver):
    jm, jdata, sp, jems = sc.math_case(lib=pst, F=JAX_F, stack=jnp.stack, solver=solver,
                                       **MATH_SHAPE)
    tm, tdata, tsp, tems = sc.math_case(solver=solver, **MATH_SHAPE)
    np.testing.assert_array_equal(sp, tsp)
    want = np.asarray(jax_psi(jm, jdata, sp, jems, engine="xla"))
    general = pt.log_likelihood_matrix(tm, tdata, sp, tems, engine="general").numpy()
    assert np.isfinite(want).all()
    assert _rel(general, want) <= 1e-10
    plan = _plan(tm, tdata, sp, tems)
    assert plan.rhs.style == "lanes" and plan.features["lag_plane"] is not None
    assert plan.rhs.cov_modes == ("affine",) and plan.rhs.jacobian == (solver != "dopri5")
    twin = plan.run().numpy()
    assert _rel(twin, general) <= (1e-4 if solver == "dopri5" else 1e-3)


# ---------------------------------------------------------------------------
# x.sum(): held to JAX xla
# ---------------------------------------------------------------------------


def _jax_sum(x, p, t, b, rateiv, cov):
    dx = jnp.zeros_like(x)
    dx = dx.at[0].set(-p[0] * x[0] + b[0])
    return dx.at[1].set(p[0] * x[0] - p[1] * x[1] * (1.0 + 0.01 * x.sum()) + rateiv[0])


def _port_sum(x, p, t, b, rateiv, cov):
    dx = torch.zeros_like(x)
    dx[0] = -p[0] * x[0] + b[0]
    dx[1] = p[0] * x[0] - p[1] * x[1] * (1.0 + 0.01 * x.sum()) + rateiv[0]
    return dx


@pytest.mark.parametrize("solver", ["dopri5", "bdf"])
def test_state_sum_is_held_to_jax_xla(solver):
    data, sp = _vector_case()
    out = lambda x, p, t, cov: x[1:2] / p[2]  # noqa: E731
    jm = pst.ODE(_jax_sum, out=out, nstates=2, ndrugs=1, nout=1).with_solver(solver)
    tm = pt.ODE(_port_sum, out=out, nstates=2, ndrugs=1, nout=1).with_solver(solver)
    want = np.asarray(jax_psi(jm, data, sp[:3], _ems(pst), engine="xla"))
    pdata = convert.data_from_reference(data)
    general = pt.log_likelihood_matrix(tm, pdata, sp[:3], _ems(pt), engine="general").numpy()
    twin = pt.log_likelihood_matrix(tm, pdata, sp[:3], _ems(pt), engine="fused").numpy()
    assert _rel(general, want) <= 1e-10
    assert _rel(twin, want) <= (1e-4 if solver == "dopri5" else 1e-3)


# ---------------------------------------------------------------------------
# Refused by both packages
# ---------------------------------------------------------------------------


def _math_call(xp):
    return lambda x, p, t, b, r, cov: xp.stack([-p[0] * math.tanh(x[0]) + b[0],
                                                 p[0] * x[0] - p[1] * x[1]])


def _masked(xp):
    if xp is jnp:
        return lambda x, p, t, b, r, cov: jnp.zeros_like(x).at[x > 1.0].set(-p[0]) + b[0]

    def diffeq(x, p, t, b, r, cov):
        dx = torch.zeros_like(x)
        dx[x > 1.0] = -p[0]
        return dx + b[0]
    return diffeq


@pytest.mark.parametrize("closure, reason", [
    (_math_call, "converts a traced value to a Python number"),
    (_masked, "no data-dependent indexing"),
])
def test_both_fused_plans_refuse(closure, reason):
    from pharmsol_tpu.likelihood.matrix import _PallasOdePsiPlan
    from pharmsol_tpu.ops.pallas_psi import SUB_TILE

    data, sp = _vector_case()
    out = lambda x, p, t, cov: x[1:2] / p[2]  # noqa: E731
    jm = pst.ODE(closure(jnp), out=out, nstates=2, ndrugs=1, nout=1)
    with pytest.raises(pst.PharmsolError, match="could not trace the RHS"):
        _PallasOdePsiPlan(jm, jm.lower(data.subjects()), sp,
                          _ems(pst).lower(jm.resolve_output_label, 1), row_multiple=SUB_TILE)
    tm = pt.ODE(closure(torch), out=out, nstates=2, ndrugs=1, nout=1)
    with pytest.raises(PharmsolError, match=reason):
        _plan(tm, convert.data_from_reference(data), sp, _ems(pt))
