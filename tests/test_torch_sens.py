"""Continuous forward sensitivities (``engine/sens.py``) against the JAX
package's ``engine/sens.py::make_sens_pred_one``.

The port's sensitivity rule is a ``torch.autograd.Function`` whose forward is
the base solve and whose derivatives solve the augmented ODE ``[x; s]``, one
level more per order. On a 2-state oral ODE (dopri5, boluses and an
infusion, two subjects with their own parameter rows), float64 on the CPU:

- the predictions, the prediction Jacobian and the second derivatives
  against ``jax.jacfwd`` (and ``jacfwd`` of ``jacfwd``) of the JAX rule,
  within 1e-8 relative, by the port's forward mode (``torch.func.jacfwd``
  through the Function's ``jvp`` and ``vmap`` rules) and by its reverse
  mode (``backward``, and ``backward`` of ``backward``);
- a closure the RHS generator cannot trace (a covariate read): the
  augmented RHS by ``torch.func.jvp`` of the closure, the Jacobian against
  the JAX rule's;
- the scope guard: a model with lag (or fa) is refused by
  ``supports_forward_sens`` and the conditional likelihood then
  differentiates the stepper;
- the named per-segment steppers (``engine/ode.py::dopri5_segment``,
  ``kvaerno3_segment``) against the JAX package's on one segment.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.engine import ode as jax_ode
from pharmsol_tpu.engine.sens import make_sens_pred_one
from pharmsol_tpu.engine.sens import supports_forward_sens as jax_supports

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.engine import ode as pt_ode
from pharmsol_tpu_torch.engine.sens import augmented_equation, make_sens_pred, supports_forward_sens
from pharmsol_tpu_torch.likelihood.matrix import _device_rows

RTOL = 1e-8
P = np.array([[1.1, 0.25, 11.0], [0.8, 0.3, 9.0]])


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _oral_ode(lib, stack, **kw):
    return lib.ODE(lambda x, p, t, b, rateiv, cov: stack([-p[0] * x[0] + b[0],
                                                          p[0] * x[0] - p[1] * x[1] + rateiv[0]]),
                   out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1, **kw)


def _data():
    subjects = []
    for i in range(2):
        sb = pst.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).infusion(1.0, 30.0, 0, 2.0)
        for t in (0.5, 2.0, 6.0):
            sb = sb.observation(t, float(5 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subjects.append(sb.build())
    return pst.Data(subjects)


@pytest.fixture(scope="module")
def reference():
    """The JAX rule's predictions [R, NO], Jacobian [R, NO, P] and second
    derivatives [R, NO, P, P] (jacfwd over the per-row prediction)."""
    jd = _data()
    jm = _oral_ode(pst, jnp.stack)
    grid = jm.lower(jd.subjects())
    pred_one = make_sens_pred_one(jm, tuple(grid.cov_names))
    idx = jnp.arange(grid.rows.obs_t.shape[0])

    def one(p, occ, i):
        return pred_one(occ, p, i)

    y = jax.jit(jax.vmap(one))(jnp.asarray(P), grid.rows, idx)
    J = jax.jit(jax.vmap(jax.jacfwd(one)))(jnp.asarray(P), grid.rows, idx)
    H = jax.jit(jax.vmap(jax.jacfwd(jax.jacfwd(one))))(jnp.asarray(P), grid.rows, idx)
    return jd, np.asarray(y), np.asarray(J), np.asarray(H)


def _port_pred(jd):
    tm = _oral_ode(pt, torch.stack)
    grid = tm.lower(convert.data_from_reference(jd).subjects())
    rows = _device_rows(grid, torch.device("cpu"), torch.float64)
    return tm, make_sens_pred(tm, rows, grid.cov_names)


def _diag(a, k):
    """The row-diagonal blocks of a jacfwd over all rows: [R, NO, R, P, ...]
    -> [R, NO, P, ...] (rows are independent)."""
    R = a.shape[0]
    if k == 1:
        return np.stack([a[r, :, r] for r in range(R)])
    return np.stack([a[r, :, r, :, r] for r in range(R)])


def test_predictions_and_forward_mode_derivatives_match_jax(reference):
    jd, y, J, H = reference
    _, pred = _port_pred(jd)
    x = torch.tensor(P)
    np.testing.assert_allclose(pred(x).numpy(), y, rtol=1e-12, atol=0)
    Jf = _diag(torch.func.jacfwd(pred)(x).numpy(), 1)
    np.testing.assert_allclose(Jf, J, rtol=RTOL, atol=0)
    Hf = _diag(torch.func.jacfwd(torch.func.jacfwd(pred))(x).numpy(), 2)
    np.testing.assert_allclose(Hf, H, rtol=RTOL, atol=1e-14)


def test_reverse_mode_derivatives_match_jax(reference):
    """``backward`` gives the Jacobian (one backward pass per observation
    slot) and, differentiated again, the second derivatives: the backward
    pass runs through the next level's Function."""
    jd, _, J, H = reference
    _, pred = _port_pred(jd)
    x = torch.tensor(P, requires_grad=True)
    y = pred(x)
    NO = y.shape[1]
    for o in range(NO):
        sel = torch.zeros_like(y)
        sel[:, o] = 1.0
        (g,) = torch.autograd.grad(y, x, sel, create_graph=True)
        np.testing.assert_allclose(g.detach().numpy(), J[:, o], rtol=RTOL, atol=0)
        if o == NO - 1:
            for k in range(P.shape[1]):
                (h,) = torch.autograd.grad(g[:, k].sum(), x, retain_graph=True)
                np.testing.assert_allclose(h.numpy(), H[:, o, k], rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("mode", ["reverse", "forward"])
def test_a_derivative_beyond_the_tower_raises(reference, monkeypatch, mode):
    """Past ``SENS_DEPTH`` orders the rule raises instead of switching to a
    derivative of the stepper: with the tower cut to one order, the first
    derivative still matches the JAX rule and the second raises."""
    from pharmsol_tpu_torch.engine import sens
    from pharmsol_tpu_torch.errors import PharmsolError

    monkeypatch.setattr(sens, "SENS_DEPTH", 1)
    jd, _, J, _ = reference
    _, pred = _port_pred(jd)
    x = torch.tensor(P, requires_grad=True)
    if mode == "forward":
        np.testing.assert_allclose(_diag(torch.func.jacfwd(pred)(x).detach().numpy(), 1), J,
                                   rtol=RTOL, atol=0)
        with pytest.raises(PharmsolError, match="1 orders of derivative"):
            torch.func.jacfwd(torch.func.jacfwd(pred))(x)
        return
    y = pred(x)
    sel = torch.zeros_like(y)
    sel[:, 0] = 1.0
    (g,) = torch.autograd.grad(y, x, sel, create_graph=True)
    np.testing.assert_allclose(g.detach().numpy(), J[:, 0], rtol=RTOL, atol=0)
    with pytest.raises(PharmsolError, match="1 orders of derivative"):
        torch.autograd.grad(g[:, 0].sum(), x)


def test_augmented_model_doubles_the_states_and_shares_the_options():
    tm = _oral_ode(pt, torch.stack).with_tolerances(1e-6, 1e-6)
    aug = augmented_equation(tm, 3)
    assert (aug.nstates(), aug.nouteqs(), aug.ndrugs()) == (4, 2, 1)
    assert aug._opts == tm._opts
    assert augmented_equation(tm, 3) is aug
    # a closure the RHS generator traces: one program on every lane
    assert aug._diffeq.lanes and augmented_equation(aug, 6)._diffeq.lanes
    # the tangent half of the RHS is the jvp of the closure
    f64 = torch.float64
    x = torch.tensor([2.0, 1.0, 0.5, -0.25], dtype=f64)
    p = torch.tensor([1.1, 0.25, 11.0, 1.0, 0.0, 0.0], dtype=f64)
    z = torch.zeros(1, dtype=f64)
    dx = aug._diffeq(x, p, torch.tensor(0.0, dtype=f64), z, z, None)
    np.testing.assert_allclose(dx.numpy(), [-2.2, 2.2 - 0.25, -1.1 * 0.5 - 2.0,
                                            1.1 * 0.5 + 2.0 + 0.0625], rtol=1e-15)


def _covariate_ode(lib, stack):
    # the covariate read keeps the closure from the RHS generator's trace:
    # the augmented RHS is the closure's torch.func.jvp, lane by lane
    return lib.ODE(lambda x, p, t, b, rateiv, cov: stack([
        -p[0] * x[0] + b[0],
        p[0] * x[0] - p[1] * (cov("wt", t) / 70.0) * x[1] + rateiv[0]]),
        out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)


def test_untraced_closure_matches_jax():
    """An RHS that reads a covariate goes through ``torch.func.jvp`` of the
    closure: the prediction Jacobian against the JAX rule's, both modes."""
    subjects = []
    for i, wt in enumerate((60.0, 85.0)):
        sb = pst.Subject.builder(f"c{i}").bolus(0.0, 100.0, 0).covariate("wt", 0.0, wt)
        sb = sb.covariate("wt", 4.0, wt + 10.0)
        for t in (0.5, 2.0, 6.0):
            sb = sb.observation(t, 4.0 - 0.3 * t, 0)
        subjects.append(sb.build())
    jd = pst.Data(subjects)
    jm = _covariate_ode(pst, jnp.stack)
    grid = jm.lower(jd.subjects())
    pred_one = make_sens_pred_one(jm, tuple(grid.cov_names))
    idx = jnp.arange(grid.rows.obs_t.shape[0])
    J = np.asarray(jax.jit(jax.vmap(jax.jacfwd(lambda p, occ, i: pred_one(occ, p, i))))(
        jnp.asarray(P), grid.rows, idx))
    tm = _covariate_ode(pt, torch.stack)
    tgrid = tm.lower(convert.data_from_reference(jd).subjects())
    rows = _device_rows(tgrid, torch.device("cpu"), torch.float64)
    pred = make_sens_pred(tm, rows, tgrid.cov_names)
    assert not getattr(augmented_equation(tm, 3)._diffeq, "lanes", False)
    Jf = _diag(torch.func.jacfwd(pred)(torch.tensor(P)).numpy(), 1)
    np.testing.assert_allclose(Jf, J, rtol=RTOL, atol=0)
    x = torch.tensor(P, requires_grad=True)
    y = pred(x)
    (g,) = torch.autograd.grad(y[:, 0].sum(), x)
    np.testing.assert_allclose(g.numpy(), J[:, 0], rtol=RTOL, atol=0)


def test_lag_and_fa_models_are_outside_the_scope_guard():
    """As the JAX package's ``supports_forward_sens``: lag and fa move the
    segment grid with the parameters, so those models take the stepper path
    (the conditional likelihood differentiates the march); closed forms are
    outside the ODE path altogether."""
    lag = {"lag": lambda p, t, cov: {0: p[2] * 0.01}}
    fa = {"fa": lambda p, t, cov: {0: 0.9}}
    for kw, want in (({}, True), (lag, False), (fa, False)):
        assert supports_forward_sens(_oral_ode(pt, torch.stack, **kw)) is want
        assert jax_supports(_oral_ode(pst, jnp.stack, **kw)) is want
    assert not supports_forward_sens(pt.Analytical(pt.one_compartment, nstates=1, ndrugs=1,
                                                   nout=1))
    from pharmsol_tpu_torch.optimize._condll import build_cond_ll

    td = convert.data_from_reference(_data())
    rems = pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.proportional(0.1))
    lagged = _oral_ode(pt, torch.stack, **lag)
    cond = build_cond_ll(lagged, td, rems)
    x = torch.tensor(P, requires_grad=True)
    sig = torch.tensor([0.0], dtype=torch.float64), torch.tensor([0.1], dtype=torch.float64)
    ll, _, _ = cond.ll_parts(x, *sig)
    (g,) = torch.autograd.grad(ll.sum(), x)
    assert torch.isfinite(g).all() and (g != 0).any()


@pytest.mark.parametrize("solver", ["dopri5", "kvaerno3"])
def test_named_segment_steppers_match_jax(solver):
    """One segment of the named steppers on a stiff-ish linear system."""
    A = np.array([[-3.0, 1.0], [2.0, -0.5]])
    x0 = np.array([1.0, 0.2])
    jopts = jax_ode.ODEOptions(rtol=1e-8, atol=1e-8, solver=solver)
    topts = pt_ode.ODEOptions(rtol=1e-8, atol=1e-8, solver=solver)
    jf = jax.jit(lambda x: getattr(jax_ode, f"{solver}_segment")(
        lambda xx, t: jnp.asarray(A) @ xx, x, 0.0, 2.5, jopts))
    want = np.asarray(jf(jnp.asarray(x0)))
    At = torch.tensor(A)

    def f(xx, t):
        return xx @ At.T

    def jac(xx, t):
        return At.expand(xx.shape[:-1] + At.shape)

    x = torch.tensor(x0)[None]
    t0, t1 = torch.zeros(1, dtype=torch.float64), torch.full((1,), 2.5, dtype=torch.float64)
    if solver == "dopri5":
        got = pt_ode.dopri5_segment(f, x, t0, t1, topts)[0]
    else:
        got = pt_ode.kvaerno3_segment(f, jac, x, t0, t1, topts)[0]
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-10, atol=0)
