"""The replicate layer's engine: the port's batched L-BFGS
(``optimize/_lbfgs.py::BatchLbfgs``) and its batched Laplace objective
(``neg_laplace_*_lanes`` of ``optimize/laplace.py``).

The JAX package refits every replicate as ``jax.vmap`` of an optax L-BFGS
``lax.scan`` (``optimize/bootstrap.py::_vectorized_refits``); the port runs B
lanes of one L-BFGS whose objective folds the replicate axis into the
subject axis. Held here, float64 on the CPU:

- every lane of ``BatchLbfgs`` equals the scalar port ``Lbfgs`` run alone
  on that lane's objective within 1e-10 relative (Rosenbrock with per-lane
  offsets; the log-barrier objective that is NaN outside its domain, whose
  line search brackets back into it; a lane whose objective is NaN
  everywhere, which changes no other lane);
- the port's ``_vectorized_refits`` equals the JAX package's on the same
  objectives, warm start and step counts within 1e-8 relative (20 steps);
- the batched Laplace objective equals a loop of the port's per-replicate
  ``neg_laplace_wxy`` for each of the w, y and (x, onehot) operands, value
  within 1e-12 relative and gradient within 1e-10 relative (plus 1e-12
  absolute), and a NaN lane leaves the other lanes' values and gradients
  unchanged.

Marked ``slow``: the literal JAX ``_vectorized_refits`` over the JAX Laplace
objective (one compile takes ~2 minutes on this CPU) against the port's,
``Z`` within 1e-8; the gate holds the same refit through the JAX objective
instead (``tests/test_torch_bootstrap.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.optimize.bootstrap import _vectorized_refits as jax_vectorized_refits

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.optimize import fit_laplace
from pharmsol_tpu_torch.optimize._lbfgs import (
    BatchLbfgs,
    Lbfgs,
    batch_value_and_grad_fn,
    value_and_grad_fn,
)
from pharmsol_tpu_torch.optimize.bootstrap import _vectorized_refits

from test_torch_laplace import covariate_population

OFFSETS = np.array([[0.0, 0.0, 0.0, 0.0], [0.3, -0.2, 0.1, 0.5], [-0.4, 0.25, 0.6, -0.1],
                    [0.1, 0.1, -0.3, 0.2]])
X0_ROSEN = np.array([-1.2, 1.0, -0.5, 0.8])
X0_BARRIER = np.array([[0.2, 5.0, 1.0], [0.5, 4.0, 2.0], [1.5, 0.3, 6.0]])


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def rosen_lanes(Z, off):
    """Rosenbrock of ``Z - off`` per lane: [B, n] -> [B]."""
    x = Z - off
    return torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2, dim=-1)


def rosen_jax(z, off):
    x = z - off
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def barrier_lanes(Z, c):
    return torch.sum((Z - c) ** 2, dim=-1) - 4.0 * torch.sum(torch.log(Z), dim=-1)


def barrier_jax(z, c):
    return jnp.sum((z - c) ** 2) - 4.0 * jnp.sum(jnp.log(z))


def batch_iterates(fn, Z0, n):
    opt, vg = BatchLbfgs(), batch_value_and_grad_fn(fn)
    z, state, out = torch.tensor(Z0), None, []
    state = opt.init(z)
    for _ in range(n):
        value, grad = opt.value_and_grad_from_state(vg, z, state)
        z, state = opt.step(vg, z, state, value, grad)
        out.append(z.numpy().copy())
    return np.asarray(out)  # [n, B, dim]


def scalar_iterates(fn, x0, n):
    opt, vg = Lbfgs(), value_and_grad_fn(fn)
    z = torch.tensor(x0)
    state = opt.init(z)
    out = []
    for _ in range(n):
        value, grad = opt.value_and_grad_from_state(vg, z, state)
        z, state = opt.step(vg, z, state, value, grad)
        out.append(z.numpy().copy())
    return np.asarray(out)


@pytest.mark.parametrize("case", ["rosenbrock", "log_barrier"])
def test_each_lane_equals_the_scalar_lbfgs(case):
    if case == "rosenbrock":
        ops = torch.tensor(OFFSETS)
        Z0 = np.broadcast_to(X0_ROSEN, OFFSETS.shape).copy()
        fn = lambda Z: rosen_lanes(Z, ops)  # noqa: E731
        one = lambda k: (lambda z: rosen_lanes(z[None], ops[k:k + 1])[0])  # noqa: E731
    else:
        cs = torch.tensor([3.0, 2.0, 4.0], dtype=torch.float64)[:, None]
        Z0 = X0_BARRIER
        fn = lambda Z: barrier_lanes(Z, cs)  # noqa: E731
        one = lambda k: (lambda z: barrier_lanes(z[None], cs[k:k + 1])[0])  # noqa: E731
    got = batch_iterates(fn, Z0, 20)
    for k in range(Z0.shape[0]):
        want = scalar_iterates(one(k), Z0[k], 20)
        np.testing.assert_allclose(got[:, k], want, rtol=1e-10, atol=1e-13)


def test_a_nan_lane_changes_no_other_lane():
    """Lane 1's objective is NaN everywhere (its offset is NaN): lanes 0
    and 2 take exactly the iterates they take without it."""
    ops = torch.tensor(OFFSETS[:3])
    bad = ops.clone()
    bad[1] = float("nan")

    Z0 = np.broadcast_to(X0_ROSEN, (3, 4)).copy()
    got = batch_iterates(lambda Z: rosen_lanes(Z, bad), Z0, 12)
    clean = batch_iterates(lambda Z: rosen_lanes(Z, ops[[0, 2]]), Z0[[0, 2]], 12)
    np.testing.assert_array_equal(got[:, [0, 2]], clean)


@pytest.mark.parametrize("case", ["rosenbrock", "log_barrier"])
def test_vectorized_refits_match_jax(case):
    if case == "rosenbrock":
        Z0, ops = np.broadcast_to(X0_ROSEN, OFFSETS.shape).copy(), OFFSETS
        jfn, tfn = rosen_jax, rosen_lanes
    else:
        Z0, ops = X0_BARRIER, np.array([[3.0], [2.0], [4.0]])
        jfn, tfn = (lambda z, c: barrier_jax(z, c[0])), barrier_lanes
    for steps in (5, 20):
        jz, jg, jf = jax_vectorized_refits(jfn, jnp.asarray(Z0), jnp.asarray(ops), steps)
        z, g, f = _vectorized_refits(tfn, torch.tensor(Z0), torch.tensor(ops), steps)
        assert np.all(np.isfinite(jz))
        np.testing.assert_allclose(z, jz, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(f, jf, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-9)


# -- the batched Laplace objective -----------------------------------------------

B = 3
KW = dict(covariate_effects=[(1, "wt", "power", 70.0)])


def _model():
    return pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                         nstates=1, ndrugs=1, nout=1)


def _prop():
    return pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.proportional(0.2))


@pytest.fixture(scope="module")
def laplace_pieces():
    data = convert.data_from_reference(covariate_population(n=6, seed=4))
    intro = {}
    fit_laplace(_model(), data, _prop(), [0.3, 10.0], _introspect=intro, _build_only=True,
                device="cpu", **KW)
    rng = np.random.default_rng(11)
    psi0 = intro["psi0"].numpy()
    psis = psi0[None, :] + rng.uniform(-0.1, 0.1, size=(B, psi0.size))
    cond = intro["cond"]
    obs = cond.obs_value.numpy()
    ops = dict(
        w=torch.tensor(rng.integers(0, 3, size=(B, cond.n_sub)).astype(float)),
        y=torch.tensor(obs[None] * (1.0 + 0.05 * rng.standard_normal((B,) + obs.shape))),
        x=torch.tensor(rng.uniform(-0.5, 0.5, size=(B, cond.n_sub, 1))),
        onehot=torch.tensor(np.eye(2)[[rng.integers(0, 2) for _ in range(B)]][:, None, :]))
    return intro, torch.tensor(psis), ops


def _lane_args(ops, operand, k=None):
    """(w, y, x, onehot) of every lane (k None) or of lane k, with the
    operand under test drawn per lane and the others at their defaults."""
    sl = slice(None) if k is None else k
    n = ops["w"].shape[1]
    w = ops["w"][sl] if operand == "w" else (torch.ones(B, n) if k is None else torch.ones(n))
    w = w.to(torch.float64)
    y = ops["y"][sl] if operand == "y" else None
    x = ops["x"][sl] if operand == "x" else None
    oh = ops["onehot"][sl] if operand == "x" else None
    return w, y, x, oh


@pytest.mark.parametrize("operand", ["w", "y", "x"])
def test_batched_objective_equals_the_per_replicate_loop(laplace_pieces, operand):
    intro, psis, ops = laplace_pieces
    z = psis.clone().requires_grad_(True)
    F = intro["neg_laplace_wxy_lanes"](z, *_lane_args(ops, operand))
    (G,) = torch.autograd.grad(F.sum(), z)
    for k in range(B):
        zk = psis[k].clone().requires_grad_(True)
        f = intro["neg_laplace_wxy"](zk, *_lane_args(ops, operand, k))
        (g,) = torch.autograd.grad(f, zk)
        np.testing.assert_allclose(float(F[k].detach()), float(f.detach()), rtol=1e-12)
        np.testing.assert_allclose(G[k].numpy(), g.numpy(), rtol=1e-10, atol=1e-12)


def test_a_nan_lane_leaves_the_other_lanes_of_the_objective(laplace_pieces):
    intro, psis, ops = laplace_pieces
    w = ops["w"].to(torch.float64)
    bad = psis.clone()
    bad[1, 0] = float("nan")
    got, want = [], []
    for p in (bad, psis):
        z = p.clone().requires_grad_(True)
        F = intro["neg_laplace_w_lanes"](z, w)
        (G,) = torch.autograd.grad(F.sum(), z)
        got.append((F.detach(), G))
    assert torch.isnan(got[0][0][1])
    for k in (0, 2):
        np.testing.assert_array_equal(got[0][0][k].numpy(), got[1][0][k].numpy())
        np.testing.assert_array_equal(got[0][1][k].numpy(), got[1][1][k].numpy())


@pytest.mark.slow
def test_laplace_refits_match_jax_vectorized_refits():
    """The literal JAX program (vmap of the optax scan over the JAX
    objective) against the port's lanes, from psi0 with bootstrap weights."""
    from pharmsol_tpu.optimize import fit_laplace as jax_fit_laplace
    from test_laplace import _population

    jd = _population(n=6, seed=3)[0]
    jintro, intro = {}, {}
    jax_fit_laplace(pst.Analytical(pst.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                                   nstates=1, ndrugs=1, nout=1), jd,
                    pst.ResidualErrorModels().add(0, pst.ResidualErrorModel.proportional(0.2)),
                    [0.3, 10.0], _introspect=jintro, _build_only=True)
    fit_laplace(_model(), convert.data_from_reference(jd), _prop(), [0.3, 10.0],
                _introspect=intro, _build_only=True, device="cpu")
    W = np.random.default_rng(0).integers(0, 3, size=(3, 6)).astype(float)
    jz, _, jf = jax_vectorized_refits(lambda z, w: jintro["neg_laplace_w"](z, w),
                                      jintro["psi0"], jnp.asarray(W), 3)
    z, _, f = _vectorized_refits(intro["neg_laplace_w_lanes"], intro["psi0"],
                                 torch.tensor(W), 3)
    np.testing.assert_allclose(z, jz, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(f, jf, rtol=1e-8)


# -- shared by the replicate layer's parity files -----------------------------------


def jax_objective_refits(jvg, Z0, operands, steps):
    """The port's ``BatchLbfgs`` driving the JAX package's objective: ``jvg``
    maps ``(Z [B, dim], *operands)`` to the lanes' values and gradients (a
    jitted ``vmap(value_and_grad(...))`` of the JAX objective). Returns
    ``(Z, G, F)`` as ``_vectorized_refits`` does, so that the port's refit
    over its own objective can be held against the same refit over the JAX
    objective (the optimizer itself is held against the JAX program above)."""
    ops = tuple(jnp.asarray(np.asarray(o)) for o in operands)

    def vg(Z):
        v, g = jvg(jnp.asarray(Z.numpy()), *ops)
        return torch.tensor(np.asarray(v)), torch.tensor(np.asarray(g))

    z = torch.tensor(np.asarray(Z0, dtype=np.float64)).clone()
    opt = BatchLbfgs()
    state = opt.init(z)
    for _ in range(steps):
        value, grad = opt.value_and_grad_from_state(vg, z, state)
        z, state = opt.step(vg, z, state, value, grad)
    F, G = vg(z)
    return z.numpy(), G.abs().max(dim=-1).values.numpy(), F.numpy()
