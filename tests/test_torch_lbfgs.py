"""The port's L-BFGS (``optimize/_lbfgs.py``) against ``optax.lbfgs``.

The gradient fitters of the JAX package drive ``optax.lbfgs()`` (memory 10,
scaled initial preconditioner, zoom line search to the strong Wolfe
conditions) through ``optax.value_and_grad_from_state``; the port writes
that optimizer as host-side torch so that its fits take the same iterates.
Held here, float64 on the CPU: the iterates on Rosenbrock's function equal
optax's within 1e-8 relative over the first 20 steps, on a quadratic over
every step to convergence, and on an objective that is NaN outside its
domain (the line search's bracketing and safe-step paths) over 15 steps.
The test imports optax; the port never does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pharmsol_tpu_torch.optimize._lbfgs import MEMORY_SIZE, Lbfgs, value_and_grad_fn


def rosenbrock(lib):
    def f(x):
        return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    return f


def quadratic(lib):
    A = np.array([[4.0, 1.0, 0.2], [1.0, 3.0, -0.5], [0.2, -0.5, 2.0]])
    b = np.array([1.0, -2.0, 0.5])

    def f(x):
        Ax = lib.asarray(A) @ x if lib is jnp else torch.as_tensor(A) @ x
        return 0.5 * lib.sum(x * Ax) - lib.sum(lib.asarray(b) * x if lib is jnp
                                               else torch.as_tensor(b) * x)

    return f


def log_barrier(lib):
    # NaN where any coordinate is negative: the first trial step leaves the
    # domain, so the line search has to bracket back into it
    def f(x):
        return lib.sum((x - 3.0) ** 2) - 4.0 * lib.sum(lib.log(x))

    return f


def optax_iterates(f, x0, n):
    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(f)

    @jax.jit
    def step(z, state):
        value, grad = vg(z, state=state)
        updates, state = opt.update(grad, state, z, value=value, grad=grad, value_fn=f)
        return optax.apply_updates(z, updates), state, grad

    z, state, out, grads = jnp.asarray(x0), opt.init(jnp.asarray(x0)), [], []
    for _ in range(n):
        z, state, g = step(z, state)
        out.append(np.asarray(z))
        grads.append(np.asarray(g))
    return np.asarray(out), np.asarray(grads)


def port_iterates(f, x0, n):
    opt = Lbfgs()
    vg = value_and_grad_fn(f)
    z = torch.tensor(x0)
    state = opt.init(z)
    out, grads = [], []
    for _ in range(n):
        value, grad = opt.value_and_grad_from_state(vg, z, state)
        z, state = opt.step(vg, z, state, value, grad)
        out.append(z.numpy().copy())
        grads.append(grad.numpy().copy())
    return np.asarray(out), np.asarray(grads)


def test_rosenbrock_iterates_match_optax():
    x0 = np.array([-1.2, 1.0, -0.5, 0.8])
    want, _ = optax_iterates(rosenbrock(jnp), x0, 20)
    got, _ = port_iterates(rosenbrock(torch), x0, 20)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def test_quadratic_iterates_match_optax_to_convergence():
    x0 = np.array([2.0, -1.0, 3.0])
    want, wg = optax_iterates(quadratic(jnp), x0, 30)
    got, gg = port_iterates(quadratic(torch), x0, 30)
    # every step until the gradient vanishes (past it both sit at the optimum)
    n = int(np.argmax(np.max(np.abs(wg), axis=1) < 1e-13)) or 30
    assert n > 3
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-8, atol=1e-12)
    xs = np.linalg.solve(np.array([[4.0, 1.0, 0.2], [1.0, 3.0, -0.5], [0.2, -0.5, 2.0]]),
                         np.array([1.0, -2.0, 0.5]))
    np.testing.assert_allclose(got[-1], xs, rtol=1e-10, atol=1e-12)


def test_line_search_outside_the_domain_matches_optax():
    x0 = np.array([0.2, 5.0, 1.0])
    want, _ = optax_iterates(log_barrier(jnp), x0, 15)
    got, _ = port_iterates(log_barrier(torch), x0, 15)
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("objective", [rosenbrock, log_barrier])
def test_state_layout(objective):
    """The memory holds ``MEMORY_SIZE`` (optax's 10) difference pairs; the
    first iteration evaluates the objective, later ones reuse the line
    search's value and gradient."""
    opt = Lbfgs()
    calls = []
    f = objective(torch)

    def counted(z):
        calls.append(1)
        return f(z)

    vg = value_and_grad_fn(counted)
    z = torch.tensor([0.8, 1.5], dtype=torch.float64)
    state = opt.init(z)
    assert state.diff_params.shape == (MEMORY_SIZE, 2) and not np.isfinite(state.value)
    value, grad = opt.value_and_grad_from_state(vg, z, state)
    assert len(calls) == 1
    z, state = opt.step(vg, z, state, value, grad)
    n = len(calls)
    value2, grad2 = opt.value_and_grad_from_state(vg, z, state)
    assert len(calls) == n and value2 == state.value and grad2 is state.grad
    assert state.count == 1 and state.linesearch_steps >= 1
