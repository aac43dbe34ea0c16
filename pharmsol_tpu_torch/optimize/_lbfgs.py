"""L-BFGS with a zoom line search to the strong Wolfe conditions.

The gradient fitters of the JAX package (``optimize/map.py``,
``optimize/laplace.py``) drive ``optax.lbfgs()`` through
``optax.value_and_grad_from_state``; this module is that optimizer written
as host-side torch, so that a fit in the port takes the same iterates as the
JAX fit: optax 0.2.6's defaults, step for step.

- the direction: the two-loop recursion over a memory of 10 (parameter,
  gradient) differences (Nocedal & Wright, Algorithm 7.4), the initial
  inverse Hessian a scaled identity, ``s'y / y'y`` of the newest pair and on
  the first step the capped reciprocal of the gradient norm ``min(1,
  1/|g|)``;
- the step length: the zoom line search (Nocedal & Wright, Algorithms 3.5
  and 3.6) from a first guess of 1, sufficient decrease ``c1 = 1e-4`` with
  the approximate-Wolfe variant (``1e-6`` relative), curvature ``c2 = 0.9``,
  at most 20 evaluations, the step doubled while no bracket is found, then
  a cubic, quadratic or bisection point inside the bracket; when the search
  fails it falls back on the best step that decreased the objective;
- the value and gradient at the accepted step are kept and handed to the
  next iteration instead of being computed again.

Vectors stay on their device as torch tensors; the line search's scalars
are float64 numpy values (IEEE semantics: a NaN or an infinity propagates
as it does in the JAX code, where Python floats would raise).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["MEMORY_SIZE", "BatchLbfgs", "Lbfgs", "LbfgsState", "batch_value_and_grad_fn",
           "cuda_graphed", "value_and_grad_fn"]

F = np.float64
_INF = F(np.inf)


def _dot(a: torch.Tensor, b: torch.Tensor) -> np.float64:
    # the products' sum, as :func:`_bdot` sums each lane's (one arithmetic
    # for the scalar and the batched optimizer)
    return F((a.reshape(-1) * b.reshape(-1)).sum().item())


def _max(a, b):
    """``jnp.maximum``: NaN wins."""
    return F(np.maximum(F(a), F(b)))


def _min(a, b):
    return F(np.minimum(F(a), F(b)))


def cuda_graphed(fn: Callable) -> Callable:
    """``fn`` (a CUDA tensor ``z`` to a tuple of tensors, with no host read
    of a device value) replayed from a CUDA graph. The first call runs
    ``fn`` eagerly on a side stream (the warm-up that capture wants) and
    returns its result; the second captures one call into a graph whose
    input buffer takes every later argument, so that each call after it
    costs one replay instead of the operations' host dispatch. The results
    are copies. A failed capture raises, and so does an argument of another
    shape than the captured one."""
    state = {}

    def run(z: torch.Tensor):
        if "graph" not in state:
            if not state.get("warm"):
                side = torch.cuda.Stream(device=z.device)
                side.wait_stream(torch.cuda.current_stream(z.device))
                with torch.cuda.stream(side):
                    out = fn(z)
                torch.cuda.current_stream(z.device).wait_stream(side)
                state["warm"] = True
                return out
            state["z"] = z.detach().clone()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                state["out"] = fn(state["z"])
            state["graph"] = graph
        if z.shape != state["z"].shape:
            raise ValueError(f"cuda_graphed: captured for {tuple(state['z'].shape)}, "
                             f"called with {tuple(z.shape)}")
        state["z"].copy_(z)
        state["graph"].replay()
        return tuple(o.clone() for o in state["out"])

    return run


def value_and_grad_fn(fn: Callable, graph: bool = False) -> Callable:
    """``z -> (value, grad)`` of a scalar torch function by
    ``torch.autograd`` (the value as float64, the gradient detached);
    ``graph`` replays it from a CUDA graph on a CUDA tensor
    (:func:`cuda_graphed`: ``fn`` must not read a device value on the
    host)."""

    def tensors(z: torch.Tensor):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            v = fn(zz)
            (g,) = torch.autograd.grad(v, zz)
        return v.detach(), g.detach()

    run = cuda_graphed(tensors) if graph else tensors

    def vg(z: torch.Tensor):
        v, g = run(z)
        return F(v.item()), g

    return vg


class LbfgsState(NamedTuple):
    count: int
    params: torch.Tensor          # the previous iterate
    updates: torch.Tensor         # the previous gradient
    diff_params: torch.Tensor     # [memory, n]
    diff_updates: torch.Tensor    # [memory, n]
    weights: np.ndarray           # [memory] 1 / (s'y)
    learning_rate: np.float64     # the last accepted step
    value: np.float64             # value at the current iterate (inf: unknown)
    grad: torch.Tensor            # gradient at the current iterate
    linesearch_steps: int = 0


class _Zoom(NamedTuple):
    count: int
    stepsize: np.float64
    value: np.float64
    grad: torch.Tensor
    slope: np.float64
    value_init: np.float64
    slope_init: np.float64
    decrease_error: np.float64
    curvature_error: np.float64
    interval_found: bool
    done: bool
    failed: bool
    low: np.float64
    value_low: np.float64
    slope_low: np.float64
    high: np.float64
    value_high: np.float64
    slope_high: np.float64
    cubic_ref: np.float64
    value_cubic_ref: np.float64
    safe_stepsize: np.float64
    safe_value: np.float64
    safe_grad: torch.Tensor


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    with np.errstate(all="ignore"):
        # integer powers as products, as jnp's integer_pow expands them
        C = fpa
        db = b - a
        dc = c - a
        dbdc = db * dc
        denom = dbdc * dbdc * (db - dc)
        d1 = np.array([[dc * dc, -(db * db)], [-(dc * dc * dc), db * db * db]], dtype=F)
        A, B = np.dot(d1, np.array([fb - fa - C * db, fc - fa - C * dc], dtype=F)) / denom
        radical = B * B - 3.0 * A * C
        return F(a + (-B + np.sqrt(radical)) / (3.0 * A))


def _quadmin(a, fa, fpa, b, fb):
    with np.errstate(all="ignore"):
        D = fa
        C = fpa
        db = b - a
        B = (fb - D - C * db) / (db * db)
        return F(a - C / (2.0 * B))


# optax 0.2.6's lbfgs() defaults: memory, zoom line search (its
# scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy="one") with the default constants)
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = F(1e-4)       # sufficient decrease, c1
CURV_RTOL = F(0.9)         # curvature, c2
APPROX_DEC_RTOL = F(1e-6)  # the approximate-Wolfe decrease
INCREASE_FACTOR = F(2.0)   # the step's growth while no bracket is found
INTERVAL_THRESHOLD = F(1e-5)
TOL = F(0.0)


class Lbfgs:
    """``optax.lbfgs()`` on a flat float64 parameter tensor: ``state =
    opt.init(z)``, then per iteration ``value, grad =
    opt.value_and_grad_from_state(vg, z, state)``, ``z, state =
    opt.step(vg, z, state, value, grad)``."""

    # -- state ----------------------------------------------------------------
    def init(self, params: torch.Tensor) -> LbfgsState:
        m = MEMORY_SIZE
        zeros = torch.zeros((m,) + params.shape, dtype=params.dtype, device=params.device)
        return LbfgsState(count=0, params=torch.zeros_like(params),
                          updates=torch.zeros_like(params), diff_params=zeros,
                          diff_updates=zeros.clone(), weights=np.zeros(m, dtype=F),
                          learning_rate=F(1.0), value=_INF, grad=torch.zeros_like(params))

    @staticmethod
    def value_and_grad_from_state(vg: Callable, params: torch.Tensor,
                                  state: LbfgsState) -> Tuple[np.float64, torch.Tensor]:
        """The value and gradient the line search left in the state, or a
        fresh evaluation when they are not finite (the first iteration)."""
        if np.isfinite(state.value):
            return state.value, state.grad
        return vg(params)

    # -- one iteration -----------------------------------------------------------
    def step(self, vg: Callable, params: torch.Tensor, state: LbfgsState, value,
             grad: torch.Tensor) -> Tuple[torch.Tensor, LbfgsState]:
        """The next iterate and state: the L-BFGS direction, the zoom line
        search along it, ``params + stepsize * direction``."""
        m = MEMORY_SIZE
        count = state.count
        memory_idx = count % m
        prev_idx = (count - 1) % m
        diff_params = params - state.params
        diff_updates = grad - state.updates
        vdot = _dot(diff_updates, diff_params)
        with np.errstate(divide="ignore"):
            weight = F(0.0) if vdot == 0.0 else F(1.0) / vdot
        if count == 0:
            diff_params = torch.zeros_like(diff_params)
            diff_updates = torch.zeros_like(diff_updates)
            weight = F(0.0)
        dp_mem = state.diff_params.clone()
        du_mem = state.diff_updates.clone()
        w_mem = state.weights.copy()
        dp_mem[prev_idx] = diff_params
        du_mem[prev_idx] = diff_updates
        w_mem[prev_idx] = weight

        if count > 0:
            num = _dot(diff_updates, diff_params)
            den = _dot(diff_updates, diff_updates)
            scale = num / den if den > 0.0 else F(1.0)
        else:
            with np.errstate(divide="ignore"):
                scale = _min(F(1.0), F(1.0) / F(torch.linalg.vector_norm(grad).item()))
        direction = -self._precondition(grad, dp_mem, du_mem, w_mem, scale, memory_idx)

        ls = self._linesearch(vg, params, direction, F(value), grad)
        new_params = params + float(ls.stepsize) * direction
        new_state = LbfgsState(count=count + 1, params=params, updates=grad,
                               diff_params=dp_mem, diff_updates=du_mem, weights=w_mem,
                               learning_rate=ls.stepsize, value=ls.value, grad=ls.grad,
                               linesearch_steps=ls.count)
        return new_params, new_state

    @staticmethod
    def _precondition(g, dp_mem, du_mem, rhos, scale, memory_idx):
        m = rhos.shape[0]
        indices = [(memory_idx + i) % m for i in range(m)]
        vec = g
        alphas = {}
        for idx in reversed(indices):
            alpha = rhos[idx] * _dot(dp_mem[idx], vec)
            vec = vec + float(-alpha) * du_mem[idx]
            alphas[idx] = alpha
        vec = float(scale) * vec
        for idx in indices:
            beta = rhos[idx] * _dot(du_mem[idx], vec)
            vec = vec + float(alphas[idx] - beta) * dp_mem[idx]
        return vec

    # -- the zoom line search ------------------------------------------------------
    def _errors(self, stepsize, value_step, slope_step, value_init, slope_init):
        with np.errstate(all="ignore"):
            dec = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
            approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
            delta_values = value_step - value_init - APPROX_DEC_RTOL * np.abs(value_init)
            approx = _max(approx, delta_values)
            dec = _max(_min(approx, dec), F(0.0))
            dec = _INF if np.isnan(dec) else dec
            curv = _max(np.abs(slope_step) - CURV_RTOL * np.abs(slope_init), F(0.0))
            curv = _INF if np.isnan(curv) else curv
        return F(dec), F(curv)

    def _on_line(self, vg, params, stepsize, updates):
        value, grad = vg(params + float(stepsize) * updates)
        return F(value), grad, _dot(grad, updates)

    def _linesearch(self, vg, params, updates, value, grad) -> _Zoom:
        slope = _dot(updates, grad)
        s = _Zoom(count=0, stepsize=F(0.0), value=value, grad=grad, slope=slope,
                  value_init=value, slope_init=slope, decrease_error=_INF,
                  curvature_error=_INF, interval_found=False, done=False, failed=False,
                  low=F(0.0), value_low=value, slope_low=slope, high=F(0.0),
                  value_high=value, slope_high=slope, cubic_ref=F(0.0),
                  value_cubic_ref=value, safe_stepsize=F(0.0), safe_value=value,
                  safe_grad=grad)
        while not (s.done or s.failed):
            if s.interval_found:
                s = self._zoom(vg, params, updates, s)
            else:
                s = self._search(vg, params, updates, s)
            if s.failed:
                s = self._safe_step(s)
        return s

    @staticmethod
    def _safe_step(s: _Zoom) -> _Zoom:
        outside_domain = np.isinf(s.decrease_error)
        if s.safe_stepsize > 0.0 or outside_domain:
            return s._replace(stepsize=s.safe_stepsize, value=s.safe_value, grad=s.safe_grad)
        return s

    def _search(self, vg, params, updates, s: _Zoom) -> _Zoom:
        new_stepsize = F(1.0) if s.count == 0 else INCREASE_FACTOR * s.stepsize
        value, grad, slope = self._on_line(vg, params, new_stepsize, updates)
        dec, curv = self._errors(new_stepsize, value, slope, s.value_init, s.slope_init)
        new_error = _max(dec, curv)
        safe = dec <= TOL
        safe_stepsize, safe_value, safe_grad = ((new_stepsize, value, grad) if safe
                                                else (s.safe_stepsize, s.safe_value, s.safe_grad))
        set_high = (dec > 0.0) or ((value >= s.value) and s.count > 0)
        set_low = (slope >= 0.0) and not set_high
        if set_low:
            low, value_low, slope_low = new_stepsize, value, slope
            high, value_high, slope_high = s.stepsize, s.value, s.slope
        else:
            low, value_low, slope_low = s.stepsize, s.value, s.slope
            high, value_high, slope_high = new_stepsize, value, slope
        interval_found = set_high or set_low or bool(new_error <= TOL)
        done = bool(new_error <= TOL)
        failed = (s.count + 1 >= MAX_LINESEARCH_STEPS) and not done
        return s._replace(count=s.count + 1, stepsize=new_stepsize, value=value, grad=grad,
                          slope=slope, decrease_error=dec, curvature_error=curv,
                          interval_found=interval_found, done=done, failed=failed,
                          low=low, value_low=value_low, slope_low=slope_low, high=high,
                          value_high=value_high, slope_high=slope_high, cubic_ref=low,
                          value_cubic_ref=value_low, safe_stepsize=safe_stepsize,
                          safe_value=safe_value, safe_grad=safe_grad)

    def _zoom(self, vg, params, updates, s: _Zoom) -> _Zoom:
        low, high = s.low, s.high
        delta = F(np.abs(high - low))
        left, right = _min(high, low), _max(high, low)
        cubic_chk, quad_chk = F(0.2) * delta, F(0.1) * delta
        too_small_int = delta <= INTERVAL_THRESHOLD
        middle_cubic = _cubicmin(low, s.value_low, s.slope_low, high, s.value_high,
                                 s.cubic_ref, s.value_cubic_ref)
        use_cubic = (middle_cubic > left + cubic_chk) and (middle_cubic < right - cubic_chk)
        middle_quad = _quadmin(low, s.value_low, s.slope_low, high, s.value_high)
        use_quad = (not use_cubic) and ((middle_quad > left + quad_chk)
                                        and (middle_quad < right - quad_chk))
        if use_cubic:
            middle = middle_cubic
        elif use_quad:
            middle = middle_quad
        else:
            middle = (low + high) / F(2.0)
        value, grad, slope = self._on_line(vg, params, middle, updates)
        dec, curv = self._errors(middle, value, slope, s.value_init, s.slope_init)
        new_error = _max(dec, curv)
        safe = dec <= TOL
        if safe and value < s.safe_value:
            safe_stepsize, safe_value, safe_grad = middle, value, grad
        else:
            safe_stepsize, safe_value, safe_grad = s.safe_stepsize, s.safe_value, s.safe_grad
        done = bool(new_error <= TOL)
        set_high_to_middle = (dec > 0.0) or (value >= s.value_low)
        set_high_to_low = (slope * (high - low) >= 0.0) and not set_high_to_middle
        set_low_to_middle = not set_high_to_middle
        new_high = ((middle, value, slope) if set_high_to_middle
                    else (high, s.value_high, s.slope_high))
        if set_high_to_low:
            new_high = (low, s.value_low, s.slope_low)
        new_low = ((middle, value, slope) if set_low_to_middle
                   else (low, s.value_low, s.slope_low))
        if set_high_to_middle or set_high_to_low:
            cubic_ref, value_cubic_ref = high, s.value_high
        else:
            cubic_ref, value_cubic_ref = low, s.value_low
        max_iter_reached = s.count + 1 >= MAX_LINESEARCH_STEPS
        failed = (max_iter_reached or (too_small_int and safe_stepsize > 0.0)) and not done
        return s._replace(count=s.count + 1, stepsize=middle, value=value, grad=grad,
                          slope=slope, decrease_error=dec, curvature_error=curv,
                          done=done, failed=failed, low=new_low[0], value_low=new_low[1],
                          slope_low=new_low[2], high=new_high[0], value_high=new_high[1],
                          slope_high=new_high[2], cubic_ref=cubic_ref,
                          value_cubic_ref=value_cubic_ref, safe_stepsize=safe_stepsize,
                          safe_value=safe_value, safe_grad=safe_grad)


# -- B independent lanes -----------------------------------------------------------


def batch_value_and_grad_fn(fn: Callable, graph: bool = False) -> Callable:
    """``Z [B, n] -> (values [B] float64, gradients [B, n])`` of a torch
    function that maps ``B`` parameter rows to ``B`` independent values:
    the lanes share no operation that mixes them, so the gradient of the
    sum is the stack of the lanes' gradients (a NaN in one lane stays in
    its own row). ``graph``: as in :func:`value_and_grad_fn`."""

    def vg(z: torch.Tensor):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            v = fn(zz)
            (g,) = torch.autograd.grad(v.sum(), zz)
        return v.detach().to(torch.float64), g.detach()

    return cuda_graphed(vg) if graph else vg


class BatchLbfgsState(NamedTuple):
    count: int
    params: torch.Tensor          # [B, n] the previous iterates
    updates: torch.Tensor         # [B, n] the previous gradients
    diff_params: torch.Tensor     # [B, memory, n]
    diff_updates: torch.Tensor    # [B, memory, n]
    weights: torch.Tensor         # [B, memory] float64
    learning_rate: torch.Tensor   # [B] float64
    value: torch.Tensor           # [B] float64 (inf: unknown)
    grad: torch.Tensor            # [B, n]
    linesearch_steps: torch.Tensor  # [B] int64


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane dot products [B] in float64."""
    return (a * b).sum(dim=-1).to(torch.float64)


def _bcubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    dbdc = db * dc
    denom = dbdc * dbdc * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * dc * dc)) * v0 + db * db * db * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _bquadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


class BatchLbfgs:
    """:class:`Lbfgs` over ``B`` independent lanes at once, with the semantics
    of ``jax.vmap`` over optax's loop: every lane takes optax's iterates for
    its own objective (lane k's equal those of :class:`Lbfgs` run alone on
    lane k), a lane whose line search has ended keeps its state while the
    others search on, and a NaN or an infinity in one lane changes no other.

    The lane state lives in ``[B]`` / ``[B, n]`` / ``[B, memory, n]`` tensors
    on the parameters' device, the line search's scalars in float64; the
    host reads one flag per line-search round (whether any lane still
    searches). ``vg`` maps ``Z [B, n]`` to ``(values [B], gradients [B, n])``
    (:func:`batch_value_and_grad_fn`) and is called on every lane each round;
    a lane that has stopped searching is evaluated at its current iterate
    and its result discarded."""

    def init(self, params: torch.Tensor) -> BatchLbfgsState:
        B, n = params.shape
        m = MEMORY_SIZE
        f64 = dict(dtype=torch.float64, device=params.device)
        zeros = torch.zeros((B, m, n), dtype=params.dtype, device=params.device)
        return BatchLbfgsState(
            count=0, params=torch.zeros_like(params), updates=torch.zeros_like(params),
            diff_params=zeros, diff_updates=zeros.clone(), weights=torch.zeros((B, m), **f64),
            learning_rate=torch.ones((B,), **f64), value=torch.full((B,), np.inf, **f64),
            grad=torch.zeros_like(params),
            linesearch_steps=torch.zeros((B,), dtype=torch.int64, device=params.device))

    @staticmethod
    def value_and_grad_from_state(vg: Callable, params: torch.Tensor,
                                  state: BatchLbfgsState):
        """Each lane's value and gradient from the state where finite, a
        fresh evaluation where not (the first iteration, or after a failed
        line search)."""
        need = ~torch.isfinite(state.value)
        if not bool(need.any()):
            return state.value, state.grad
        v, g = vg(params)
        return (torch.where(need, v, state.value),
                torch.where(need[:, None], g, state.grad))

    def step(self, vg: Callable, params: torch.Tensor, state: BatchLbfgsState, value,
             grad: torch.Tensor):
        """Every lane's next iterate and the new state: :meth:`Lbfgs.step`
        lane by lane."""
        m = MEMORY_SIZE
        count = state.count
        memory_idx = count % m
        prev_idx = (count - 1) % m
        diff_params = params - state.params
        diff_updates = grad - state.updates
        vdot = _bdot(diff_updates, diff_params)
        weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
        if count == 0:
            diff_params = torch.zeros_like(diff_params)
            diff_updates = torch.zeros_like(diff_updates)
            weight = torch.zeros_like(weight)
        dp_mem = state.diff_params.clone()
        du_mem = state.diff_updates.clone()
        w_mem = state.weights.clone()
        dp_mem[:, prev_idx] = diff_params
        du_mem[:, prev_idx] = diff_updates
        w_mem[:, prev_idx] = weight
        if count > 0:
            num = _bdot(diff_updates, diff_params)
            den = _bdot(diff_updates, diff_updates)
            scale = torch.where(den > 0.0, num / den, torch.ones_like(den))
        else:
            norm = torch.linalg.vector_norm(grad, dim=-1).to(torch.float64)
            scale = torch.minimum(torch.ones_like(norm), 1.0 / norm)
        direction = -self._precondition(grad, dp_mem, du_mem, w_mem, scale, memory_idx)
        ls = self._linesearch(vg, params, direction, value.to(torch.float64), grad)
        new_params = params + ls["stepsize"].to(params.dtype)[:, None] * direction
        new_state = BatchLbfgsState(
            count=count + 1, params=params, updates=grad, diff_params=dp_mem,
            diff_updates=du_mem, weights=w_mem, learning_rate=ls["stepsize"],
            value=ls["value"], grad=ls["grad"], linesearch_steps=ls["count"])
        return new_params, new_state

    @staticmethod
    def _precondition(g, dp_mem, du_mem, rhos, scale, memory_idx):
        m = rhos.shape[1]
        indices = [(memory_idx + i) % m for i in range(m)]
        dt = g.dtype
        vec = g
        alphas = {}
        for idx in reversed(indices):
            alpha = rhos[:, idx] * _bdot(dp_mem[:, idx], vec)
            vec = vec + (-alpha).to(dt)[:, None] * du_mem[:, idx]
            alphas[idx] = alpha
        vec = scale.to(dt)[:, None] * vec
        for idx in indices:
            beta = rhos[:, idx] * _bdot(du_mem[:, idx], vec)
            vec = vec + (alphas[idx] - beta).to(dt)[:, None] * dp_mem[:, idx]
        return vec

    # -- the zoom line search, lane by lane ------------------------------------------
    @staticmethod
    def _errors(stepsize, value_step, slope_step, value_init, slope_init):
        zero = torch.zeros_like(stepsize)
        dec = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta_values = value_step - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
        approx = torch.maximum(approx, delta_values)
        dec = torch.maximum(torch.minimum(approx, dec), zero)
        dec = torch.where(torch.isnan(dec), torch.full_like(dec, np.inf), dec)
        curv = torch.maximum(torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init), zero)
        curv = torch.where(torch.isnan(curv), torch.full_like(curv, np.inf), curv)
        return dec, curv

    def _linesearch(self, vg, params, updates, value, grad) -> dict:
        slope = _bdot(updates, grad)
        zero = torch.zeros_like(value)
        inf = torch.full_like(value, np.inf)
        false = torch.zeros(value.shape, dtype=torch.bool, device=value.device)
        s = dict(count=torch.zeros(value.shape, dtype=torch.int64, device=value.device),
                 stepsize=zero, value=value, grad=grad, slope=slope, value_init=value,
                 slope_init=slope, decrease_error=inf, curvature_error=inf,
                 interval_found=false, done=false, failed=false, low=zero, value_low=value,
                 slope_low=slope, high=zero, value_high=value, slope_high=slope,
                 cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero, safe_value=value,
                 safe_grad=grad)
        while True:
            active = ~(s["done"] | s["failed"])
            if not bool(active.any()):
                return s
            s = self._round(vg, params, updates, s, active)

    def _round(self, vg, params, updates, s: dict, active: torch.Tensor) -> dict:
        """One round: each active lane takes its search or zoom step (one
        evaluation at its trial step), then its safe step if it failed."""
        low, high = s["low"], s["high"]
        # the zoom's trial point
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
        too_small_int = delta <= INTERVAL_THRESHOLD
        middle_cubic = _bcubicmin(low, s["value_low"], s["slope_low"], high, s["value_high"],
                                  s["cubic_ref"], s["value_cubic_ref"])
        use_cubic = (middle_cubic > left + cubic_chk) & (middle_cubic < right - cubic_chk)
        middle_quad = _bquadmin(low, s["value_low"], s["slope_low"], high, s["value_high"])
        use_quad = (~use_cubic) & ((middle_quad > left + quad_chk)
                                   & (middle_quad < right - quad_chk))
        middle = torch.where(use_cubic, middle_cubic,
                             torch.where(use_quad, middle_quad, (low + high) / 2.0))
        # the search's trial point
        new_stepsize = torch.where(s["count"] == 0, torch.ones_like(low),
                                   INCREASE_FACTOR * s["stepsize"])
        zoom = s["interval_found"]
        trial = torch.where(zoom, middle, new_stepsize)
        # a lane that has stopped is evaluated where it stands
        trial = torch.where(active, trial, torch.zeros_like(trial))
        v, g = vg(params + trial.to(params.dtype)[:, None] * updates)
        slope = _bdot(g, updates)
        dec, curv = self._errors(trial, v, slope, s["value_init"], s["slope_init"])
        new_error = torch.maximum(dec, curv)
        safe = dec <= TOL
        done = new_error <= TOL
        count1 = s["count"] + 1
        max_iter_reached = count1 >= MAX_LINESEARCH_STEPS

        def pick(cond, a, b):
            return torch.where(cond[:, None] if a.dim() == 2 else cond, a, b)

        # search branch
        s_safe = safe
        set_high = (dec > 0.0) | ((v >= s["value"]) & (s["count"] > 0))
        set_low = (slope >= 0.0) & ~set_high
        srch = dict(
            low=torch.where(set_low, trial, s["stepsize"]),
            value_low=torch.where(set_low, v, s["value"]),
            slope_low=torch.where(set_low, slope, s["slope"]),
            high=torch.where(set_low, s["stepsize"], trial),
            value_high=torch.where(set_low, s["value"], v),
            slope_high=torch.where(set_low, s["slope"], slope),
            interval_found=set_high | set_low | done,
            failed=max_iter_reached & ~done,
            safe_stepsize=torch.where(s_safe, trial, s["safe_stepsize"]),
            safe_value=torch.where(s_safe, v, s["safe_value"]),
            safe_grad=pick(s_safe, g, s["safe_grad"]))
        srch["cubic_ref"], srch["value_cubic_ref"] = srch["low"], srch["value_low"]
        # zoom branch
        z_safe = safe & (v < s["safe_value"])
        safe_stepsize = torch.where(z_safe, trial, s["safe_stepsize"])
        set_high_to_middle = (dec > 0.0) | (v >= s["value_low"])
        set_high_to_low = ((slope * (high - low)) >= 0.0) & ~set_high_to_middle
        set_low_to_middle = ~set_high_to_middle
        nh = (torch.where(set_high_to_middle, trial, high),
              torch.where(set_high_to_middle, v, s["value_high"]),
              torch.where(set_high_to_middle, slope, s["slope_high"]))
        nh = (torch.where(set_high_to_low, low, nh[0]),
              torch.where(set_high_to_low, s["value_low"], nh[1]),
              torch.where(set_high_to_low, s["slope_low"], nh[2]))
        moved_high = set_high_to_middle | set_high_to_low
        zm = dict(
            low=torch.where(set_low_to_middle, trial, low),
            value_low=torch.where(set_low_to_middle, v, s["value_low"]),
            slope_low=torch.where(set_low_to_middle, slope, s["slope_low"]),
            high=nh[0], value_high=nh[1], slope_high=nh[2],
            interval_found=s["interval_found"],
            failed=(max_iter_reached | (too_small_int & (safe_stepsize > 0.0))) & ~done,
            cubic_ref=torch.where(moved_high, high, low),
            value_cubic_ref=torch.where(moved_high, s["value_high"], s["value_low"]),
            safe_stepsize=safe_stepsize,
            safe_value=torch.where(z_safe, v, s["safe_value"]),
            safe_grad=pick(z_safe, g, s["safe_grad"]))
        new = dict(count=count1, stepsize=trial, value=v, grad=g, slope=slope,
                   decrease_error=dec, curvature_error=curv, done=done,
                   value_init=s["value_init"], slope_init=s["slope_init"])
        for k in srch:
            new[k] = pick(zoom, zm[k], srch[k])
        # the safe step of a lane that failed
        fell = new["failed"] & ((new["safe_stepsize"] > 0.0)
                                | torch.isinf(new["decrease_error"]))
        new["stepsize"] = torch.where(fell, new["safe_stepsize"], new["stepsize"])
        new["value"] = torch.where(fell, new["safe_value"], new["value"])
        new["grad"] = pick(fell, new["safe_grad"], new["grad"])
        # only the lanes still searching move
        return {k: pick(active, new[k], s[k]) for k in s}
