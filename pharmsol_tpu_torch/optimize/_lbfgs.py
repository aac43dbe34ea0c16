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

__all__ = ["MEMORY_SIZE", "Lbfgs", "LbfgsState", "value_and_grad_fn"]

F = np.float64
_INF = F(np.inf)


def _dot(a: torch.Tensor, b: torch.Tensor) -> np.float64:
    return F(torch.dot(a.reshape(-1), b.reshape(-1)).item())


def _max(a, b):
    """``jnp.maximum``: NaN wins."""
    return F(np.maximum(F(a), F(b)))


def _min(a, b):
    return F(np.minimum(F(a), F(b)))


def value_and_grad_fn(fn: Callable) -> Callable:
    """``z -> (value, grad)`` of a scalar torch function by
    ``torch.autograd`` (the value as float64, the gradient detached)."""

    def vg(z: torch.Tensor):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            v = fn(zz)
            (g,) = torch.autograd.grad(v, zz)
        return F(v.detach().item()), g.detach()

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
        C = fpa
        db = b - a
        dc = c - a
        denom = (db * dc) ** 2 * (db - dc)
        d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]], dtype=F)
        A, B = np.dot(d1, np.array([fb - fa - C * db, fc - fa - C * dc], dtype=F)) / denom
        radical = B * B - 3.0 * A * C
        return F(a + (-B + np.sqrt(radical)) / (3.0 * A))


def _quadmin(a, fa, fpa, b, fb):
    with np.errstate(all="ignore"):
        D = fa
        C = fpa
        db = b - a
        B = (fb - D - C * db) / (db ** 2)
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
