"""NPML simplex weight solve: device burn-in + active-set Newton.

The counterpart of the JAX package's ``optimize/weights.py``. The convex inner
subproblem of the NPAG cycle (optimize/npag.py) is

    maximize_{lam in simplex}  sum_i log( (psi @ lam)_i )

whose optimum satisfies Lindsay's gradient condition D_j = sum_i
psi_ij / (psi lam)_i = n on the support and <= n elsewhere. The solve has
three phases:

1. **Burn-in**: the bulk of the multiplicative ascent. With a CUDA tensor
   and enough cells (:data:`_DEVICE_MIN_CELLS`) it runs in float32 on the
   card (:func:`_burnin_device`: two matrix-vector products per iteration,
   plain torch ops as the JAX package left them to XLA), stopping at the
   float32 resolution floor. Otherwise it runs on the host in float64 with
   progressive column pruning (:func:`_burnin_host`).
2. **Active-set Newton** on the host in float64 (:func:`_newton_active`):
   NPML optima are sparse, so the reduced problem over the surviving columns
   is solved by a damped Newton method on g(lam) = sum_i log((psi lam)_i) -
   n * sum_j lam_j, the Lagrangian with the known simplex multiplier n.
3. **KKT outer loop**: the exact float64 full-matrix check of D_j <= n over
   the excluded columns; violators re-enter and Newton resumes. The final
   point therefore satisfies the same optimality condition as the plain
   fixed point whatever the burn-in's precision or pruning thresholds.

Phases 2 and 3 and the host burn-in are the JAX package's numpy code line for
line: they are the float64 tail and the oracle of the tests. The JAX
package's padded (bucketed) column count and its mask exist to reuse one
compiled program across adaptive-grid cycles; PyTorch compiles nothing per
shape, so the device burn-in here takes the matrix at its own width.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import PharmsolError
from ..utils.profiling import stage

__all__ = ["solve_weights", "solve_weights_plain"]


def solve_weights_plain(psi: np.ndarray, max_iters: int = 4000,
                        tol: float = 1e-10):
    """Plain multiplicative fixed point (reference implementation).

    Kept as the oracle for :func:`solve_weights` parity tests, as in the
    JAX package.
    """
    n, k = psi.shape
    lam = np.full(k, 1.0 / k)
    last = -np.inf
    for _ in range(max_iters):
        pyl = np.maximum(psi @ lam, 1e-300)
        ll = float(np.sum(np.log(pyl)))
        lam = lam * (psi.T @ (1.0 / pyl)) / n
        s = lam.sum()
        if not np.isfinite(s) or s <= 0:
            raise PharmsolError("NPML weight iteration diverged")
        lam /= s
        if ll - last < tol * max(1.0, abs(ll)):
            break
        last = ll
    pyl = np.maximum(psi @ lam, 1e-300)
    return lam, pyl, float(np.sum(np.log(pyl)))


# ----------------------------------------------------------------------
# Phase A: burn-in


_BURNIN_MAX_ITERS = 3000
# relative ll-progress floor for the f32 device phase: ~f32 pairwise-sum
# noise on a 1e4-subject log-lik; the exact f64 tail runs on the host
_BURNIN_TOL_F32 = 3e-7
# the device loop reads its stop flag back once per this many iterations
_BURNIN_CHECK_EVERY = 32


def _burnin_device_loop(psi: torch.Tensor, check_every: int = _BURNIN_CHECK_EVERY):
    """The float32 multiplicative burn-in on ``psi``'s device: ``(lam,
    iterations)`` as device tensors.

    The JAX package's ``lax.while_loop`` (stop after the iteration that
    brings the streak of small log-likelihood gains to 3, or at
    ``_BURNIN_MAX_ITERS``) keeps its stopping test on the device. Here the
    carry (lam, last, streak, iterations) stays on the device too and every
    update is masked by ``streak < 3``: iterations past the stop change
    nothing, so the flag is read back only every ``check_every`` iterations
    and the returned ``lam`` is the one the rule stops at whatever
    ``check_every`` is.
    """
    n, k = psi.shape
    dev = psi.device
    psi_t = psi.t()
    lam = torch.full((k,), 1.0 / k, dtype=torch.float32, device=dev)
    last = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    streak = torch.zeros((), dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    floor = torch.tensor(1e-30, dtype=torch.float32, device=dev)
    inv_n = 1.0 / n
    for i in range(_BURNIN_MAX_ITERS):
        live = streak < 3
        pyl = torch.maximum(psi @ lam, floor)
        ll = torch.sum(torch.log(pyl))
        new = lam * (psi_t @ (1.0 / pyl)) * inv_n
        new = new / torch.sum(new)
        small = (ll - last) < _BURNIN_TOL_F32 * torch.abs(ll)
        lam = torch.where(live, new, lam)
        last = torch.where(live, ll, last)
        streak = torch.where(live, torch.where(small, streak + one, streak * 0), streak)
        iters = iters + live.to(torch.int32)
        if (i + 1) % check_every == 0 and int(streak) >= 3:
            break
    return lam, iters


def _burnin_device(psi_f32: torch.Tensor, check_every: int = _BURNIN_CHECK_EVERY) -> np.ndarray:
    """Run the float32 multiplicative burn-in where ``psi_f32`` [n, k] lies
    (the card on the fit's path; a CPU tensor in the tests). Returns the host
    float64 lam, renormalized; only that vector crosses to the host."""
    psi = psi_f32.to(torch.float32)
    k = psi.shape[1]
    lam_dev, _ = _burnin_device_loop(psi, check_every)
    lam = lam_dev.detach().cpu().numpy().astype(np.float64)
    lam = np.maximum(lam, 0.0)
    s = lam.sum()
    if not np.isfinite(s) or s <= 0:
        # degenerate f32 collapse: fall back to uniform, Newton recovers
        return np.full(k, 1.0 / k)
    return lam / s


def _burnin_host(psi: np.ndarray, target_active: int = 256,
                 max_iters: int = 1536, chunk: int = 128,
                 prune_tol: float = 1e-13):
    """Host multiplicative burn-in with progressive column pruning.

    Returns full-width lam (pruned columns exactly 0).  Pruned columns
    can only re-enter through the caller's exact KKT check, which makes
    the prune threshold a speed knob, not a correctness one.
    """
    n, k = psi.shape
    active = np.arange(k)
    psi_a = psi
    lam_a = np.full(k, 1.0 / k)
    last = -np.inf
    done = 0
    while done < max_iters:
        for _ in range(chunk):
            pyl = np.maximum(psi_a @ lam_a, 1e-300)
            lam_a = lam_a * (psi_a.T @ (1.0 / pyl)) / n
            s = lam_a.sum()
            if not np.isfinite(s) or s <= 0:
                raise PharmsolError("NPML weight iteration diverged")
            lam_a /= s
        done += chunk
        ll = float(np.sum(np.log(np.maximum(psi_a @ lam_a, 1e-300))))
        keep = lam_a > prune_tol
        if keep.sum() < lam_a.size:
            active = active[keep]
            lam_a = lam_a[keep]
            lam_a /= lam_a.sum()
            psi_a = psi_a[:, keep]
        if active.size <= target_active and ll - last < 1e-9 * max(
                1.0, abs(ll)):
            break
        last = ll
    lam = np.zeros(k)
    lam[active] = lam_a
    return lam


# ----------------------------------------------------------------------
# Phase B: active-set damped Newton on g(lam) = sum log(psi lam) - n sum lam


def _g_value(psi_a: np.ndarray, lam: np.ndarray, n: int) -> float:
    pyl = psi_a @ lam
    if np.any(pyl <= 0):
        return -np.inf
    return float(np.sum(np.log(pyl)) - n * np.sum(lam))


def _newton_active(psi_a: np.ndarray, lam: np.ndarray, n: int,
                   tol: float = 1e-11, max_newton: int = 80,
                   polish_iters: int = 4000, polish_tol: float = 1e-10):
    """Bound-constrained Newton ascent of g over lam >= 0 (columns of
    ``psi_a`` are the current working set).  Modifies nothing; returns
    the improved lam.  Falls back to multiplicative steps whenever a
    Newton step fails to improve g — the iteration is therefore never
    worse than the plain fixed point on the reduced problem.
    """
    k = psi_a.shape[1]
    lam = np.maximum(np.asarray(lam, dtype=np.float64), 0.0)
    if lam.sum() <= 0:
        lam = np.full(k, 1.0 / k)
    g_cur = _g_value(psi_a, lam, n)
    if not np.isfinite(g_cur):
        lam = np.full(k, 1.0 / k)
        g_cur = _g_value(psi_a, lam, n)
    for _ in range(max_newton):
        pyl = np.maximum(psi_a @ lam, 1e-300)
        r = 1.0 / pyl
        grad = psi_a.T @ r - n
        # working set: meaningful weights plus zero-weight columns whose
        # gradient wants them back in.  Near-dead weights (decayed to
        # ~1e-20 during burn-in) are NOT special-cased: the step below
        # PROJECTS onto lam >= 0 instead of capping the step length at
        # the first boundary, so they clamp to exactly 0 in one step
        # rather than shrinking every step length to their scale.
        act = (lam > 0) | (grad > n * 1e-10)
        if not np.any(act):
            break
        free = act & (lam > 0)
        if (np.max(np.abs(grad[free]), initial=0.0) <= n * tol
                and np.all(grad[~free] <= n * max(tol, 1e-10))):
            break
        g_act = grad[act]
        A = psi_a[:, act]
        W = A * r[:, None]
        H = W.T @ W  # -Hessian of g on the working set (PSD)
        # Near-duplicate support columns (adaptive-grid candidates a
        # merge_tol apart) make H badly rank-deficient (cond ~1e16): a
        # damped solve fills the step with near-null components that
        # barely move pyl, so the line search crawls.  Solve in the
        # TRUNCATED eigenspace instead (discard w < 1e-12 w_max — those
        # directions change the likelihood negligibly), and cap the
        # step by a fraction-to-boundary rule in pyl space so the log
        # terms never blow up; lam itself projects onto >= 0.
        try:
            w_eig, V = np.linalg.eigh(H)
        except np.linalg.LinAlgError:
            break
        w_max = max(float(w_eig[-1]), 1e-300)
        keepdir = w_eig > 1e-12 * w_max
        Vk = V[:, keepdir]
        gVk = Vk.T @ g_act
        d = Vk @ (gVk / w_eig[keepdir])
        dpyl = A @ d
        shrink = dpyl < 0
        alpha0 = 1.0
        if np.any(shrink):
            alpha0 = min(1.0, 0.95 * float(
                np.min(pyl[shrink] / -dpyl[shrink])))
        lam_act = lam[act]
        improved = False
        alpha = alpha0
        for _ls in range(40):
            trial = lam.copy()
            trial[act] = np.maximum(lam_act + alpha * d, 0.0)
            g_new = _g_value(psi_a, trial, n)
            if g_new > g_cur:
                lam, g_cur, improved = trial, g_new, True
                break
            alpha *= 0.5
        # Null-space ascent: when H is rank-deficient the gradient can
        # keep a component in null(H), where pyl is (near-)invariant and
        # g is locally LINEAR (slope -n * sum of the direction) — the
        # optimal move is a mass shuffle between degenerate columns all
        # the way to the first lam >= 0 boundary.  The truncated Newton
        # step above cannot see these directions, so take them
        # explicitly; the clamped variable then leaves the working set.
        g_null = g_act - Vk @ gVk
        if np.max(np.abs(g_null), initial=0.0) > n * max(tol, 1e-11):
            v = g_null
            negv = v < -1e-300
            if np.any(negv):
                a_bd = float(np.min(lam_act[negv] / -v[negv]))
                alpha = a_bd
                for _ls in range(40):
                    trial = lam.copy()
                    trial[act] = np.maximum(lam_act + alpha * v, 0.0)
                    g_new = _g_value(psi_a, trial, n)
                    if g_new > g_cur:
                        lam, g_cur, improved = trial, g_new, True
                        lam_act = lam[act]
                        break
                    alpha *= 0.5
        if not improved:
            # multiplicative safeguard BLOCK (monotone in the simplex
            # objective; the renormalization moves along the sum-lam
            # ray, along which g is concave with its maximum exactly at
            # sum lam = 1, so it can only improve g further).  A block,
            # not a single step: one EM step after a failed Newton is
            # usually below f64 resolution of g, while 64 steps move the
            # iterate enough for curvature to change and Newton to
            # re-engage on the next round.
            before = g_cur
            for _em in range(64):
                pyl = np.maximum(psi_a @ lam, 1e-300)
                trial = lam * (psi_a.T @ (1.0 / pyl)) / n
                s = trial.sum()
                if s <= 0 or not np.isfinite(s):
                    break
                lam = trial / s
            g_cur = _g_value(psi_a, lam, n)
            if g_cur - before <= abs(before) * 1e-14:
                break
    # multiplicative polish with the PLAIN solver's stopping rule: from
    # the Newton point this exits in a handful of iterations, and in
    # pathological cases (e.g. near-singular psi where Newton stalls) it
    # degrades to plain-from-warm-start on the reduced matrix — the
    # final point is therefore never meaningfully worse than
    # solve_weights_plain's own stopping point.
    last = -np.inf
    for _ in range(polish_iters):
        pyl = np.maximum(psi_a @ lam, 1e-300)
        ll = float(np.sum(np.log(pyl)))
        lam = lam * (psi_a.T @ (1.0 / pyl)) / n
        s = lam.sum()
        if not np.isfinite(s) or s <= 0:
            raise PharmsolError("NPML weight iteration diverged")
        lam /= s
        if ll - last < polish_tol * max(1.0, abs(ll)):
            break
        last = ll
    s = lam.sum()
    if not np.isfinite(s) or s <= 0:
        raise PharmsolError("NPML weight iteration diverged")
    return lam / s


# ----------------------------------------------------------------------
# Orchestrator


_ACTIVE_TOL = 1e-12      # post-burn-in working-set threshold on lam
_KKT_REL = 1e-9          # D_j <= n * (1 + _KKT_REL) for excluded columns
# Cells (n * k) from which the burn-in runs on the card: the smallest matrix
# at which it was measured, and there the card already wins (10 000 x 4:
# host 13.7 ms, card 6.1 ms; 10 000 x 1000: 939 ms against 34 ms; NVIDIA H100
# 80GB HBM3, 700 W, chip_smoke.py phase 12). The card's loop is bound by
# its ~15 small launches an iteration, about 6 ms whatever the size, so a
# smaller matrix stays on the host, where nothing was measured.
_DEVICE_MIN_CELLS = 40_000


def _device_eligible(n: int, k: int, device) -> bool:
    """The device/host switch of the burn-in: the fit's device is CUDA and
    the matrix has at least :data:`_DEVICE_MIN_CELLS` cells."""
    return torch.device(device).type == "cuda" and n * k >= _DEVICE_MIN_CELLS


def solve_weights(psi: np.ndarray, *, psi_f32: Optional[torch.Tensor] = None,
                  max_iters: int = 4000, tol: float = 1e-10):
    """NPML weights on the simplex for a row-normalized psi matrix.

    Drop-in replacement for :func:`solve_weights_plain` (same return:
    ``(lam, pyl, ll_shiftless)``, same optimum to well under 1e-6 ll)
    structured as burn-in + host active-set Newton + exact KKT
    verification; see the module docstring.

    ``psi``: the host float64 matrix [n, k]. ``psi_f32``: optionally the same
    matrix as a float32 tensor; when it lies on a CUDA device and the matrix
    is large enough (:func:`_device_eligible`) the burn-in runs there.
    """
    psi = np.asarray(psi, dtype=np.float64)
    n, k = psi.shape
    if k == 1:
        pyl = np.maximum(psi[:, 0], 1e-300)
        return np.ones(1), pyl, float(np.sum(np.log(pyl)))

    if psi_f32 is not None and tuple(psi_f32.shape) != (n, k):
        raise ValueError(f"psi_f32 is {tuple(psi_f32.shape)}, psi is {(n, k)}")
    if psi_f32 is not None and _device_eligible(n, k, psi_f32.device):
        with stage("npag/weights_device", psi_f32.device):
            lam = _burnin_device(psi_f32)
    else:
        lam = _burnin_host(psi)

    # Phases B/C on the host in f64
    for _outer in range(12):
        act = lam > _ACTIVE_TOL * max(float(lam.max()), 1e-300)
        if not np.any(act):
            act = np.ones(k, dtype=bool)
        lam_a = _newton_active(psi[:, act], lam[act], n,
                               tol=max(tol, 1e-12),
                               polish_iters=max_iters, polish_tol=tol)
        lam = np.zeros(k)
        lam[act] = lam_a
        pyl = np.maximum(psi @ lam, 1e-300)
        d = psi.T @ (1.0 / pyl)
        viol = (~act) & (d > n * (1.0 + _KKT_REL))
        if not np.any(viol):
            break
        # re-admit violators with enough mass to survive the next
        # working-set threshold, then re-solve
        lam[viol] = 1e-6 / max(1, int(viol.sum()))
        lam /= lam.sum()
    pyl = np.maximum(psi @ lam, 1e-300)
    return lam, pyl, float(np.sum(np.log(pyl)))
