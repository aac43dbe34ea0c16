"""Fused psi for ODE models: CUDA kernel wrapper, plain twin, dense output.

The population log-likelihood matrix of an ODE model is, per (row, support)
cell, one adaptive explicit Runge-Kutta march over the row's segments: add
the observation term (read before the dose), apply the row's boluses by the
RHS difference, integrate the segment, and cross observation-only
breakpoints of a merged run with dense output instead of stopping there.

- :func:`psi_ode` is the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/fused_ode.cu``, built at first use with the
  model's generated RHS (:mod:`.rhs_codegen`, :mod:`._build`), or raises; on
  a CPU tensor it runs the plain twin.
- :func:`psi_ode_plain` is that twin: the explicit tier of the JAX package's
  ``ops/pallas_ode.py::psi_ode`` (``integrate``, :708) in plain PyTorch on
  ``[R, S]`` lanes, with a masked loop that ends when every lane is done. It
  calls the user's closure directly. The CPU tests hold it against the JAX
  kernel in interpret mode; ``chip_smoke.py`` holds the CUDA kernel against
  it on the card.

What the march does, as the JAX kernel: the I-controller with growth clamped
to [0.2, 5]; the Hairer-Norsett-Wanner starting step on the first run,
floored at ``h0``; the last controller step carried into the next run; the
stall guard and NaN poisoning of a lane that runs out of steps (-inf cells);
lanes that arrive non-finite stay dead; observations captured from the
tableau's quartic interpolant at ``T_eff = min(T, target - 1e-6 target)``,
zero-offset ones at the run's start. Censored observations use the exact
log of the normal CDF (the TPU kernel's was approximate). Unlike the TPU
kernel there is no padding: R, S and M are free.

Stream layout: ``seg_dt``, the observation streams and ``seg_t0`` are
[R, M]; ``seg_bolus`` is [nb, R, M], one plane per active bolus input
(``bolus_inputs`` names the RHS input of each); ``seg_rateiv`` [nr, R, M]
likewise (``rate_inputs``) or None; support [S, P]; output coefficients
[n_out, n_states, S] and biases [n_out, S] or None. The result is [R, S].
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ..engine.ode import TABLEAUS

LOG_2PI = math.log(2.0 * math.pi)

# Kernel launches through psi_ode on a CUDA tensor (not the twin).
LAUNCHES = 0

# The kernel's solver codes (csrc/fused_ode.cu).
SOLVER_CODES = {"dopri5": 0, "tsit5": 1}

# Dormand-Prince 5(4) dense-output interpolant (Shampine 1986, the quartic of
# scipy's RK45.P):
#   x(t0 + theta*h) = x0 + h * sum_i k_i * theta * (P[i][0] + theta*(P[i][1]
#                     + theta*(P[i][2] + theta*P[i][3])))
_DP_P = (
    (1.0, -8048581381 / 2820520608, 8663915743 / 2820520608,
     -12715105075 / 11282082432),
    (0.0, 0.0, 0.0, 0.0),
    (0.0, 131558114200 / 32700410799, -68118460800 / 10900136933,
     87487479700 / 32700410799),
    (0.0, -1754552775 / 470086768, 14199869525 / 1410260304,
     -10690763975 / 1880347072),
    (0.0, 127303824393 / 49829197408, -318862633887 / 49829197408,
     701980252875 / 199316789632),
    (0.0, -282668133 / 205662961, 2019193451 / 616988883,
     -1453857185 / 822651844),
    (0.0, 40617522 / 29380423, -110615467 / 29380423, 69997945 / 29380423),
)

_DENSE_P = {"dopri5": _DP_P}


def _derive_dense_P(A, B, C):
    """Derive a quartic dense-output interpolant from order conditions.

    Solves for stage-weight polynomials ``b_i(theta) = sum_q P[i][q] *
    theta^(q+1)`` satisfying the eight order-4 continuous-extension
    conditions (Hairer-Norsett-Wanner II.6) plus theta=1 consistency with the
    step weights ``B``, then picks, within the solutions, the member that
    minimizes the order-5 defect sampled over theta. Returns a P-matrix tuple
    like ``_DP_P`` or None when the tableau has no such interpolant.
    """
    ns = len(C)
    a = np.zeros((ns, ns))
    for i, row in enumerate(A):
        a[i, : len(row)] = row
    c = np.asarray(C, np.float64)
    ac = a @ c
    conds = (
        (np.ones(ns), 1, 1.0),
        (c, 2, 1.0 / 2.0),
        (c ** 2, 3, 1.0 / 3.0),
        (ac, 3, 1.0 / 6.0),
        (c ** 3, 4, 1.0 / 4.0),
        (c * ac, 4, 1.0 / 8.0),
        (a @ (c ** 2), 4, 1.0 / 12.0),
        (a @ ac, 4, 1.0 / 24.0),
    )
    rows, rhs = [], []
    for w, r, gamma in conds:
        for q in range(1, 5):
            row = np.zeros(ns * 4)
            for i in range(ns):
                row[i * 4 + (q - 1)] = w[i]
            rows.append(row)
            rhs.append(gamma if q == r else 0.0)
    for i in range(ns):  # b_i(1) == B_i: theta=1 reproduces the step
        row = np.zeros(ns * 4)
        row[i * 4: (i + 1) * 4] = 1.0
        rows.append(row)
        rhs.append(B[i])
    M = np.asarray(rows)
    y = np.asarray(rhs)
    sol, *_ = np.linalg.lstsq(M, y, rcond=None)
    if np.max(np.abs(M @ sol - y)) > 1e-10:
        return None
    conds5 = (
        (c ** 4, 5.0),
        (c ** 2 * ac, 10.0),
        (ac ** 2, 20.0),
        (c * (a @ (c ** 2)), 15.0),
        (c * (a @ ac), 30.0),
        (a @ (c ** 3), 20.0),
        (a @ (c * ac), 40.0),
        (a @ (a @ (c ** 2)), 60.0),
        (a @ (a @ ac), 120.0),
    )
    u, s, vt = np.linalg.svd(M, full_matrices=True)
    null = vt[np.sum(s > 1e-9 * s[0]):].T  # [4*ns, k]
    if null.shape[1]:
        thetas = np.linspace(0.1, 1.0, 10)
        soft_rows, soft_rhs = [], []
        for w, gamma in conds5:
            for th in thetas:
                row = np.zeros(ns * 4)
                for i in range(ns):
                    for q in range(1, 5):
                        row[i * 4 + (q - 1)] += w[i] * th ** q
                soft_rows.append(row)
                soft_rhs.append(th ** 5 / gamma)
        S5 = np.asarray(soft_rows)
        y5 = np.asarray(soft_rhs)
        z, *_ = np.linalg.lstsq(S5 @ null, y5 - S5 @ sol, rcond=None)
        sol = sol + null @ z
        if np.max(np.abs(M @ sol - y)) > 1e-9:  # hard constraints intact
            return None
    return tuple(tuple(float(v) for v in sol[i * 4: (i + 1) * 4])
                 for i in range(ns))


def dense_P_for(solver: str):
    """The solver's dense-output P matrix (published for dopri5, derived from
    the order conditions otherwise), or None."""
    if solver in _DENSE_P:
        return _DENSE_P[solver]
    if solver in TABLEAUS:
        A, B, _, C = TABLEAUS[solver]
        _DENSE_P[solver] = _derive_dense_P(A, B, C)
        return _DENSE_P[solver]
    return None


def _wsum(terms, weights):
    """Weighted sum of lanes, skipping zero weights (the JAX kernel's order)."""
    acc = None
    for t, w in zip(terms, weights):
        if w == 0.0:
            continue
        acc = t * w if acc is None else acc + t * w
    return torch.zeros_like(terms[0]) if acc is None else acc


# ---------------------------------------------------------------------------
# Input checks shared by the wrapper and the twin
# ---------------------------------------------------------------------------


def _check_inputs(seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value,
                  obs_sigma, obs_cens, seg_t0, support, rhs, obs_outeq,
                  out_coef, out_bias, bolus_inputs, rate_inputs, merge_runs,
                  solver):
    """Validate the layout; returns (n_out, runs) with ``runs`` the (m0, m1)
    spans tiling [0, M)."""
    if solver not in SOLVER_CODES:
        raise ValueError(
            f"fused ODE psi supports solvers {sorted(SOLVER_CODES)} (got `{solver}`)"
        )
    if seg_dt.dim() != 2:
        raise ValueError(f"segment streams must be [R, M], got {tuple(seg_dt.shape)}")
    R, M = seg_dt.shape
    S = support.shape[0]
    N = rhs.n_states
    dtype, dev = seg_dt.dtype, seg_dt.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused ODE psi takes float32 or float64, got {dtype}")
    if support.dim() != 2 or support.shape[1] != rhs.n_params:
        raise ValueError(
            f"support must be [S, {rhs.n_params}] (the RHS was generated for "
            f"{rhs.n_params} columns), got {tuple(support.shape)}"
        )
    nb, nr = len(bolus_inputs), len(rate_inputs)
    if nb < 1 or max(bolus_inputs) >= rhs.ninput:
        raise ValueError(f"bolus_inputs {bolus_inputs} must name inputs < {rhs.ninput}")
    if seg_rateiv is not None and (nr < 1 or max(rate_inputs) >= rhs.ninput):
        raise ValueError(f"rate_inputs {rate_inputs} must name inputs < {rhs.ninput}")
    shapes = {"seg_bolus": (seg_bolus, (nb, R, M)),
              "seg_rateiv": (seg_rateiv, (nr, R, M)),
              "obs_mask": (obs_mask, (R, M)), "obs_value": (obs_value, (R, M)),
              "obs_sigma": (obs_sigma, (R, M)), "obs_cens": (obs_cens, (R, M)),
              "obs_outeq": (obs_outeq, (R, M)), "seg_t0": (seg_t0, (R, M))}
    if out_coef is None or out_coef.dim() != 3:
        raise ValueError("out_coef [n_out, n_states, S] is required")
    n_out = out_coef.shape[0]
    shapes["out_coef"] = (out_coef, (n_out, N, S))
    shapes["out_bias"] = (out_bias, (n_out, S))
    for name, (a, shape) in shapes.items():
        if a is not None and tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(a.shape)}")
    for name, a in dict(seg_dt=seg_dt, support=support,
                        **{k: v for k, (v, _) in shapes.items()}).items():
        if a is None:
            continue
        if a.dtype != dtype or a.device != dev:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; expected {dtype} on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_out > 1 and obs_outeq is None:
        raise ValueError("obs_outeq stream required for multi-output psi")
    if merge_runs is None:
        runs = tuple((m, m + 1) for m in range(M))
    else:
        runs = tuple((int(a), int(b)) for a, b in merge_runs)
        flat = [0]
        for a, b in runs:
            if a != flat[-1] or b <= a:
                raise ValueError(f"merge_runs must tile [0, {M}) consecutively, got {runs}")
            flat.append(b)
        if flat[-1] != M:
            raise ValueError(f"merge_runs must cover all {M} segments, got {runs}")
    return n_out, runs


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------


def psi_ode_plain(
    seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
    seg_t0, support, rhs, *, obs_outeq=None, out_coef=None, out_bias=None,
    bolus_inputs=(0,), rate_inputs=(0,), merge_runs=None, solver="dopri5",
    rtol=1e-4, atol=1e-4, h0=1e-3, max_steps=10_000, counts=None,
):
    """Plain PyTorch twin of the fused ODE psi kernel (same arguments as
    :func:`psi_ode`), on ``[R, S]`` lanes. A ``counts`` dict receives the
    number of step attempts over all cells (``"steps"``): the work this
    data needs, for the kernel's bound."""
    from ..engine.grid import CovView
    from ..engine.sim import as_components

    n_out, runs = _check_inputs(
        seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma,
        obs_cens, seg_t0, support, rhs, obs_outeq, out_coef, out_bias,
        bolus_inputs, rate_inputs, merge_runs, solver)
    A, B, E, C = TABLEAUS[solver]
    dense_P = dense_P_for(solver)
    n_stages = len(C)
    N, nin = rhs.n_states, rhs.ninput
    R, M = seg_dt.shape
    S = support.shape[0]
    dtype, dev = seg_dt.dtype, seg_dt.device
    shape = (R, S)
    zeros = torch.zeros(shape, dtype=dtype, device=dev)
    nan = torch.full(shape, float("nan"), dtype=dtype, device=dev)
    p_lanes = [support[:, i].reshape(1, S).expand(shape) for i in range(rhs.n_params)]
    coefs = [[out_coef[k, i].reshape(1, S) for i in range(N)] for k in range(n_out)]
    biases = ([out_bias[k].reshape(1, S) for k in range(n_out)]
              if out_bias is not None else None)
    diffeq = rhs.diffeq

    def f(xs, t, rate, b=None):
        bl = [zeros] * nin
        if b is not None:
            bl[b[0]] = b[1]
        out = diffeq(list(xs), p_lanes, t.expand(shape), bl, rate, CovView.empty())
        return as_components(out, N, shape, dtype, dev)

    def col(a, m):
        return a[:, m:m + 1]

    def rate_at(m):
        lanes = [zeros] * nin
        if seg_rateiv is not None:
            for k, j in enumerate(rate_inputs):
                lanes[j] = seg_rateiv[k, :, m:m + 1].expand(shape)
        return lanes

    def out_k(k, xs):
        p = coefs[k][0] * xs[0]
        for s in range(1, N):
            p = p + coefs[k][s] * xs[s]
        return p

    def sel_out(oe, per_out):
        if n_out == 1:
            return per_out[0]
        acc = zeros
        for k in range(n_out):
            acc = torch.where(oe == float(k), per_out[k], acc)
        return acc

    def with_bias(pred, oe):
        if biases is None:
            return pred
        return pred + sel_out(oe, [bk.expand(shape) for bk in biases])

    def obs_term(m, pred):
        mask = col(obs_mask, m) > 0
        sig = torch.where(mask, col(obs_sigma, m), torch.ones_like(col(obs_sigma, m)))
        z = (col(obs_value, m) - pred) / sig
        term = -0.5 * LOG_2PI - torch.log(sig) - 0.5 * z * z
        if obs_cens is not None:
            s_c = col(obs_cens, m)
            term = torch.where(s_c == 0.0, term, torch.special.log_ndtr(s_c * z))
        return torch.where(mask, term, zeros)

    def outeq(m):
        return col(obs_outeq, m) if obs_outeq is not None else None

    def integrate(xs, h, dt_col, rate, t0_col, estimate_h, interior):
        target = dt_col.expand(shape)
        live0 = target > 0.0
        for s in range(N):
            live0 = live0 & torch.isfinite(xs[s])
        k1_0 = f(xs, t0_col, rate)
        t_end_eff = target - 1e-6 * torch.clamp(target, min=1e-30)
        n_int = len(interior) if interior else 0
        if n_int:
            T_eff = [torch.minimum(Tj.expand(shape), t_end_eff) for Tj, _ in interior]
            start = [out_k(k, xs) for k in range(n_out)]
            preds = [torch.where(Tj.expand(shape) <= 0.0, sel_out(oe, start), zeros)
                     for Tj, oe in interior]
        if estimate_h:
            d0 = d1 = zeros
            for s in range(N):
                sc = atol + rtol * torch.abs(xs[s])
                d0 = d0 + (xs[s] / sc) ** 2
                d1 = d1 + (k1_0[s] / sc) ** 2
            d0 = torch.sqrt(d0 / float(N))
            d1 = torch.sqrt(d1 / float(N))
            h0a = torch.where((d0 > 1e-5) & (d1 > 1e-5),
                              0.01 * d0 / torch.clamp(d1, min=1e-30),
                              torch.full_like(d0, 1e-6))
            x1 = [x + h0a * k for x, k in zip(xs, k1_0)]
            f1 = f(x1, t0_col + h0a, rate)
            d2 = zeros
            for s in range(N):
                sc = atol + rtol * torch.abs(xs[s])
                d2 = d2 + ((f1[s] - k1_0[s]) / sc) ** 2
            d2 = torch.sqrt(d2 / float(N)) / h0a
            dmax = torch.maximum(d1, d2)
            h1 = torch.where(
                dmax > 1e-15,
                torch.pow(0.01 / torch.clamp(dmax, min=1e-30), 0.2),
                torch.clamp(h0a * 1e3, min=1e-6),
            )
            h_est = torch.minimum(100.0 * h0a, h1)
            h = torch.where(torch.isfinite(h_est), torch.clamp(h_est, min=h0), h)

        tau = zeros
        xs_c = list(xs)
        h_c = torch.minimum(h, torch.clamp(target, min=1e-14))
        k1 = k1_0
        live = live0
        it = 0
        while it < max_steps and bool(live.any()):
            if counts is not None:
                counts["steps"] = counts.get("steps", 0) + int(live.sum())
            rem = target - tau
            h_try = torch.minimum(h_c, torch.clamp(rem, min=1e-14))
            ks = [k1]
            for i in range(1, n_stages):
                xi = [xs_c[s] + h_try * _wsum([ks[j][s] for j in range(i)], A[i])
                      for s in range(N)]
                ks.append(f(xi, t0_col + tau + C[i] * h_try, rate))
            xs_new = [x + h_try * _wsum([k[s] for k in ks], B)
                      for s, x in enumerate(xs_c)]
            err2 = zeros
            for s in range(N):
                e = h_try * _wsum([k[s] for k in ks], E)
                scale = atol + rtol * torch.maximum(torch.abs(xs_c[s]),
                                                    torch.abs(xs_new[s]))
                err2 = err2 + (e / scale) ** 2
            ratio = torch.sqrt(err2 / float(N))
            finite = torch.isfinite(ratio)
            for s in range(N):
                finite = finite & torch.isfinite(xs_new[s])
            accept = live & (ratio <= 1.0) & finite
            r_fl = torch.clamp(ratio, min=1e-10)
            factor = torch.where(
                finite, torch.clamp(0.9 * torch.pow(r_fl, -0.2), 0.2, 5.0),
                torch.full_like(ratio, 0.25))
            tau_n = torch.where(accept, tau + h_try, tau)
            xs_n = [torch.where(accept, xn, x) for xn, x in zip(xs_new, xs_c)]
            k_last_ok = finite
            for s in range(N):
                k_last_ok = k_last_ok & torch.isfinite(ks[-1][s])
            k1 = [torch.where(accept & k_last_ok, kl, k) for kl, k in zip(ks[-1], k1)]
            h_n = torch.where(live, torch.clamp(h_try * factor, min=1e-14), h_c)
            done_n = tau_n >= t_end_eff
            stalled = live & ((tau_n + h_n) <= tau_n) & ~done_n
            if n_int:
                # dense output: contract the stage slopes with each output's
                # coefficients, then with the interpolant's quartic columns
                crossed = [accept & (tau < T_eff[j]) & (T_eff[j] <= tau + h_try)
                           for j in range(n_int)]
                if any(bool(c.any()) for c in crossed):
                    c0s, dqs = [], []
                    for k in range(n_out):
                        c0s.append(out_k(k, xs_c))
                        ci = [out_k(k, kk) for kk in ks]
                        dqs.append([_wsum(ci, [dense_P[i][q] for i in range(n_stages)])
                                    for q in range(4)])
                    for j, (_, oe) in enumerate(interior):
                        th = (T_eff[j] - tau) / h_try
                        per_out = [c0s[k] + h_try * th * (
                            dqs[k][0] + th * (dqs[k][1] + th * (dqs[k][2] + th * dqs[k][3])))
                            for k in range(n_out)]
                        preds[j] = torch.where(crossed[j], sel_out(oe, per_out), preds[j])
            tau, xs_c, h_c = tau_n, xs_n, h_n
            live = live & ~done_n & ~stalled
            it += 1
        incomplete = tau < t_end_eff
        xs_out = [torch.where(incomplete, nan, x) for x in xs_c]
        h_out = torch.where(live0, h_c, h)
        if n_int:
            # captures an incomplete lane never reached: the same -inf the
            # segment-by-segment march gives
            preds = [torch.where((T_eff[j] > tau) & (Tj.expand(shape) > 0.0), nan, p)
                     for j, ((Tj, _), p) in enumerate(zip(interior, preds))]
            return xs_out, h_out, preds
        return xs_out, h_out, []

    xs = [zeros] * N
    ll = zeros
    h = torch.full(shape, float(h0), dtype=dtype, device=dev)
    for m0, m1 in runs:
        ll = ll + obs_term(m0, with_bias(sel_out(outeq(m0), [out_k(k, xs) for k in range(n_out)]),
                                         outeq(m0)))
        rate = rate_at(m0)
        t0_col = col(seg_t0, m0)
        for k, j in enumerate(bolus_inputs):
            amt = seg_bolus[k, :, m0:m0 + 1]
            if bool((amt != 0.0).any()):
                # the RHS difference (ode/mod.rs:644-687), as the general engine
                d_w = f(xs, t0_col, rate, (j, amt.expand(shape)))
                d_o = f(xs, t0_col, rate)
                xs = [x + (w - o) for x, w, o in zip(xs, d_w, d_o)]
        dt_run = col(seg_dt, m0)
        interior = []
        for mm in range(m0 + 1, m1):
            interior.append((dt_run, outeq(mm)))
            dt_run = dt_run + col(seg_dt, mm)
        xs, h, preds = integrate(xs, h, dt_run, rate, t0_col, m0 == 0, interior)
        for (_, oe), mm, pred in zip(interior, range(m0 + 1, m1), preds):
            ll = ll + obs_term(mm, with_bias(pred, oe))
    return ll


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def psi_ode(
    seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
    seg_t0, support, rhs, *, obs_outeq=None, out_coef=None, out_bias=None,
    bolus_inputs=(0,), rate_inputs=(0,), merge_runs=None, solver="dopri5",
    rtol=1e-4, atol=1e-4, h0=1e-3, max_steps=10_000,
):
    """Fused ODE psi [R, S]: the counterpart of the JAX package's
    ``ops/pallas_ode.py::psi_ode``, explicit tier (dopri5, tsit5).

    ``rhs`` is the :class:`~.rhs_codegen.GeneratedRhs` of the model.
    ``seg_rateiv``, ``obs_cens`` and ``out_bias`` are None when the workload
    has no infusions, censoring or output bias; ``obs_outeq`` is None for one
    output. ``merge_runs``: (m0, m1) spans tiling [0, M) whose interior
    breakpoints the caller proved observation-only (no dose on any row, rates
    unchanged, contiguous times; :func:`~..likelihood.plans.ode._ode_merge_runs`);
    None marches segment by segment.

    On a CUDA tensor this launches ``csrc/fused_ode.cu`` (one thread per
    (row, support) cell) and raises if the build or the launch fails; on a CPU
    tensor it runs :func:`psi_ode_plain`.
    """
    global LAUNCHES
    args = (seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma,
            obs_cens, seg_t0, support, rhs)
    kw = dict(obs_outeq=obs_outeq, out_coef=out_coef, out_bias=out_bias,
              bolus_inputs=tuple(bolus_inputs), rate_inputs=tuple(rate_inputs),
              merge_runs=merge_runs, solver=solver, rtol=rtol, atol=atol,
              h0=h0, max_steps=max_steps)
    dev = seg_dt.device
    if dev.type == "cpu":
        return psi_ode_plain(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused ODE psi runs on cpu or cuda tensors, got {dev}")
    n_out, runs = _check_inputs(*args, obs_outeq, out_coef, out_bias,
                                kw["bolus_inputs"], kw["rate_inputs"],
                                merge_runs, solver)
    R, M = seg_dt.shape
    S = support.shape[0]
    out = torch.empty((R, S), dtype=seg_dt.dtype, device=dev)
    if R == 0 or S == 0:
        return out  # nothing to launch
    from ._build import ODE, load_generated_library

    lib = load_generated_library(ODE, rhs)
    # parameter rows [P, S]: coalesced along supports
    params = support.t().contiguous()
    # one int32 table: bolus inputs, rate inputs, run boundaries
    rate_in = kw["rate_inputs"] if seg_rateiv is not None else ()
    bounds = [runs[0][0]] + [b for _, b in runs]
    ints = torch.tensor(list(kw["bolus_inputs"]) + list(rate_in) + bounds,
                        dtype=torch.int32, device=dev)
    dense = torch.tensor(dense_P_for(solver), dtype=seg_dt.dtype, device=dev)
    nb, nr = len(kw["bolus_inputs"]), len(rate_in)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_ode_launch(
            int(seg_dt.dtype == torch.float64), SOLVER_CODES[solver],
            _ptr(seg_dt), _ptr(seg_bolus), _ptr(seg_rateiv),
            _ptr(obs_mask), _ptr(obs_value), _ptr(obs_sigma), _ptr(obs_cens),
            _ptr(obs_outeq if n_out > 1 else None), _ptr(seg_t0),
            _ptr(params), _ptr(out_coef), _ptr(out_bias), _ptr(dense),
            _ptr(ints), _ptr(out),
            R, S, M, nb, nr, n_out, len(runs),
            ctypes.c_double(rtol), ctypes.c_double(atol), ctypes.c_double(h0),
            int(max_steps), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"fused ODE psi kernel launch failed (R={R}, S={S}, M={M}): "
            f"{lib.fused_ode_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return out
