"""Fused psi for SDE models: CUDA kernel wrapper and plain twin.

The population log-likelihood matrix of an SDE model is, per (row, support)
cell, one bootstrap particle filter over the row's segments: at each valued
observation (read before the dose) weight the cloud by the assay likelihood,
add ``log(max(mean weight, tiny))`` and resample it; add the segment's
boluses to their destination states; march the cloud with adaptive
Euler-Maruyama.

- :func:`psi_sde` is the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/fused_sde.cu``, built at first use with the
  model's generated drift and diffusion (:mod:`.rhs_codegen`, :mod:`._build`),
  or raises; on a CPU tensor it runs the plain twin.
- :func:`psi_sde_plain` is that twin: the JAX package's
  ``ops/pallas_sde.py::psi_sde`` (base and feature tiers) in plain PyTorch on
  ``[R, S, P]`` lanes, with a masked loop per segment that ends when every
  cell is done. It calls the user's closures directly, with the covariates
  through :class:`~.rhs_codegen.LaneCov`. The CPU tests hold it against the JAX kernel
  in interpret mode at zero diffusion; ``chip_smoke.py`` holds the CUDA
  kernel against it on the card, where both draw the same Philox numbers.

What the march does, as the JAX kernel's ``em_march``: one controller per
cell, shared by its particles; each trial takes ``h = min(h, max(target -
tau, 1e-14))``, compares the full step with two half steps, accepts when the
max normalised error over particles and states is finite and <= 1, and sets
``h = clip(0.9 h err^-1/2, 1e-6, 0.1)`` (err 1e4 when not finite); the march
ends at ``tau >= target - 1e-6 target``, on a stall (``tau + h == tau``) or
after ``EM_MAX_ITERS`` trials, and a cell that stopped short is NaN (a -inf
psi cell). Every segment restarts at ``h = 0.1``. Resampling is stratified
(``u_j = (j + U_j) / P``, searchsorted left, clipped to P - 1). The noise is
Philox4x32-10 with Box-Muller (:mod:`.philox`), independent per (row,
support) cell as the JAX kernel's; censored weights use the exact normal CDF
(the TPU kernel's was approximate). Unlike the TPU kernel nothing is padded:
R, S and P are free.

Stream layout: ``seg_dt``, the observation streams and ``seg_t0`` are
[R, M]; ``seg_bolus`` is [nb, R, M], one plane per active bolus input, dosing
``dose_states``; ``seg_rateiv`` [nr, R, M] into the RHS inputs
``rate_inputs``, or None; support [S, NP]; ``init`` [n_states, S] with
``init_mask`` [R], or None; output coefficients [n_out, n_states, S] and
biases [n_out, S] or None. The feature tier (kernel K3b) adds, in the JAX
wrapper's order, ``init_planes`` [n_states, R, S] (an init that reads a
covariate), covariate streams (one [R, M] stream per constant covariate,
its value in column 0, or an (a, b) pair for an affine one), and lag and fa
planes [R, S] per bolus plane or per dose segment through slot tables. With
lag each bolus plane's dose waits in a pending slot and fires in a split
march (see :func:`psi_sde`). The result is [R, S].
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..config import int_dtype
from ..engine.sde import (
    EM_ATOL, EM_MAX_ITERS, EM_MAX_STEP, EM_MIN_STEP, EM_RTOL, EM_SAFETY, ndtr,
)
from . import philox

# Kernel launches through psi_sde on a CUDA tensor (not the twin): K3a's,
# and K3b's (any feature input).
LAUNCHES = 0
FEATURE_LAUNCHES = 0

# Threads per block of the kernel (one block per cell), and the particles a
# thread may own: the kernel is instantiated for these counts.
THREADS = 256
PARTICLES_PER_THREAD = (1, 2, 4, 8, 16)
MAX_PARTICLES = THREADS * PARTICLES_PER_THREAD[-1]
# dynamic shared memory a block may opt in to on Hopper (232,448 bytes)
MAX_SHARED_BYTES = 232_448


def shared_bytes(n_states: int, n_particles: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block: the cloud and the cumulative
    weights, ``(n_states + 1) * P`` values."""
    itemsize = 4 if dtype == torch.float32 else 8
    return (n_states + 1) * n_particles * itemsize


def particles_per_thread(n_particles: int) -> int:
    """The particles each of the kernel's threads owns (contiguously)."""
    need = -(-n_particles // THREADS)
    return next(k for k in PARTICLES_PER_THREAD if k >= need)


def check_particle_count(n_states: int, n_particles: int, dtype: torch.dtype) -> None:
    """ValueError when the kernel cannot hold ``n_particles`` particles."""
    if not 1 <= n_particles <= MAX_PARTICLES:
        raise ValueError(
            f"the fused SDE kernel takes 1..{MAX_PARTICLES} particles "
            f"(got {n_particles})")
    need = shared_bytes(n_states, n_particles, dtype)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"{n_particles} particles x {n_states} states need {need} bytes of "
            f"shared memory in {dtype}, above the {MAX_SHARED_BYTES} a block has")


# ---------------------------------------------------------------------------
# Input checks shared by the wrapper and the twin
# ---------------------------------------------------------------------------


def _check_inputs(seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma,
                  obs_cens, seg_t0, support, gen, obs_outeq, out_coef, out_bias,
                  dose_states, rate_inputs, init, init_mask, n_particles, em_control,
                  init_planes=None, cov_streams=None, cov_names=(), cov_modes=None,
                  lag_planes=None, fa_planes=None, lag_slots=None, fa_slots=None):
    """Validate the layout; returns (n_out, features) with ``features`` a
    :class:`~.fused_ode.Features` (``init`` is its ``init_rows``)."""
    from .fused_ode import check_features

    if em_control not in ("independent", "coupled"):
        raise ValueError(f"em_control must be 'independent' or 'coupled' (got `{em_control}`)")
    if seg_dt.dim() != 2:
        raise ValueError(f"segment streams must be [R, M], got {tuple(seg_dt.shape)}")
    R, M = seg_dt.shape
    S = support.shape[0]
    N = gen.n_states
    dtype, dev = seg_dt.dtype, seg_dt.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused SDE psi takes float32 or float64, got {dtype}")
    if support.dim() != 2 or support.shape[1] != gen.n_params:
        raise ValueError(
            f"support must be [S, {gen.n_params}] (the drift was generated for "
            f"{gen.n_params} columns), got {tuple(support.shape)}")
    check_particle_count(N, int(n_particles), dtype)
    if M > philox.MAX_SEGMENTS:
        raise ValueError(f"at most {philox.MAX_SEGMENTS} segments (got {M})")
    nb, nr = len(dose_states), len(rate_inputs)
    if nb < 1 or min(dose_states) < 0 or max(dose_states) >= N:
        raise ValueError(f"dose_states {dose_states} must name states < {N}")
    if seg_rateiv is not None and (nr < 1 or max(rate_inputs) >= gen.ninput):
        raise ValueError(f"rate_inputs {rate_inputs} must name inputs < {gen.ninput}")
    if cov_modes is not None and tuple(cov_modes) != tuple(gen.cov_modes):
        raise ValueError(f"cov_modes {tuple(cov_modes)} differ from the generated "
                         f"closures' {tuple(gen.cov_modes)}")
    shapes = {"seg_bolus": (seg_bolus, (nb, R, M)),
              "seg_rateiv": (seg_rateiv, (nr, R, M)),
              "obs_mask": (obs_mask, (R, M)), "obs_value": (obs_value, (R, M)),
              "obs_sigma": (obs_sigma, (R, M)), "obs_cens": (obs_cens, (R, M)),
              "obs_outeq": (obs_outeq, (R, M)), "seg_t0": (seg_t0, (R, M))}
    try:
        feats = check_features(gen, shapes, R, M, S, nb, cov_streams, cov_names, init,
                               init_planes, init_mask, lag_planes, fa_planes, lag_slots,
                               fa_slots)
    except ValueError as e:
        raise ValueError(str(e).replace("init_rows", "init")) from None
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
    return n_out, feats


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------

# The kernel's block reductions, in its order of operations, so that the twin
# rounds as the kernel does: thread t holds the particles [t * PPT, t * PPT +
# PPT) (zeros past P), sums them in order, then the 32 lanes of each warp
# combine by butterfly (own + partner, partner = lane ^ offset), then the 8
# warp results are added in order; the prefix sum is a per-thread running sum,
# a Hillis-Steele scan over each warp's lanes and an in-order sum of the
# earlier warps' totals.
_WARPS = THREADS // 32


def _thread_major(v, ppt: int):
    """[..., P] -> [..., THREADS, ppt], zero-padded past P."""
    pad = THREADS * ppt - v.shape[-1]
    if pad:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (pad,))], dim=-1)
    return v.reshape(v.shape[:-1] + (THREADS, ppt))


def _block_sum(v, ppt: int):
    """Sum over the last axis [..., P] as the kernel's block_sum."""
    lanes = _thread_major(v, ppt)
    acc = lanes[..., 0]
    for k in range(1, ppt):
        acc = acc + lanes[..., k]
    w = acc.reshape(acc.shape[:-1] + (_WARPS, 32))
    lane = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        w = w + w[..., lane ^ off]
    total = w[..., 0, 0]
    for i in range(1, _WARPS):
        total = total + w[..., i, 0]
    return total


def _block_cumsum(v, ppt: int):
    """Inclusive prefix sum over the last axis [..., P] as the kernel's
    per-thread running sums plus block_exclusive_scan."""
    P = v.shape[-1]
    lanes = _thread_major(v, ppt)
    run, loc = lanes[..., 0], [lanes[..., 0]]
    for k in range(1, ppt):
        run = run + lanes[..., k]
        loc.append(run)
    inc = run.reshape(run.shape[:-1] + (_WARPS, 32))
    lane = torch.arange(32, device=v.device)
    for off in (1, 2, 4, 8, 16):
        shifted = torch.cat([inc[..., :off], inc[..., :-off]], dim=-1)
        inc = torch.where(lane >= off, inc + shifted, inc)
    excl = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], dim=-1)
    base = [torch.zeros_like(inc[..., 0, 31])]
    for i in range(1, _WARPS):
        base.append(base[-1] + inc[..., i - 1, 31])
    start = (torch.stack(base, dim=-1)[..., None] + excl).reshape(run.shape)
    cw = start[..., None] + torch.stack(loc, dim=-1)
    return cw.reshape(cw.shape[:-2] + (THREADS * ppt,))[..., :P]


def psi_sde_plain(
    seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
    seg_t0, support, gen, *, obs_outeq=None, out_coef=None, out_bias=None,
    dose_states=(0,), rate_inputs=(0,), init=None, init_mask=None,
    n_particles: int, seed: int = 0, em_control: str = "independent",
    init_planes=None, cov_streams=None, cov_names=(), cov_modes=None,
    lag_planes=None, fa_planes=None, lag_slots=None, fa_slots=None, counts=None,
):
    """Plain PyTorch twin of the fused SDE psi kernel (same arguments as
    :func:`psi_sde`), on ``[R, S, P]`` lanes. A ``counts`` dict receives the
    number of Euler-Maruyama trials over all cells (``"trials"``, each on
    every particle; ``"trials_by_row"`` per row [R]): the work this data
    needs, for the kernel's bound."""
    from ..engine.sim import as_components
    from .rhs_codegen import LaneCov

    n_out, ft = _check_inputs(
        seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
        seg_t0, support, gen, obs_outeq, out_coef, out_bias, dose_states,
        rate_inputs, init, init_mask, n_particles, em_control, init_planes,
        cov_streams, cov_names, cov_modes, lag_planes, fa_planes, lag_slots, fa_slots)
    N, nin, P = gen.n_states, gen.ninput, int(n_particles)
    R, M = seg_dt.shape
    S = support.shape[0]
    nb = len(dose_states)
    dtype, dev = seg_dt.dtype, seg_dt.device
    shape, cell = (R, S, P), (R, S)
    key = philox.seed_key(seed)
    coupled = em_control == "coupled"
    tiny = torch.finfo(dtype).tiny
    nan = torch.full(shape, float("nan"), dtype=dtype, device=dev)
    zc = torch.zeros(cell, dtype=dtype, device=dev)

    # counter fields: [draw, row, support, particle]
    i64 = dict(dtype=torch.int64, device=dev)
    part = torch.arange(P, **i64).view(1, 1, 1, P)
    sup = torch.arange(S, **i64).view(1, 1, S, 1)
    row = torch.arange(R, **i64).view(1, R, 1, 1)
    npc = philox.normals_per_call(dtype)
    G = -(-N // npc)
    D = 2 if coupled else 3
    slot = torch.arange(D, **i64).repeat_interleave(G).view(D * G, 1, 1, 1)
    group = torch.arange(G, **i64).repeat(D).view(D * G, 1, 1, 1)
    j_float = torch.arange(P, dtype=dtype, device=dev)
    # a divisor on the device: a Python number would make torch multiply by
    # its reciprocal on the card, which rounds differently from the kernel's
    # division
    P_t = torch.tensor(float(P), dtype=dtype, device=dev)
    ppt = particles_per_thread(P)

    def trial_normals(m, trial):
        """[D, N, R, S, P]: the normals of each cell's trial ``trial`` [R, S]
        of segment m."""
        z = philox.normals(dtype, particle=part, segment=m, trial=trial.view(1, R, S, 1),
                           slot=slot, group=group, support=sup, row=row, key=key)
        return torch.stack(z, dim=1).reshape(D, G * npc, R, S, P)[:, :N]

    p_lanes = [support[:, i].view(1, S, 1).expand(shape) for i in range(gen.n_params)]
    p_cells = [support[:, i].view(1, S).expand(cell) for i in range(gen.n_params)]
    coefs = [[out_coef[k, i].view(1, S, 1) for i in range(N)] for k in range(n_out)]
    biases = ([out_bias[k].view(1, S, 1) for k in range(n_out)]
              if out_bias is not None else None)

    def cov_for(m):
        """The segment's covariates as (cells, lanes) LaneCovs: a per-row
        constant, or the segment's affine (a, b)."""
        cells, lanes = {}, {}
        for name, a, b in ft.cov:
            if b is None:
                v = a[:, 0].view(R, 1)
                cells[name], lanes[name] = v, v[..., None]
            else:
                va, vb = a[:, m].view(R, 1), b[:, m].view(R, 1)
                cells[name], lanes[name] = (va, vb), (va[..., None], vb[..., None])
        return LaneCov(cells), LaneCov(lanes)

    def drift(xs, t, rate, cov):
        out = gen.drift(list(xs), p_lanes, t.expand(shape), rate, cov[1])
        return as_components(out, N, shape, dtype, dev)

    def diffusion(t, cov):
        out = gen.diffusion(p_cells, t, cov[0])
        return [g.unsqueeze(-1) for g in as_components(out, N, cell, dtype, dev)]

    def rate_at(m):
        lanes = [torch.zeros((), dtype=dtype, device=dev).expand(shape)] * nin
        if seg_rateiv is not None:
            for k, j in enumerate(rate_inputs):
                lanes[j] = seg_rateiv[k, :, m].view(R, 1, 1).expand(shape)
        return lanes

    def prediction(xs, m):
        per_out = []
        for k in range(n_out):
            pr = coefs[k][0] * xs[0]
            for i in range(1, N):
                pr = pr + coefs[k][i] * xs[i]
            per_out.append(pr + biases[k] if biases is not None else pr)
        if n_out == 1:
            return per_out[0]
        oe = obs_outeq[:, m].view(R, 1, 1)
        pred = torch.zeros_like(per_out[0])
        for k in range(n_out):
            pred = torch.where(oe == float(k), per_out[k], pred)
        return pred

    def march(xs, target, t0, rate, cov, m, trial):
        """The adaptive Euler-Maruyama march of every cell over ``target``
        [R, S] from ``t0`` [R, S], the controller started afresh; ``trial``
        [R, S] numbers each cell's next trial of segment m. Returns the
        cloud (NaN in a cell that stopped short) and the advanced count."""
        live0 = target > 0.0
        if not bool(live0.any()):
            return xs, trial
        thr = target - 1e-6 * torch.clamp(target, min=1e-30)
        tau = zc
        h = torch.full(cell, EM_MAX_STEP, dtype=dtype, device=dev)
        live = live0
        xs_c = xs
        k = 0
        while k < EM_MAX_ITERS and bool(live.any()):
            if counts is not None:
                counts["trials"] = counts.get("trials", 0) + int(live.sum())
                by_row = live.sum(dim=1)
                counts["trials_by_row"] = counts.get("trials_by_row", 0) + by_row
            h_try = torch.minimum(h, torch.clamp(target - tau, min=1e-14))
            t_abs = t0 + tau
            h_half = h_try * 0.5
            sq_h = torch.sqrt(torch.clamp(h_half, min=0.0))[..., None]
            z = trial_normals(m, trial)
            if coupled:
                w_full = [(a + b) * sq_h for a, b in zip(z[0], z[1])]
                w1 = [a * sq_h for a in z[0]]
                w2 = [b * sq_h for b in z[1]]
            else:
                sq = torch.sqrt(torch.clamp(h_try, min=0.0))[..., None]
                w_full = [a * sq for a in z[0]]
                w1 = [a * sq_h for a in z[1]]
                w2 = [a * sq_h for a in z[2]]
            H, Hh = h_try[..., None], h_half[..., None]
            g0 = diffusion(t_abs, cov)
            d0 = drift(xs_c, t_abs[..., None], rate, cov)
            y1 = [x + d * H + g * w for x, d, g, w in zip(xs_c, d0, g0, w_full)]
            ym = [x + d * Hh + g * w for x, d, g, w in zip(xs_c, d0, g0, w1)]
            t_mid = t_abs + h_half
            g1 = diffusion(t_mid, cov)
            d1 = drift(ym, t_mid[..., None], rate, cov)
            y2 = [x + d * Hh + g * w for x, d, g, w in zip(ym, d1, g1, w2)]
            err = None
            for x, a, b in zip(xs_c, y1, y2):
                e = torch.amax(torch.abs(a - b) / (EM_ATOL + EM_RTOL * torch.abs(x)), dim=-1)
                err = e if err is None else torch.maximum(err, e)
            finite = torch.isfinite(err)
            accept = live & (err <= 1.0) & finite
            tau_n = torch.where(accept, tau + h_try, tau)
            xs_c = [torch.where(accept[..., None], y, x) for y, x in zip(y2, xs_c)]
            e_fl = torch.clamp(torch.where(finite, err, torch.full_like(err, 1e4)), min=1e-12)
            h_n = torch.where(
                live,
                torch.clamp(h_try * EM_SAFETY * (1.0 / torch.sqrt(e_fl)), EM_MIN_STEP, EM_MAX_STEP),
                h)
            done = tau_n >= thr
            stalled = live & ((tau_n + h_n) <= tau_n) & ~done
            trial = trial + live.to(trial.dtype)
            live = live & ~done & ~stalled
            tau, h = tau_n, h_n
            k += 1
        ok = (~live0 | (tau >= thr))[..., None]
        return ([torch.where(live0[..., None], torch.where(ok, xc, nan), x)
                 for xc, x in zip(xs_c, xs)], trial)

    def amt_for(k, m):
        """Bolus plane k's amount at segment m [R, S, 1], fa-scaled."""
        amt = seg_bolus[k, :, m].view(R, 1, 1)
        fp = ft.fa_src(k, m)
        return amt * fp[..., None] if fp is not None else amt

    im = ft.init_mask.view(R, 1, 1) if ft.init_mask is not None else None
    if ft.init_planes is not None:
        xs = [(im * ft.init_planes[i][..., None]).expand(shape) for i in range(N)]
    elif ft.init_rows is not None:
        xs = [(im * ft.init_rows[i].view(1, S, 1)).expand(shape) for i in range(N)]
    else:
        xs = [torch.zeros(shape, dtype=dtype, device=dev)] * N
    ll = torch.zeros(cell, dtype=dtype, device=dev)
    pend_amt = [zc[..., None]] * nb
    pend_rem = [zc[..., None]] * nb
    for m in range(M):
        # observation before the dose: weight, record, resample
        mask = obs_mask[:, m].view(R, 1, 1) > 0
        if bool(mask.any()):
            sig = torch.where(mask, obs_sigma[:, m].view(R, 1, 1),
                              torch.ones((), dtype=dtype, device=dev))
            z = (obs_value[:, m].view(R, 1, 1) - prediction(xs, m)) / sig
            q = torch.exp(-0.5 * z * z) / (sig * math.sqrt(2.0 * math.pi))
            if obs_cens is not None:
                sc = obs_cens[:, m].view(R, 1, 1)
                q = torch.where(sc == 0.0, q, ndtr(sc * z))
            sum_q = _block_sum(q, ppt)
            ll = ll + torch.where(mask[..., 0],
                                  torch.log(torch.clamp(sum_q * (1.0 / P), min=tiny)),
                                  torch.zeros_like(sum_q))
            cw = _block_cumsum(q / torch.clamp(sum_q, min=tiny)[..., None], ppt)
            U = philox.resample_uniform(dtype, particle=part, segment=m,
                                        support=sup, row=row, key=key)[0]
            u = (j_float + U) / P_t
            idx = torch.clamp(torch.searchsorted(cw.contiguous(), u.contiguous()),
                              max=P - 1)
            xs = [torch.where(mask, torch.gather(x, -1, idx), x) for x in xs]
        xs = list(xs)
        dt = seg_dt[:, m].view(R, 1).expand(cell)
        t0 = seg_t0[:, m].view(R, 1).expand(cell)
        rate, cov = rate_at(m), cov_for(m)
        trial = torch.zeros(cell, **i64)
        if ft.lag is None:
            # boluses (fa-scaled) into their destination states, then the march
            for k, ds in enumerate(dose_states):
                xs[ds] = xs[ds] + amt_for(k, m)
            xs, _ = march(xs, dt, t0, rate, cov, m, trial)
            continue
        # lag: the split march of the JAX kernel (:466-538). Doses due at this
        # breakpoint fire first, after its observation; new doses park with
        # their lag per bolus plane; one pass per plane marches to the next
        # earliest fire time (equal times fire together) with the controller
        # restarted, then the march runs to the segment's end. The trial
        # count runs on across the passes of the segment.
        for k, ds in enumerate(dose_states):
            fire0 = (pend_amt[k] != 0.0) & (pend_rem[k] <= 0.0)
            xs[ds] = torch.where(fire0, xs[ds] + pend_amt[k], xs[ds])
            pend_amt[k] = torch.where(fire0, 0.0, pend_amt[k])
        for k in range(nb):
            lp = ft.lag_src(k, m)
            if lp is None:
                continue
            arrive = seg_bolus[k, :, m].view(R, 1, 1) != 0.0
            pend_amt[k] = torch.where(arrive, pend_amt[k] + amt_for(k, m), pend_amt[k])
            pend_rem[k] = torch.where(arrive, lp[..., None], pend_rem[k])
        dt_b = dt[..., None]
        elapsed = zc
        for _ in range(nb):
            will = [(pend_amt[k] != 0.0) & (pend_rem[k] < dt_b) for k in range(nb)]
            t_next = dt_b
            for k in range(nb):
                t_next = torch.minimum(t_next, torch.where(will[k], pend_rem[k], dt_b))
            t_next = torch.maximum(t_next[..., 0], elapsed)
            xs, trial = march(xs, t_next - elapsed, t0 + elapsed, rate, cov, m, trial)
            for k, ds in enumerate(dose_states):
                fire = will[k] & (pend_rem[k] <= t_next[..., None])
                xs[ds] = torch.where(fire, xs[ds] + pend_amt[k], xs[ds])
                pend_amt[k] = torch.where(fire, 0.0, pend_amt[k])
            elapsed = t_next
        xs, trial = march(xs, dt - elapsed, t0 + elapsed, rate, cov, m, trial)
        for k in range(nb):
            pend_rem[k] = torch.where((pend_amt[k] != 0.0) & (dt_b > 0.0),
                                      pend_rem[k] - dt_b, pend_rem[k])
    return ll


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def psi_sde(
    seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
    seg_t0, support, gen, *, obs_outeq=None, out_coef=None, out_bias=None,
    dose_states=(0,), rate_inputs=(0,), init=None, init_mask=None,
    n_particles: int, seed: int = 0, em_control: str = "independent",
    init_planes=None, cov_streams=None, cov_names=(), cov_modes=None,
    lag_planes=None, fa_planes=None, lag_slots=None, fa_slots=None,
):
    """Fused SDE particle-filter psi [R, S]: the counterpart of the JAX
    package's ``ops/pallas_sde.py::psi_sde``, base and feature tiers.

    ``gen`` is the :class:`~.rhs_codegen.GeneratedSde` of the model.
    ``seg_rateiv``, ``obs_cens`` and ``out_bias`` are None when the workload
    has no infusions, censoring or output bias; ``obs_outeq`` is None for one
    output; ``init`` [N, S] (one row per support) or ``init_planes`` [N, R,
    S] (an init that reads a covariate) with ``init_mask`` [R], or none of
    them. Features, in the JAX wrapper's order (all optional):
    ``cov_streams`` {name: one [R, M] stream (column 0 = the row's constant)
    or an (a, b) pair of [R, M] streams, ``cov(t) = a + b t`` in each
    segment} for the generated closures' ``cov_names`` (``cov_modes``, when
    given, must be theirs); ``lag_planes``/``fa_planes``: one [R, S] plane
    per bolus plane, or the slot-indexed planes ``lag_slots``/``fa_slots``
    ([nb][M] tables, -1 where no dose lands) select per segment. With lag
    planes each bolus plane's dose waits its lag and fires in a split march.

    On a CUDA tensor this launches ``csrc/fused_sde.cu`` (one block per
    (row, support) cell, 256 threads over the particles): kernel K3a without
    features (counted in ``LAUNCHES``), K3b with any (``FEATURE_LAUNCHES``),
    and raises if the build or the launch fails; on a CPU tensor it runs
    :func:`psi_sde_plain`.
    """
    global LAUNCHES, FEATURE_LAUNCHES
    args = (seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma,
            obs_cens, seg_t0, support, gen)
    kw = dict(obs_outeq=obs_outeq, out_coef=out_coef, out_bias=out_bias,
              dose_states=tuple(int(d) for d in dose_states),
              rate_inputs=tuple(int(j) for j in rate_inputs), init=init,
              init_mask=init_mask, n_particles=int(n_particles), seed=int(seed),
              em_control=em_control, init_planes=init_planes, cov_streams=cov_streams,
              cov_names=cov_names, cov_modes=cov_modes, lag_planes=lag_planes,
              fa_planes=fa_planes, lag_slots=lag_slots, fa_slots=fa_slots)
    dev = seg_dt.device
    if dev.type == "cpu":
        return psi_sde_plain(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused SDE psi runs on cpu or cuda tensors, got {dev}")
    n_out, ft = _check_inputs(*args, obs_outeq, out_coef, out_bias, kw["dose_states"],
                              kw["rate_inputs"], init, init_mask, kw["n_particles"],
                              em_control, init_planes, cov_streams, cov_names, cov_modes,
                              lag_planes, fa_planes, lag_slots, fa_slots)
    R, M = seg_dt.shape
    S = support.shape[0]
    out = torch.empty((R, S), dtype=seg_dt.dtype, device=dev)
    if R == 0 or S == 0:
        return out  # nothing to launch
    from ._build import load_generated_library, sde_kind

    feature = bool(ft.cov) or ft.lag is not None or ft.fa is not None \
        or ft.init_planes is not None
    lib = load_generated_library(sde_kind(feature), gen)
    # parameter rows [NP, S]: a block reads its support's column
    params = support.t().contiguous()
    nb = len(kw["dose_states"])
    rate_in = kw["rate_inputs"] if seg_rateiv is not None else ()
    # one int32 table: destination states, rate inputs, then (K3b) the lag and
    # fa slot tables [nb, M]
    table = list(kw["dose_states"]) + list(rate_in)
    if feature:
        for planes, slots in ((ft.lag, ft.lag_slots), (ft.fa, ft.fa_slots)):
            if planes is not None:
                rows = slots if slots is not None else [[k] * M for k in range(nb)]
                table += [int(v) for row in rows for v in row]
    ints = torch.tensor(table, dtype=int_dtype(), device=dev)
    k0, k1 = philox.seed_key(kw["seed"])
    base = (seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
            obs_outeq if n_out > 1 else None, seg_t0, params, init, init_mask, out_coef,
            out_bias)
    dims = (R, S, M, kw["n_particles"], nb, len(rate_in), n_out,
            int(em_control == "coupled"))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if not feature:
            err = lib.fused_sde_launch(int(seg_dt.dtype == torch.float64),
                                       *(_ptr(t) for t in base), _ptr(ints), _ptr(out),
                                       *dims, ctypes.c_uint32(k0), ctypes.c_uint32(k1),
                                       stream)
        else:
            # covariates as two [NCOV, R, M] stacks: a constant one's value in
            # every column, its b row unread
            cov_a = cov_b = None
            if ft.cov:
                cov_a = torch.stack([a if b is not None else a[:, :1].expand(R, M)
                                     for _, a, b in ft.cov]).contiguous()
                if any(b is not None for _, _, b in ft.cov):
                    cov_b = torch.stack([b if b is not None else torch.zeros_like(a)
                                         for _, a, b in ft.cov]).contiguous()
            lag = torch.stack(ft.lag).contiguous() if ft.lag is not None else None
            fa = torch.stack(ft.fa).contiguous() if ft.fa is not None else None
            feat = (ctypes.c_void_p * 5)(*(_ptr(t) for t in (
                cov_a, cov_b, lag, fa, ft.init_planes)))
            err = lib.fused_sde_feature_launch(
                int(seg_dt.dtype == torch.float64),
                (ctypes.c_void_p * 14)(*(_ptr(t) for t in base)), feat, _ptr(ints),
                _ptr(out), *dims, len(ft.lag or ()), len(ft.fa or ()),
                ctypes.c_uint32(k0), ctypes.c_uint32(k1), stream)
    if err != 0:
        raise RuntimeError(
            f"fused SDE psi kernel launch failed (R={R}, S={S}, M={M}, "
            f"P={kw['n_particles']}): {lib.fused_sde_error_string(err).decode()}")
    if feature:
        FEATURE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def resident_blocks(gen, dtype: torch.dtype, n_particles: int, feature: bool = False) -> int:
    """Blocks of the kernel (of the feature tier with ``feature``) for
    ``n_particles`` particles in ``dtype`` that one SM of the current card
    holds at once, as the CUDA runtime reckons it for the launch's shared
    memory: a measurement of the build, not part of the psi path."""
    from ._build import load_generated_library, sde_kind

    lib = load_generated_library(sde_kind(feature), gen)
    blocks = ctypes.c_int(0)
    err = lib.fused_sde_occupancy(int(dtype == torch.float64), int(n_particles),
                                  ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: {lib.fused_sde_error_string(err).decode()}")
    return blocks.value


def philox_words(counters: torch.Tensor, seed: int, gen) -> torch.Tensor:
    """The kernel's own Philox4x32-10 words for ``counters`` [n, 4] (int64
    on the card, each word < 2^32) under the key of ``seed``: [n, 4] int64.
    A check of the kernel's generator against :mod:`.philox`, not part of the
    psi path (no launch is counted)."""
    from ._build import SDE, load_generated_library

    if counters.device.type != "cuda" or counters.dim() != 2 or counters.shape[1] != 4:
        raise ValueError("counters must be [n, 4] on a CUDA device")
    lib = load_generated_library(SDE, gen)
    c = counters.to(torch.int64)
    c = torch.where(c >= 1 << 31, c - (1 << 32), c).to(torch.int32).contiguous()
    out = torch.empty_like(c)
    k0, k1 = philox.seed_key(seed)
    with torch.cuda.device(counters.device):
        stream = torch.cuda.current_stream(counters.device).cuda_stream
        err = lib.fused_sde_philox(int(c.shape[0]), _ptr(c), ctypes.c_uint32(k0),
                                   ctypes.c_uint32(k1), _ptr(out), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"philox check launch failed: {lib.fused_sde_error_string(err).decode()}")
    return out.to(torch.int64) & philox.MASK32
