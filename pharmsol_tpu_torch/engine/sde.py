"""Particle-filter SDE engine: Euler-Maruyama clouds with resampling.

The counterpart of the JAX package's ``engine/sde.py`` for the population
likelihood, in the reference's semantics (sde/mod.rs, em.rs):

- every occasion row carries a cloud of ``nparticles`` particles; each segment
  advances the cloud with adaptive Euler-Maruyama (the full step against two
  half steps, error = max normalised difference over particles and states,
  ``dt = clamp(0.9 dt err^-1/2, [1e-6, 0.1])``, rtol = atol = 1e-2, the half-
  step solution accepted);
- at each valued observation, read before the segment's bolus, the particles
  are weighted by the assay likelihood (the normal density, or the exact
  normal CDF of ``+-z`` for BLOQ/ALOQ), resampled, and the cell gains
  ``log(max(mean weight, tiny))``;
- boluses land in ``bolus_dest[input]`` (inject-to-destination routes);
- ``init`` sets the state at t = 0 on the occasion marked by ``init_mask``;
- every closure reads the row's covariates through ``cov(name, t)``; ``lag``
  shifts each bolus (evaluated at its time) and ``fa`` scales it (evaluated
  at the shifted time), so each support sorts its own segments.

The filter (:func:`simulate_occasion_sde_ll`) and the prediction march
(:func:`simulate_occasion_sde`: no weighting, the particle means at each
observation, the JAX engine's ``filter_on=False``) run one segment loop
(``_march``); the prediction march also takes one parameter row per
occasion row (``per_row``), for the per-subject batch.

The JAX engine vmaps a per-cell ``lax.while_loop``; here one masked Python
loop runs over every (support, row) cell at once on ``[S, R, P, n]`` clouds,
one step controller per cell, the error being the max over the cell's
particles and states. A cell stops at ``t >= t1 - 1e-14``, on the
``(t + dt) > t`` stall test or after ``EM_MAX_ITERS`` trials, and a cell that
stopped short is poisoned to NaN (a -inf psi cell), as in the JAX engine.

Noise comes from one explicit ``torch.Generator``: ``noise='common'`` draws
``[R, P, n]`` per trial and shares it across supports (common random numbers,
as the JAX engine's default), ``'independent'`` draws ``[S, R, P, n]``. The
numbers differ from JAX's threefry, so the two engines agree exactly only at
zero diffusion and statistically otherwise.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from .grid import CovView, OccasionArrays, build_segments
from .sim import as_vector

EM_RTOL = 1e-2
EM_ATOL = 1e-2
EM_MAX_STEP = 0.1
EM_MIN_STEP = 1e-6
EM_SAFETY = 0.9
EM_MAX_ITERS = 100_000


class SDESpec(NamedTuple):
    nstates: int
    ninput: int
    nout: int
    nparticles: int
    # drift(x, p, t, rateiv, cov) -> dx   (per particle)
    drift: Callable
    # diffusion(p, t, cov) -> g[nstates]
    diffusion: Callable
    out: Callable  # out(x, p, t, cov) -> y[nout]
    init: Optional[Callable] = None
    lag: Optional[Callable] = None  # lag(p, t, cov) -> {input: lag} or [ninput]
    fa: Optional[Callable] = None  # fa(p, t, cov) -> {input: fa} or [ninput]
    # bolus destination state per input (inject-to-destination mapping or
    # identity input -> state)
    bolus_dest: Optional[tuple] = None
    resampling: str = "stratified"  # | 'systematic'
    em_control: str = "independent"  # | 'coupled'
    noise: str = "common"  # | 'independent'


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF, accurate in both tails: the formula of
    ``jax.scipy.special.ndtr`` (``torch.special.ndtr`` computes ``(1 +
    erf(x / sqrt 2)) / 2`` and loses the left tail, 0 below x = -8.3)."""
    w = x * (0.5 * math.sqrt(2.0))
    z = torch.abs(w)
    y = torch.where(z < 0.5 * math.sqrt(2.0), 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def _batched_closures(spec: SDESpec, rows: OccasionArrays, names, dtype, device,
                      per_row: bool = False):
    """drift on [S, R, P, n] clouds, diffusion on [S, R] cells, out on clouds
    and init on supports x rows, each vmapped from the per-particle closure,
    with each row's covariate view rebuilt from its knots inside the row vmap
    (as ``engine/ode.py::lane_rhs``). Times are [S, R], rates [S, R, ninput];
    the parameters [S, n_params], or with ``per_row`` [S, R, n_params]."""
    n = spec.nstates
    pr = 0 if per_row else None  # row axis of the parameters
    knots = (rows.cov_t, rows.cov_v, rows.cov_fixed)

    def drift_one(x, p, t, rateiv, kt, kv, kf):
        return as_vector(spec.drift(x, p, t, rateiv, CovView(kt, kv, kf, names)),
                         x).reshape(n)

    def diffusion_one(p, t, kt, kv, kf):
        return as_vector(spec.diffusion(p, t, CovView(kt, kv, kf, names)), p).reshape(n)

    def out_one(x, p, t, kt, kv, kf):
        return as_vector(spec.out(x, p, t, CovView(kt, kv, kf, names)),
                         x).reshape(spec.nout)

    k3 = (0, 0, 0)
    drift_b = vmap(vmap(vmap(drift_one, in_dims=(0, None, None, None) + (None,) * 3),
                        in_dims=(0, pr, 0, 0) + k3),
                   in_dims=(0, 0, 0, 0) + (None,) * 3)
    diffusion_b = vmap(vmap(diffusion_one, in_dims=(pr, 0) + k3),
                       in_dims=(0, 0) + (None,) * 3)
    out_b = vmap(vmap(vmap(out_one, in_dims=(0, None, None) + (None,) * 3),
                      in_dims=(0, pr, 0) + k3),
                 in_dims=(0, 0, 0) + (None,) * 3)

    def drift(X, p, t, rateiv):
        return drift_b(X, p, t, rateiv, *knots)

    def diffusion(p, t):
        return diffusion_b(p, t, *knots)

    def out(X, p, t):
        return out_b(X, p, t, *knots)

    init = None
    if spec.init is not None:
        # init at t = 0, reading each row's covariates there
        t0 = torch.zeros((), dtype=dtype, device=device)

        def init_one(p, kt, kv, kf):
            return as_vector(spec.init(p, t0, CovView(kt, kv, kf, names)), p).reshape(n)

        init_b = vmap(vmap(init_one, in_dims=(pr,) + k3), in_dims=(0,) + (None,) * 3)

        def init(p):  # [S, R, n]
            return init_b(p, *knots)
    return drift, diffusion, out, init


def _em_segment(drift, diffusion, X, p, t0, t1, rateiv, draw_normals,
                coupled: bool):
    """Advance the clouds ``X`` [S, R, P, n] from ``t0`` to ``t1`` [S, R]
    with adaptive Euler-Maruyama, one controller per cell.

    ``draw_normals()`` gives the standard normals of the next trial,
    broadcastable to ``X``, with a leading axis of 2 (coupled: the two
    half-step increments) or 3 (independent: the full step and the two half
    steps, em.rs).
    """
    h = torch.full_like(t0, EM_MAX_STEP)
    t = t0.clone()
    iters = torch.zeros(t0.shape, dtype=torch.int64, device=t0.device)

    def cond():
        return (t < t1 - 1e-14) & (iters < EM_MAX_ITERS) & ((t + h) > t)

    active = cond()
    while bool(active.any()):
        hc = torch.minimum(h, t1 - t)
        z = draw_normals()
        hh = hc[..., None, None]
        half = torch.sqrt(hh / 2.0)
        if coupled:
            w_full, w1, w2 = (z[0] + z[1]) * half, z[0] * half, z[1] * half
        else:
            w_full, w1, w2 = z[0] * torch.sqrt(hh), z[1] * half, z[2] * half
        d0 = drift(X, p, t, rateiv)
        g0 = diffusion(p, t)[:, :, None, :]
        y1 = X + d0 * hh + g0 * w_full
        y2 = X + d0 * (hh / 2.0) + g0 * w1
        tm = t + hc / 2.0
        y2 = y2 + drift(y2, p, tm, rateiv) * (hh / 2.0) + diffusion(p, tm)[:, :, None, :] * w2
        tol = EM_ATOL + EM_RTOL * torch.abs(X)
        err = torch.amax(torch.abs(y1 - y2) / tol, dim=(-2, -1))
        accept = active & (err <= 1.0)
        t = torch.where(accept, t + hc, t)
        X = torch.where(accept[..., None, None], y2, X)
        new_h = torch.clamp(hc * EM_SAFETY * torch.rsqrt(torch.clamp(err, min=1e-12)),
                            EM_MIN_STEP, EM_MAX_STEP)
        h = torch.where(active, new_h, h)
        iters = iters + active.to(iters.dtype)
        active = cond()
    done = t >= t1 - 1e-14 * torch.clamp(torch.abs(t1), min=1.0)
    return torch.where(done[..., None, None], X, torch.full_like(X, float("nan")))


def _resample_index(w, u):
    """Smallest k with cumsum(w)[k] >= u (searchsorted left), clipped to
    the last particle: ``w`` [..., P] weights, ``u`` [..., P] positions."""
    cw = torch.cumsum(w, dim=-1)
    idx = torch.searchsorted(cw.contiguous(), u.contiguous(), side="left")
    return torch.clamp(idx, max=w.shape[-1] - 1)


def resample_positions(U, P: int):
    """Resampling positions ``u_j = (j + U_j) / P``: with one uniform per
    particle (``U`` [..., P]) the reference's stratified scheme
    (sde/mod.rs:747-768, which it names ``sysresample``); with one shared
    offset (``U`` [..., 1]) textbook systematic resampling."""
    j = torch.arange(P, dtype=U.dtype, device=U.device)
    return (j + U) / P


class SDESim(NamedTuple):
    """The prediction march's results: the particle means of the JAX
    package's ``engine/sde.py::SDESim`` (:74-79) for every cell."""

    pred_mean: torch.Tensor  # [S, R, NO] mean prediction over the particles
    state_mean: torch.Tensor  # [S, R, NO, nstates] mean pre-bolus state


def _march(spec: SDESpec, rows: OccasionArrays, p: torch.Tensor, segs,
           generator: torch.Generator, names, observe, per_row: bool = False) -> None:
    """The segment loop shared by the filter and the prediction march.

    ``p`` [S, n_params] (or, with ``per_row``, [1, R, n_params]); ``segs``
    the streams of ``build_segments`` for ``p``. At each segment
    ``observe(m, X, t, out)`` is handed the clouds ``X`` [S, R, P, n] before
    the bolus (observation before dose), the breakpoint times ``t`` [S, R]
    and the batched ``out`` closure, and returns the clouds to go on with;
    then the bolus lands in its destination state and the segment is
    propagated with adaptive Euler-Maruyama.
    """
    fd, dev = p.dtype, p.device
    R = rows.obs_t.shape[0]
    M = segs.t.shape[-1]
    S, P, n = p.shape[0], int(spec.nparticles), spec.nstates
    drift, diffusion, out, init = _batched_closures(spec, rows, names, fd, dev, per_row)
    coupled = spec.em_control == "coupled"
    common = spec.noise == "common"
    cell_shape = (R, P) if common else (S, R, P)
    dest = torch.as_tensor(spec.bolus_dest if spec.bolus_dest is not None
                           else tuple(range(spec.ninput)), dtype=torch.int64,
                           device=dev)

    def sr(a):  # column m of a per-row [R, M] or per-(support, row) stream as [S, R]
        return a.expand((S,) + tuple(a.shape[-1:])) if a.dim() == 1 else a

    X = torch.zeros((S, R, P, n), dtype=fd, device=dev)
    if init is not None:
        x0 = rows.init_mask.to(fd)[None, :, None] * init(p)  # [S, R, n]
        X = X + x0[:, :, None, :]

    def draw_normals():
        z = torch.randn((2 if coupled else 3, *cell_shape, n), generator=generator,
                        dtype=fd, device=dev)
        return z if not common else z[:, None]

    for m in range(M):
        t = sr(segs.t[..., m])
        X = observe(m, X, t, out)

        # bolus into its destination state
        bvec = torch.nn.functional.one_hot(dest[sr(segs.b_input[..., m])], n).to(fd)
        X = X + (bvec * sr(segs.b_amt[..., m])[..., None])[:, :, None, :]

        # propagate
        dt = sr(segs.dt[..., m])
        if bool((dt > 0.0).any()):
            rateiv = segs.rateiv[..., m, :]
            rateiv = rateiv.expand((S,) + tuple(rateiv.shape[-2:]))
            X_prop = _em_segment(drift, diffusion, X, p, t, t + dt, rateiv,
                                 draw_normals, coupled)
            X = torch.where((dt > 0.0)[..., None, None], X_prop, X)


def simulate_occasion_sde(spec: SDESpec, rows: OccasionArrays, p: torch.Tensor,
                          generator: torch.Generator, cov_names=(),
                          per_row: bool = False) -> SDESim:
    """Particle-mean predictions of every row at every support point: the
    JAX package's ``simulate_occasion_sde`` with ``filter_on=False``
    (:185-339; the reference's path without error models). The clouds
    advance with no weighting and no resampling; at each observation slot
    the prediction is the mean over particles of the slot's output, the
    state the mean pre-bolus state.

    ``p``: support points [S, n_params], or with ``per_row`` one parameter
    row per occasion row [R, n_params] (S = 1); ``generator`` draws the
    noise. Returns :class:`SDESim` over [S, R, NO].
    """
    names = tuple(cov_names)
    if per_row:
        p = p.unsqueeze(0)  # [1, R, P]: one cell per row
    segs = build_segments(rows, spec.ninput, p, spec.lag, spec.fa, names)
    pos = segs.obs_pos
    seg_outeq = torch.zeros_like(segs.b_input).scatter(-1, pos, rows.obs_outeq.expand(pos.shape))
    preds, states = [], []

    def record(m, X, t, out):
        S, R, P = X.shape[:3]
        idx = seg_outeq[..., m].expand(S, R).view(S, R, 1, 1).expand(S, R, P, 1)
        preds.append(torch.gather(out(X, p, t), 3, idx)[..., 0].mean(dim=-1))
        states.append(X.mean(dim=2))
        return X

    _march(spec, rows, p, segs, generator, names, record, per_row)
    pred_all = torch.stack(preds, dim=-1)  # [S, R, M]
    state_all = torch.stack(states, dim=2)  # [S, R, M, n]
    S, R, _, n = state_all.shape
    pos = pos.expand((S,) + tuple(pos.shape[-2:]))  # [S, R, NO]
    return SDESim(
        pred_mean=torch.gather(pred_all, 2, pos),
        state_mean=torch.gather(state_all, 2, pos.unsqueeze(-1).expand(pos.shape + (n,))),
    )


def simulate_occasion_sde_ll(spec: SDESpec, rows: OccasionArrays, p: torch.Tensor,
                             em_kind, em_factor, em_poly,
                             generator: torch.Generator, cov_names=()) -> torch.Tensor:
    """Particle-filter log-likelihood of every row at every support point.

    ``rows``: OccasionArrays of tensors with a leading row axis R; ``p``:
    support points [S, n_params]; ``em_*``: lowered error-model tensors;
    ``generator``: the source of every draw, on ``p``'s device;
    ``cov_names``: the covariates of ``rows.cov_*``, read by the closures
    through a per-row :class:`~.grid.CovView`. With lag or fa every support
    sorts its own lag-shifted segments ([S, R, M] streams, JAX
    ``engine/sde.py:185-210``). Returns [S, R].
    """
    from ..likelihood.loglik import observation_sigmas

    fd, dev = p.dtype, p.device
    names = tuple(cov_names)
    segs = build_segments(rows, spec.ninput, p, spec.lag, spec.fa, names)
    R = rows.obs_t.shape[0]
    S, P = p.shape[0], int(spec.nparticles)
    n = spec.nstates
    cell_shape = (R, P) if spec.noise == "common" else (S, R, P)

    sigma_obs, active_obs = observation_sigmas(rows, em_kind, em_factor, em_poly)
    pos = segs.obs_pos

    def scatter(base, src):
        return base.scatter(-1, pos, src.expand(pos.shape))

    seg_sigma = scatter(torch.ones_like(segs.t), sigma_obs)
    seg_active = scatter(torch.zeros_like(segs.is_event), active_obs)
    seg_value = scatter(torch.zeros_like(segs.t), rows.obs_value)
    seg_cens = scatter(torch.zeros_like(segs.b_input), rows.obs_cens)
    seg_outeq = scatter(torch.zeros_like(segs.b_input), rows.obs_outeq)

    def sr(a):  # column m of a per-row [R, M] or per-(support, row) stream as [S, R]
        return a.expand((S,) + tuple(a.shape[-1:])) if a.dim() == 1 else a

    ll = torch.zeros((S, R), dtype=fd, device=dev)
    tiny = torch.finfo(fd).tiny
    sqrt_2pi = math.sqrt(2.0 * math.pi)

    def weigh(m, X, t, out):
        # observation before bolus: weight, record, resample
        nonlocal ll
        weighted = sr(seg_active[..., m])  # [S, R]
        if not bool(weighted.any()):
            return X
        y_all = out(X, p, t)  # [S, R, P, nout]
        idx = sr(seg_outeq[..., m]).view(S, R, 1, 1).expand(S, R, P, 1)
        y = torch.gather(y_all, 3, idx)[..., 0]
        sigma = sr(seg_sigma[..., m])[..., None]
        z = (sr(seg_value[..., m])[..., None] - y) / sigma
        q_pdf = torch.exp(-0.5 * z * z) / (sigma * sqrt_2pi)
        cens = sr(seg_cens[..., m])[..., None]
        q = torch.where(cens == 1, ndtr(z), torch.where(cens == 2, ndtr(-z), q_pdf))
        wv = weighted[..., None]
        q = torch.where(wv, q, torch.ones_like(q))
        sum_q = q.sum(dim=-1)  # [S, R]
        w = q / torch.clamp(sum_q, min=tiny)[..., None]
        u_shape = (cell_shape[:-1] + (1,) if spec.resampling == "systematic"
                   else cell_shape)
        U = torch.rand(u_shape, generator=generator, dtype=fd, device=dev)
        ridx = _resample_index(w, resample_positions(U, P).expand(S, R, P))
        X_rs = torch.gather(X, 2, ridx[..., None].expand(S, R, P, n))
        ll = ll + torch.where(weighted, torch.log(torch.clamp(sum_q / P, min=tiny)),
                              torch.zeros_like(sum_q))
        return torch.where(wv[..., None], X_rs, X)

    _march(spec, rows, p, segs, generator, names, weigh)
    return ll
