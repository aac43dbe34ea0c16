"""The segment march of the general engine: psi and predictions.

One Python loop over the sorted breakpoint stream (:class:`SegmentMarch`)
takes the place of the JAX package's ``lax.scan`` (itself the reference's
per-subject event loop, equation/mod.rs:480-516). Every step works on the
whole population at once: states are ``[S, R, nstates]`` tensors over
supports S and occasion rows R, or, with one parameter row per occasion row
(the per-subject batch), over R cells with S = 1. The log-likelihood
(:func:`simulate_occasion_ll`) reads each segment's state as the loop
passes; the predictions (:func:`simulate_occasion`) keep the states at the
observation slots.

- the observation at a breakpoint reads the state *before* its bolus
  (observation-before-dose ordering at equal times);
- the bolus payload is applied through the model's ``apply_bolus`` hook
  (analytical: ``x[input] += amount``; ODE: the RHS difference of
  ode/mod.rs:644-687);
- the segment is then propagated by the model's closed form, or by the ODE
  stepper, which carries its cruise step from one segment to the next.

Model closures (``out``, the kernel, its prepared split, the ODE right-hand
side) are written for one (state, parameter) pair, as in the JAX package, and
are evaluated here through ``torch.func.vmap`` over supports and rows. The
ODE stepper (``propagate_carry``) is itself batched over the lanes: its
adaptive loop cannot be vmapped.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from .grid import CovView, OccasionArrays, build_segments


class ModelSpec(NamedTuple):
    """The role decomposition an analytical or ODE model lowers to."""

    nstates: int
    ninput: int
    nout: int
    # propagate(x, p, dt, rateiv, t0, cov) -> x_next over one smooth segment
    propagate: Callable
    # out(x, p, t, cov) -> y[nout]
    out: Callable
    # init(p, t, cov) -> x0[nstates] on occasion 0; None -> zeros
    init: Optional[Callable] = None
    # lag/fa: (p, t, cov) -> dict {input: value} or [ninput] vector
    lag: Optional[Callable] = None
    fa: Optional[Callable] = None
    # seq(p, t, cov) -> p (secondary equations; analytical only)
    seq: Optional[Callable] = None
    # apply_bolus(x, bvec[ninput], p, t, rateiv, cov) -> x ; None -> state add
    apply_bolus: Optional[Callable] = None
    # hoisted-parameter path, used when seq is None: prepare(p) computes
    # parameter-only quantities once (eigenvalues, ratios);
    # propagate_prepared(aux, x, dt, rateiv, t0, cov) runs per segment with
    # the dt-dependent work only.
    prepare: Optional[Callable] = None
    propagate_prepared: Optional[Callable] = None
    # ODE: propagate_carry(x [S, R, n], p [S, P], dt [R] or [S, R], rateiv
    # [R, ninput] or [S, R, ninput], t0 like dt, cov, h [S, R]) -> (x_next,
    # h_next), batched over the lanes; ``cov`` carries every row's knots. The
    # march threads h (the solver's cruise step) across segments, warm-
    # starting each segment's adaptive controller; 0.0 = no history.
    propagate_carry: Optional[Callable] = None


def default_apply_bolus(nstates: int):
    """Analytical-state bolus: input index i adds into state i.

    Parity: the V-state ``add_bolus`` impl used by Analytical models.
    """

    def apply(x, bvec, p, t, rateiv, cov):
        pad = nstates - bvec.shape[0]
        if pad > 0:
            bvec = torch.cat([bvec, bvec.new_zeros(pad)])
        elif pad < 0:
            bvec = bvec[:nstates]
        return x + bvec

    return apply


def as_vector(v, like: torch.Tensor) -> torch.Tensor:
    """A closure's result as a tensor of ``like``'s dtype and device: a
    tensor as it is, a list of components (Python constants among them, as
    ``[-k * x[0], 0.0]``) stacked."""
    if not isinstance(v, torch.Tensor):
        v = torch.stack([torch.as_tensor(c, dtype=like.dtype, device=like.device)
                         for c in v])
    return v.to(like.dtype)


def as_components(v, n: int, shape, dtype, device) -> list:
    """A closure's result on lanes as ``n`` tensors of ``shape`` (a stacked
    result split along its first axis, Python constants broadcast)."""
    comps = v.unbind(0) if isinstance(v, torch.Tensor) else list(v)
    if len(comps) != n:
        raise ValueError(f"closure returned {len(comps)} components, expected {n}")
    return [torch.as_tensor(c, dtype=dtype, device=device).expand(shape) for c in comps]


def rhs_difference_apply_bolus(diffeq: Callable):
    """ODE bolus via RHS difference (ode/mod.rs:644-687).

    ``delta = f(x, b) - f(x, 0)`` applied instantaneously: for the canonical
    ``dx[i] += b[j]`` pattern this adds the dose; it also honors scaled or
    multi-state mappings of ``b`` written in user RHS code.
    """

    def apply(x, bvec, p, t, rateiv, cov):
        dx_with = as_vector(diffeq(x, p, t, bvec, rateiv, cov), x)
        dx_without = as_vector(diffeq(x, p, t, torch.zeros_like(bvec), rateiv, cov), x)
        return x + (dx_with - dx_without).reshape(x.shape)

    return apply


class OccasionSim(NamedTuple):
    """The prediction march's results for every (support, row) cell."""

    pred: torch.Tensor  # [S, R, NO] predicted value at each observation slot
    state: torch.Tensor  # [S, R, NO, nstates] state before the slot's bolus
    y_all: torch.Tensor  # [S, R, NO, nout] every output at each slot


class SegmentMarch:
    """The one segment loop of the general engine, shared by the
    log-likelihood (:func:`simulate_occasion_ll`) and the predictions
    (:func:`simulate_occasion`).

    ``occ``: OccasionArrays of tensors with a leading row axis R; ``p``:
    support points [S, n_params] shared by every row, or with ``per_row``
    one parameter row per occasion row [R, n_params] (one cell per row,
    ``S`` = 1); ``cov_names``: the covariates of ``occ.cov_*``, read by the
    closures through a per-row :class:`~.grid.CovView`. Math of the JAX
    package's ``engine/sim.py::simulate_occasion`` (:94-200): init on
    occasion 0, the seq chain (parameters reset at real events, compound
    across infusion-end sub-splits), lag and fa through the per-support
    segments.
    """

    def __init__(self, spec: ModelSpec, occ: OccasionArrays, p: torch.Tensor,
                 cov_names=(), per_row: bool = False):
        names = tuple(cov_names)
        if per_row:
            p = p.unsqueeze(0)  # [1, R, P]: one cell per row
        lagged = spec.lag is not None or spec.fa is not None
        self.spec, self.occ, self.p, self.names = spec, occ, p, names
        self.per_row = per_row
        self.segs = build_segments(occ, spec.ninput, p, spec.lag, spec.fa, names)
        self.S = p.shape[0]
        self.R = occ.obs_t.shape[0]
        self.sd = sd = 0 if lagged else None  # support axis of the segment streams
        pr = 0 if per_row else None  # row axis of the parameters
        nout = spec.nout

        def out_one(x, pp, t, *knots):
            return as_vector(spec.out(x, pp, t, CovView(*knots, names)), x).reshape(nout)

        self._out_b = self.cells(out_one, (0, 0, sd), (0, pr, 0))
        # the outputs at the observation slots [S, R, NO]: one more inner vmap
        self._out_obs = vmap(vmap(vmap(out_one, in_dims=(0, None, 0, None, None, None)),
                                  in_dims=(0, pr, 0, 0, 0, 0)),
                             in_dims=(0, 0, None, None, None, None))

    def cells(self, fn, s_dims, r_dims):
        """``fn`` vmapped over rows (inner) and supports (outer); the row's
        covariate knots are always its last three arguments."""
        return vmap(vmap(fn, in_dims=r_dims + (0, 0, 0)),
                    in_dims=s_dims + (None, None, None))

    def out(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Every output [S, R, nout] of the states ``x`` [S, R, nstates] at
        the breakpoint times ``t`` ([R] or [S, R])."""
        occ = self.occ
        return self._out_b(x, self.p, t, occ.cov_t, occ.cov_v, occ.cov_fixed)

    def out_at_observations(self, x_obs: torch.Tensor) -> torch.Tensor:
        """Every output [S, R, NO, nout] of the states ``x_obs`` [S, R, NO,
        nstates] at the observation times."""
        occ = self.occ
        return self._out_obs(x_obs, self.p, occ.obs_t.to(x_obs.dtype), occ.cov_t,
                             occ.cov_v, occ.cov_fixed)

    def states(self):
        """Yield ``(m, x)`` for every segment m, ``x`` [S, R, nstates] the
        state at the segment's breakpoint before its bolus (observation
        before dose); when the consumer resumes, the bolus is applied and
        the segment propagated (by the closed form, its prepared split, the
        seq chain's parameters, or the ODE stepper, which carries its cruise
        step from one segment to the next)."""
        spec, occ, segs, p = self.spec, self.occ, self.segs, self.p
        fd, dev = p.dtype, p.device
        names, sd, S, R = self.names, self.sd, self.S, self.R
        per_row = self.per_row
        pr = 0 if per_row else None
        cells = self.cells
        M = segs.t.shape[-1]
        kt, kv, kf = occ.cov_t, occ.cov_v, occ.cov_fixed
        ninput = spec.ninput

        def sr(a):  # a per-(support, row) or per-row [.., R] flag as [S|1, R, 1]
            return (a if a.dim() == 2 else a.unsqueeze(0)).unsqueeze(-1)

        apply_bolus = spec.apply_bolus or default_apply_bolus(spec.nstates)

        def bolus_one(x, bvec, pp, t, rateiv, *knots):
            return apply_bolus(x, bvec, pp, t, rateiv, CovView(*knots, names)).to(fd)

        bolus_b = cells(bolus_one, (0, sd, 0, sd, sd), (0, 0, pr, 0, 0))
        seq = spec.seq
        use_carry = spec.propagate_carry is not None
        use_prepared = spec.prepare is not None and seq is None
        if use_prepared:
            aux = vmap(vmap(spec.prepare))(p) if per_row else vmap(spec.prepare)(p)

            def prop_one(a, x, dt, rateiv, t, *knots):
                return spec.propagate_prepared(a, x, dt, rateiv, t,
                                               CovView(*knots, names)).to(fd)

            prop_b = cells(prop_one, (0, 0, sd, sd, sd), (pr, 0, 0, 0, 0))
        elif not use_carry:
            def prop_one(pp, x, dt, rateiv, t, *knots):
                return spec.propagate(x, pp, dt, rateiv, t, CovView(*knots, names)).to(fd)

            # with seq the parameters are per (support, row): p_seg [S, R, P]
            prop_b = cells(prop_one, (0, 0, sd, sd, sd),
                           (0 if seq is not None or per_row else None, 0, 0, 0, 0))
        if seq is not None:
            def seq_one(pp, t, *knots):
                return as_vector(seq(pp, t, CovView(*knots, names)), pp)

            seq_b = cells(seq_one, (0, sd), (0, 0))
            p_reset = p if per_row else p.unsqueeze(1)
            p_cur = p_reset.expand(S, R, p.shape[-1])

        x = torch.zeros((S, R, spec.nstates), dtype=fd, device=dev)
        if spec.init is not None:
            t_zero = torch.zeros((), dtype=fd, device=dev)

            def init_one(pp, *knots):
                return as_vector(spec.init(pp, t_zero, CovView(*knots, names)),
                                 pp).reshape(spec.nstates)

            x0 = cells(init_one, (0,), (pr,))(p, kt, kv, kf)
            x = x + occ.init_mask.to(fd).view(1, R, 1) * x0
        sc = torch.zeros((S, R), dtype=fd, device=dev)  # carried ODE step
        row_knots = CovView(kt, kv, kf, names)  # every row's, for propagate_carry
        for m in range(M):
            t = segs.t[..., m]
            dt = segs.dt[..., m]
            rateiv = segs.rateiv[..., m, :]
            yield m, x  # observation before bolus (pre-dose state)

            b_amt = segs.b_amt[..., m]
            bvec = torch.nn.functional.one_hot(segs.b_input[..., m], ninput).to(fd)
            bvec = bvec * b_amt.unsqueeze(-1)
            x_dosed = bolus_b(x, bvec, p, t, rateiv, kt, kv, kf)
            x = torch.where(sr(b_amt != 0.0), x_dosed, x)

            has_span = sr(dt > 0.0)
            if use_carry:
                x_prop, sc_new = spec.propagate_carry(x, p, dt, rateiv, t, row_knots, sc)
                sc = torch.where(has_span[..., 0], sc_new, sc)
            elif use_prepared:
                x_prop = prop_b(aux, x, dt, rateiv, t, kt, kv, kf)
            elif seq is not None:
                # p_base resets to the support point at real events and carries
                # across infusion-end sub-splits; spanned segments apply seq at
                # the segment's end (JAX engine/sim.py:374-380)
                p_base = torch.where(sr(segs.is_event[..., m]), p_reset, p_cur)
                p_seg = seq_b(p_base, t + dt, kt, kv, kf)
                p_cur = torch.where(has_span, p_seg, p_base)
                x_prop = prop_b(p_cur, x, dt, rateiv, t, kt, kv, kf)
            else:
                x_prop = prop_b(p, x, dt, rateiv, t, kt, kv, kf)
            x = torch.where(has_span, x_prop, x)


def simulate_occasion(spec: ModelSpec, occ: OccasionArrays, p: torch.Tensor,
                      cov_names=(), per_row: bool = False) -> OccasionSim:
    """Predictions of every row at every support point (or, with
    ``per_row``, of every row under its own parameter row, ``S`` = 1).

    The JAX package's ``engine/sim.py::simulate_occasion`` (:94-200),
    batched: the march of :class:`SegmentMarch` keeps each segment's
    pre-bolus state, the states at the observation slots are gathered
    (``x_pre_all[segs.obs_pos]``; with lag or fa ``obs_pos`` is per support),
    and ``out`` is evaluated there at the observation times.
    """
    march = SegmentMarch(spec, occ, p, cov_names, per_row)
    xs = torch.stack([x for _, x in march.states()], dim=2)  # [S, R, M, n]
    S, R, _, n = xs.shape
    pos = march.segs.obs_pos
    pos = pos.expand((S,) + tuple(pos.shape[-2:]))  # [S, R, NO]
    state = torch.gather(xs, 2, pos.unsqueeze(-1).expand(pos.shape + (n,)))
    y_all = march.out_at_observations(state)  # [S, R, NO, nout]
    idx = occ.obs_outeq.expand(pos.shape).unsqueeze(-1)
    pred = torch.gather(y_all, 3, idx)[..., 0]
    return OccasionSim(pred=pred, state=state, y_all=y_all)


def simulate_occasion_ll(
    spec: ModelSpec,
    occ: OccasionArrays,
    p: torch.Tensor,
    em_kind,
    em_factor,
    em_poly,
    cov_names=(),
) -> torch.Tensor:
    """Fused simulate + log-likelihood of every row at every support point.

    ``occ``, ``p`` and ``cov_names`` as for :class:`SegmentMarch` (supports
    [S, n_params]); ``em_*``: lowered error-model tensors. Returns the
    per-row log-likelihood [S, R]. Math of the JAX package's
    ``engine/sim.py::simulate_occasion_ll`` (:326-399): the per-observation
    log-likelihood accumulates in the march, no state history is kept.
    """
    from ..likelihood.distributions import LOG_2PI
    from ..likelihood.loglik import observation_sigmas

    march = SegmentMarch(spec, occ, p, cov_names)
    segs = march.segs
    fd = p.dtype
    S, R = march.S, march.R

    # per-segment observation payload, scattered to sorted positions
    sigma_obs, active_obs = observation_sigmas(occ, em_kind, em_factor, em_poly)
    pos = segs.obs_pos

    def scatter(base, src):
        return base.scatter(-1, pos, src.expand(pos.shape))

    seg_sigma = scatter(torch.ones_like(segs.t), sigma_obs)
    seg_active = scatter(torch.zeros_like(segs.is_event), active_obs)
    seg_value = scatter(torch.zeros_like(segs.t), occ.obs_value)
    seg_cens = scatter(torch.zeros_like(segs.b_input), occ.obs_cens)
    seg_outeq = scatter(torch.zeros_like(segs.b_input), occ.obs_outeq)

    ll = torch.zeros((S, R), dtype=fd, device=p.device)
    zero = torch.zeros((), dtype=fd, device=p.device)
    for m, x in march.states():
        y_all = march.out(x, segs.t[..., m])  # [S, R, nout]
        idx = seg_outeq[..., m].expand(S, R).unsqueeze(-1)
        pred = torch.gather(y_all, 2, idx)[..., 0]
        sigma = seg_sigma[..., m]
        z = (seg_value[..., m] - pred) / sigma
        ll_none = -0.5 * LOG_2PI - torch.log(sigma) - 0.5 * z * z
        cens = seg_cens[..., m]
        ll_obs = torch.where(
            cens == 1, torch.special.log_ndtr(z),
            torch.where(cens == 2, torch.special.log_ndtr(-z), ll_none),
        )
        ll = ll + torch.where(seg_active[..., m], ll_obs, zero)
    return ll


def _compose_prefix(A: torch.Tensor, b: torch.Tensor) -> tuple:
    """Inclusive prefix compositions of the affine maps ``x -> A_m x + b_m``
    along the segment axis (``A`` [..., M, n, n], ``b`` [..., M, n]): entry m
    of the result applies maps 0..m in order. A log-depth scan
    (Hillis-Steele): ceil(log2 M) rounds, each one batched ``torch.matmul``
    composing every entry with the one ``d`` segments before it."""
    M = A.shape[-3]
    d = 1
    while d < M:
        A_hi, b_hi = A[..., d:, :, :], b[..., d:, :]
        A_lo, b_lo = A[..., :-d, :, :], b[..., :-d, :]
        A = torch.cat([A[..., :d, :, :], torch.matmul(A_hi, A_lo)], dim=-3)
        b = torch.cat([b[..., :d, :],
                       torch.matmul(A_hi, b_lo.unsqueeze(-1))[..., 0] + b_hi], dim=-2)
        d *= 2
    return A, b


def simulate_occasion_assoc(spec: ModelSpec, occ: OccasionArrays, p: torch.Tensor,
                            cov_names=(), per_row: bool = False) -> OccasionSim:
    """Sequence-parallel occasion simulation by a log-depth scan over the
    segments' affine maps (the JAX package's ``engine/sim.py::
    simulate_occasion_assoc``, :205-303, over ``lax.associative_scan``).

    The reference marches segments strictly serially
    (analytical/mod.rs:298-370); this path has no reference counterpart.
    Every closed-form compartment kernel is affine in the state, so a
    segment (bolus add, then propagate over dt with constant infusion
    forcing) is ``x -> A_m x + b_m``. Each segment's map is built from n+1
    applications of the kernel to every (support, row) cell (``c = f(0)``,
    ``A e_j = f(e_j) - c``), then the states before each segment come from
    :func:`_compose_prefix` instead of the serial march. Results as
    :func:`simulate_occasion`.

    Preconditions (``Analytical.with_scan`` checks them): no seq equation
    and the default bolus application, so that the propagator is affine.
    """
    march = SegmentMarch(spec, occ, p, cov_names, per_row)
    segs, p, names, sd = march.segs, march.p, march.names, march.sd
    fd, dev = p.dtype, p.device
    S, R, n = march.S, march.R, spec.nstates
    pr = 0 if per_row else None
    kt, kv, kf = occ.cov_t, occ.cov_v, occ.cov_fixed
    use_prepared = spec.prepare is not None and spec.seq is None
    if use_prepared:
        aux = vmap(vmap(spec.prepare))(p) if per_row else vmap(spec.prepare)(p)

        def prop_one(a, x, dt, rateiv, t, *knots):
            return spec.propagate_prepared(a, x, dt, rateiv, t,
                                           CovView(*knots, names)).to(fd)
    else:
        aux = p

        def prop_one(pp, x, dt, rateiv, t, *knots):
            return spec.propagate(x, pp, dt, rateiv, t, CovView(*knots, names)).to(fd)

    prop_b = march.cells(prop_one, (0, 0, sd, sd, sd), (pr, 0, 0, 0, 0))

    x0 = torch.zeros((S, R, n), dtype=fd, device=dev)
    if spec.init is not None:
        t_zero = torch.zeros((), dtype=fd, device=dev)

        def init_one(pp, *knots):
            return as_vector(spec.init(pp, t_zero, CovView(*knots, names)),
                             pp).reshape(n)

        x0 = x0 + occ.init_mask.to(fd).view(1, R, 1) * march.cells(
            init_one, (0,), (pr,))(p, kt, kv, kf)

    eye = torch.eye(n, dtype=fd, device=dev)
    basis = [torch.zeros((S, R, n), dtype=fd, device=dev)] + [
        eye[j].expand(S, R, n) for j in range(n)]
    M = segs.t.shape[-1]
    As, bs = [], []
    for m in range(M):
        t, dt = segs.t[..., m], segs.dt[..., m]
        rateiv = segs.rateiv[..., m, :]
        # the bolus as an affine offset (input i adds into state i)
        bvec = torch.nn.functional.one_hot(segs.b_input[..., m], spec.ninput).to(fd)
        bvec = bvec * segs.b_amt[..., m].unsqueeze(-1)
        pad = n - spec.ninput
        d = (torch.cat([bvec, bvec.new_zeros(bvec.shape[:-1] + (pad,))], dim=-1)
             if pad > 0 else bvec[..., :n]).expand(S, R, n)
        f = [prop_b(aux, x, dt, rateiv, t, kt, kv, kf) for x in basis]
        c = f[0]
        A = torch.stack([fj - c for fj in f[1:]], dim=-1)  # column j = A e_j
        span = (dt > 0.0).expand(S, R)
        As.append(torch.where(span[..., None, None], A, eye))
        bs.append(torch.where(span[..., None],
                              torch.matmul(A, d.unsqueeze(-1))[..., 0] + c, d))
    Ap, bp = _compose_prefix(torch.stack(As, dim=2), torch.stack(bs, dim=2))
    x_after = torch.matmul(Ap, x0[:, :, None, :, None])[..., 0] + bp  # [S, R, M, n]
    xs = torch.cat([x0.unsqueeze(2), x_after[:, :, :-1]], dim=2)
    pos = segs.obs_pos
    pos = pos.expand((S,) + tuple(pos.shape[-2:]))  # [S, R, NO]
    state = torch.gather(xs, 2, pos.unsqueeze(-1).expand(pos.shape + (n,)))
    y_all = march.out_at_observations(state)
    idx = occ.obs_outeq.expand(pos.shape).unsqueeze(-1)
    pred = torch.gather(y_all, 3, idx)[..., 0]
    return OccasionSim(pred=pred, state=state, y_all=y_all)
