"""Event-grid lowering: Subject timelines -> padded arrays -> sorted segments.

Each occasion is lowered **once** on the host into padded numpy arrays
(``lower_population``, copied from the JAX package so both packages produce
identical rows). ``to_tensors`` moves those rows to the device, and
``build_segments`` sorts every row's breakpoints there, batched over rows.

Breakpoint semantics (parity notes, same as the JAX package):

- sort rank at equal times: infusion-end(0) < Observation(1) < Bolus(2) <
  Infusion(3); ranks 1-3 are "real events" (structs.rs:669-695) and reset the
  secondary-equation parameter vector (analytical/mod.rs:331);
- infusion ends are sub-splits only: they never reset parameters;
- a segment's infusion rate is the sum of rates of infusions that contain
  its midpoint (analytical/mod.rs:337-357) — exact, because every infusion
  start/end is itself a breakpoint;
- observations read the state at their breakpoint *before* any same-time
  bolus is applied (observation sorts first).

Lag and bioavailability shift and scale boluses per support point
(structs.rs:611-666): with either, ``build_segments`` sorts every (support,
row) pair on its own and its streams gain a leading support axis.
Covariates are read by the model closures through :class:`CovView`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import BIG_TIME
from ..data.structs import Occasion, Subject
from ..errors import DataError

# Sort ranks (see module docstring).
RANK_INF_END = 0
RANK_OBSERVATION = 1
RANK_BOLUS = 2
RANK_INFUSION = 3


def _round_up(n: int, multiple: int = 1, minimum: int = 0) -> int:
    n = max(n, minimum)
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


class OccasionArrays(NamedTuple):
    """Padded per-occasion arrays.

    The host lowering fills them with numpy arrays; :func:`to_tensors` gives
    the same tuple of torch tensors on a device. Shapes are for one occasion;
    a leading row axis R is prepended for a population.
    """

    # boluses [NB]
    bolus_t: torch.Tensor
    bolus_amt: torch.Tensor
    bolus_input: torch.Tensor  # int
    # infusions [NI]
    inf_t: torch.Tensor
    inf_dur: torch.Tensor
    inf_amt: torch.Tensor
    inf_input: torch.Tensor  # int
    # observations [NO]
    obs_t: torch.Tensor
    obs_value: torch.Tensor  # observed value; 0.0 where missing
    obs_has_value: torch.Tensor  # bool: value present (missing obs -> False)
    obs_valid: torch.Tensor  # bool: row is a real observation (not padding)
    obs_outeq: torch.Tensor  # int
    obs_cens: torch.Tensor  # int: 0 none, 1 bloq, 2 aloq
    obs_poly: torch.Tensor  # [NO, 4] per-observation errorpoly override
    obs_has_poly: torch.Tensor  # bool
    # covariates [ncov, K]
    cov_t: torch.Tensor
    cov_v: torch.Tensor
    cov_fixed: torch.Tensor  # bool [ncov]
    # scalars
    init_mask: torch.Tensor  # 1.0 iff occasion index == 0 (init() applies)
    occasion_index: torch.Tensor  # int


@dataclass
class LoweredOccasion:
    """Host-side numpy OccasionArrays plus bookkeeping."""

    arrays: OccasionArrays
    subject_id: str
    occasion_index: int
    n_bolus: int
    n_infusion: int
    n_obs: int


class Segments(NamedTuple):
    """Sorted breakpoint segments for a batch of rows, from ``build_segments``.

    M = NO + NB + 2*NI breakpoints per row. Segment ``j`` spans
    ``[t[j], t[j] + dt[j]]``; ``dt`` is 0 for the last real breakpoint and
    all padding.
    """

    t: torch.Tensor  # [R, M] breakpoint times (sorted; padding at BIG_TIME)
    dt: torch.Tensor  # [R, M] span to next breakpoint
    b_amt: torch.Tensor  # [R, M] bolus amount applied at this breakpoint
    b_input: torch.Tensor  # [R, M] bolus input index (0 when unused)
    rateiv: torch.Tensor  # [R, M, ninput] infusion rate during the segment
    is_event: torch.Tensor  # [R, M] bool: real event (resets seq parameters)
    obs_pos: torch.Tensor  # [R, NO] sorted position of each observation slot


# ---------------------------------------------------------------------------
# Host-side lowering
# ---------------------------------------------------------------------------


def lower_occasion(
    occasion: Occasion,
    subject_id: str,
    resolve_input: Callable,
    resolve_output: Callable,
    cov_names: Sequence[str],
    pad_bolus: int,
    pad_infusion: int,
    pad_obs: int,
    pad_knots: int,
) -> LoweredOccasion:
    """Lower one occasion's events into padded numpy arrays.

    ``resolve_input(label, kind)`` / ``resolve_output(label)`` map public
    labels to dense indices (metadata-aware, numeric fallback otherwise) —
    the host-side analogue of equation/mod.rs:195-273.
    """
    fd = np.float64
    boluses = occasion.boluses()
    infusions = occasion.infusions()
    observations = occasion.observations()
    NB, NI, NO = pad_bolus, pad_infusion, pad_obs
    if len(boluses) > NB or len(infusions) > NI or len(observations) > NO:
        raise DataError("padding smaller than event counts")

    bolus_t = np.full(NB, BIG_TIME, dtype=fd)
    bolus_amt = np.zeros(NB, dtype=fd)
    bolus_input = np.zeros(NB, dtype=np.int32)
    for i, b in enumerate(boluses):
        bolus_t[i] = b.time
        bolus_amt[i] = b.amount
        bolus_input[i] = resolve_input(b.input, "bolus")

    inf_t = np.full(NI, BIG_TIME, dtype=fd)
    inf_dur = np.ones(NI, dtype=fd)
    inf_amt = np.zeros(NI, dtype=fd)
    inf_input = np.zeros(NI, dtype=np.int32)
    for i, inf in enumerate(infusions):
        inf_t[i] = inf.time
        inf_dur[i] = inf.duration
        inf_amt[i] = inf.amount
        inf_input[i] = resolve_input(inf.input, "infusion")

    obs_t = np.full(NO, BIG_TIME, dtype=fd)
    obs_value = np.zeros(NO, dtype=fd)
    obs_has_value = np.zeros(NO, dtype=bool)
    obs_valid = np.zeros(NO, dtype=bool)
    obs_outeq = np.zeros(NO, dtype=np.int32)
    obs_cens = np.zeros(NO, dtype=np.int32)
    obs_poly = np.zeros((NO, 4), dtype=fd)
    obs_has_poly = np.zeros(NO, dtype=bool)
    for i, o in enumerate(observations):
        obs_t[i] = o.time
        obs_valid[i] = True
        obs_outeq[i] = resolve_output(o.outeq)
        obs_cens[i] = o.censoring.code()
        if o.value is not None:
            obs_value[i] = o.value
            obs_has_value[i] = True
        if o.errorpoly is not None:
            obs_poly[i] = o.errorpoly
            obs_has_poly[i] = True

    lowered_cov = occasion.covariates.lower(list(cov_names), pad_knots)

    arrays = OccasionArrays(
        bolus_t=bolus_t,
        bolus_amt=bolus_amt,
        bolus_input=bolus_input,
        inf_t=inf_t,
        inf_dur=inf_dur,
        inf_amt=inf_amt,
        inf_input=inf_input,
        obs_t=obs_t,
        obs_value=obs_value,
        obs_has_value=obs_has_value,
        obs_valid=obs_valid,
        obs_outeq=obs_outeq,
        obs_cens=obs_cens,
        obs_poly=obs_poly,
        obs_has_poly=obs_has_poly,
        cov_t=lowered_cov.knot_t,
        cov_v=lowered_cov.knot_v,
        cov_fixed=lowered_cov.fixed,
        init_mask=np.asarray(1.0 if occasion.index == 0 else 0.0, dtype=fd),
        occasion_index=np.asarray(occasion.index, dtype=np.int32),
    )
    return LoweredOccasion(
        arrays=arrays,
        subject_id=subject_id,
        occasion_index=occasion.index,
        n_bolus=len(boluses),
        n_infusion=len(infusions),
        n_obs=len(observations),
    )


@dataclass
class PopulationGrid:
    """Stacked occasion rows for a whole population.

    ``rows`` is an OccasionArrays pytree whose leaves carry a leading row
    axis R (= total occasions across subjects). ``row_subject`` maps each row
    to its subject index for per-subject reductions.
    """

    rows: OccasionArrays
    row_subject: np.ndarray  # [R] int32
    subject_ids: List[str]
    cov_names: List[str]
    n_obs_per_row: np.ndarray  # [R] real (unpadded) observation counts

    @property
    def n_rows(self) -> int:
        return int(self.row_subject.shape[0])

    @property
    def n_subjects(self) -> int:
        return len(self.subject_ids)


def lower_population(
    subjects: Sequence[Subject],
    resolve_input: Callable,
    resolve_output: Callable,
    cov_names: Sequence[str],
    pad_multiple: int = 1,
) -> PopulationGrid:
    """Lower a population into a single stacked PopulationGrid.

    Pads every row to the population maxima. ``pad_multiple`` defaults to 1
    (exact padding — each padded segment costs real FLOPs in the scan);
    raise it when many slightly-different datasets should share a compiled
    executable.
    """
    occs: List[tuple] = []
    for si, subject in enumerate(subjects):
        for occ in subject.occasions():
            occs.append((si, subject.id, occ))
    if not occs:
        raise DataError("population has no occasions")

    NB = _round_up(max(len(o.boluses()) for _, _, o in occs), pad_multiple)
    NI = _round_up(max(len(o.infusions()) for _, _, o in occs), pad_multiple)
    NO = _round_up(max(len(o.observations()) for _, _, o in occs), pad_multiple, minimum=1)
    K = _round_up(
        max(
            (
                max((len(c.observations()) for _, c in o.covariates.items()), default=1)
                for _, _, o in occs
            ),
        ),
        pad_multiple,
        minimum=1,
    )

    # Batch lowering: one pass over every occasion's events into flat
    # streams, then vectorized scatter into the padded [R, N] arrays.
    # Semantics identical to per-occasion lower_occasion (the slow oracle,
    # kept above and equality-tested); ~10x faster on large populations
    # because the per-event work is list appends instead of numpy scalar
    # stores, and there is no per-row array allocation or final stack.
    from ..data.event import Bolus, Infusion

    fd = np.float64
    R = len(occs)
    in_cache: dict = {}
    out_cache: dict = {}

    def rin(label, kind):
        key = (label, kind)
        v = in_cache.get(key)
        if v is None:
            v = in_cache[key] = int(resolve_input(label, kind))
        return v

    def rout(label):
        v = out_cache.get(label)
        if v is None:
            v = out_cache[label] = int(resolve_output(label))
        return v

    b_row, b_slot, b_t, b_amt, b_in = [], [], [], [], []
    i_row, i_slot, i_t, i_dur, i_amt, i_in = [], [], [], [], [], []
    o_row, o_slot, o_t, o_outeq, o_cens = [], [], [], [], []
    ov_row, ov_slot, ov_val = [], [], []
    op_row, op_slot, op_poly = [], [], []
    cov_ts, cov_vs, cov_fx = [], [], []
    init_mask = np.zeros(R, dtype=fd)
    occ_index = np.zeros(R, dtype=np.int32)
    n_obs_per_row = np.zeros(R, dtype=np.int32)
    names = list(cov_names)

    for r, (si, sid, occ) in enumerate(occs):
        nb = ni = no = 0
        for e in occ.events:
            if isinstance(e, Bolus):
                b_row.append(r); b_slot.append(nb)
                b_t.append(e.time); b_amt.append(e.amount)
                b_in.append(rin(e.input, "bolus"))
                nb += 1
            elif isinstance(e, Infusion):
                i_row.append(r); i_slot.append(ni)
                i_t.append(e.time); i_dur.append(e.duration); i_amt.append(e.amount)
                i_in.append(rin(e.input, "infusion"))
                ni += 1
            else:
                o_row.append(r); o_slot.append(no)
                o_t.append(e.time); o_outeq.append(rout(e.outeq))
                o_cens.append(e.censoring.code())
                if e.value is not None:
                    ov_row.append(r); ov_slot.append(no); ov_val.append(e.value)
                if e.errorpoly is not None:
                    op_row.append(r); op_slot.append(no); op_poly.append(e.errorpoly)
                no += 1
        if nb > NB or ni > NI or no > NO:
            raise DataError("padding smaller than event counts")
        n_obs_per_row[r] = no
        init_mask[r] = 1.0 if occ.index == 0 else 0.0
        occ_index[r] = occ.index
        lc = occ.covariates.lower(names, K)
        cov_ts.append(lc.knot_t); cov_vs.append(lc.knot_v); cov_fx.append(lc.fixed)

    bolus_t = np.full((R, NB), BIG_TIME, dtype=fd)
    bolus_amt = np.zeros((R, NB), dtype=fd)
    bolus_input = np.zeros((R, NB), dtype=np.int32)
    bolus_t[b_row, b_slot] = b_t
    bolus_amt[b_row, b_slot] = b_amt
    bolus_input[b_row, b_slot] = b_in

    inf_t = np.full((R, NI), BIG_TIME, dtype=fd)
    inf_dur = np.ones((R, NI), dtype=fd)
    inf_amt = np.zeros((R, NI), dtype=fd)
    inf_input = np.zeros((R, NI), dtype=np.int32)
    inf_t[i_row, i_slot] = i_t
    inf_dur[i_row, i_slot] = i_dur
    inf_amt[i_row, i_slot] = i_amt
    inf_input[i_row, i_slot] = i_in

    obs_t = np.full((R, NO), BIG_TIME, dtype=fd)
    obs_value = np.zeros((R, NO), dtype=fd)
    obs_has_value = np.zeros((R, NO), dtype=bool)
    obs_valid = np.zeros((R, NO), dtype=bool)
    obs_outeq = np.zeros((R, NO), dtype=np.int32)
    obs_cens = np.zeros((R, NO), dtype=np.int32)
    obs_poly = np.zeros((R, NO, 4), dtype=fd)
    obs_has_poly = np.zeros((R, NO), dtype=bool)
    obs_t[o_row, o_slot] = o_t
    obs_valid[o_row, o_slot] = True
    obs_outeq[o_row, o_slot] = o_outeq
    obs_cens[o_row, o_slot] = o_cens
    obs_value[ov_row, ov_slot] = ov_val
    obs_has_value[ov_row, ov_slot] = True
    if op_row:
        obs_poly[op_row, op_slot] = np.asarray(op_poly, dtype=fd)
        obs_has_poly[op_row, op_slot] = True

    rows = OccasionArrays(
        bolus_t=bolus_t,
        bolus_amt=bolus_amt,
        bolus_input=bolus_input,
        inf_t=inf_t,
        inf_dur=inf_dur,
        inf_amt=inf_amt,
        inf_input=inf_input,
        obs_t=obs_t,
        obs_value=obs_value,
        obs_has_value=obs_has_value,
        obs_valid=obs_valid,
        obs_outeq=obs_outeq,
        obs_cens=obs_cens,
        obs_poly=obs_poly,
        obs_has_poly=obs_has_poly,
        cov_t=np.stack(cov_ts, axis=0),
        cov_v=np.stack(cov_vs, axis=0),
        cov_fixed=np.stack(cov_fx, axis=0),
        init_mask=init_mask,
        occasion_index=occ_index,
    )
    return PopulationGrid(
        rows=rows,
        row_subject=np.asarray([si for si, _, _ in occs], dtype=np.int32),
        subject_ids=[s.id for s in subjects],
        cov_names=names,
        n_obs_per_row=n_obs_per_row,
    )


# ---------------------------------------------------------------------------
# Device-side grid construction
# ---------------------------------------------------------------------------

_INT_FIELDS = ("bolus_input", "inf_input", "obs_outeq", "obs_cens",
               "occasion_index")
_BOOL_FIELDS = ("obs_has_value", "obs_valid", "obs_has_poly", "cov_fixed")


def to_tensors(rows: OccasionArrays, device, dtype) -> OccasionArrays:
    """Host numpy rows -> the same OccasionArrays as tensors on ``device``.

    Float fields take ``dtype``; index fields become int64 and flags bool.
    """
    out = {}
    for name, a in zip(OccasionArrays._fields, rows):
        a = np.asarray(a)
        if name in _INT_FIELDS:
            t = torch.as_tensor(a.astype(np.int64))
        elif name in _BOOL_FIELDS:
            t = torch.as_tensor(a.astype(bool))
        else:
            t = torch.as_tensor(a.astype(np.float64)).to(dtype)
        out[name] = t.to(device)
    return OccasionArrays(**out)


class CovView:
    """Covariate interpolation over one row's padded knot tensors.

    The counterpart of the JAX package's ``engine/grid.py::CovView``
    (:124-177), parity with covariate.rs: linear between knots, the first
    value carried backward before the first knot, the last carried forward
    after the last, carry-forward everywhere for fixed covariates. Written
    for one row so that it can be rebuilt from per-row knot tensors inside
    ``torch.func.vmap`` (the engines batch it over rows that way).
    """

    def __init__(self, knot_t, knot_v, fixed, names: Sequence[str]):
        self.knot_t = knot_t  # [ncov, K]
        self.knot_v = knot_v
        self.fixed = fixed  # [ncov] bool
        self.names = list(names)
        self._index = {n: i for i, n in enumerate(self.names)}

    @classmethod
    def empty(cls, dtype=torch.float64, device=None) -> "CovView":
        """A view without covariates: reading one raises DataError."""
        z = torch.zeros((0, 1), dtype=dtype, device=device)
        return cls(z, z, torch.zeros((0,), dtype=torch.bool, device=device), [])

    def index_of(self, name) -> int:
        if isinstance(name, (int, np.integer)):
            return int(name)
        if name not in self._index:
            raise DataError(f"unknown covariate `{name}` (have {self.names})")
        return self._index[name]

    def value(self, name, t):
        """Interpolated value of covariate ``name`` at time ``t``."""
        ci = self.index_of(name)
        ts = self.knot_t[ci]
        vs = self.knot_v[ci]
        K = ts.shape[0]
        t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
        # clamp into the knot range: carries first backward / last forward
        tc = torch.minimum(torch.maximum(t, ts[0]), ts[K - 1])
        # rightmost knot <= tc (searchsorted 'right' - 1)
        idx = torch.clamp((ts <= tc).sum() - 1, 0, K - 1).reshape(1)
        nxt = torch.clamp(idx + 1, max=K - 1)
        t0, t1 = ts.gather(0, idx)[0], ts.gather(0, nxt)[0]
        v0, v1 = vs.gather(0, idx)[0], vs.gather(0, nxt)[0]
        denom = torch.where(t1 > t0, t1 - t0, torch.ones_like(t1))
        lin = torch.where(t1 > t0, v0 + (v1 - v0) * (tc - t0) / denom, v0)
        return torch.where(self.fixed[ci], v0, lin)

    def __call__(self, name, t):
        return self.value(name, t)


def _as_input_vector(value, ninput: int, like: torch.Tensor,
                     fill: float = 0.0) -> torch.Tensor:
    """A lag/fa closure's result as a dense [ninput] vector of ``like``'s
    dtype (JAX ``engine/grid.py:586-603``): a dict {input: value} keeps
    ``fill`` for absent inputs (the reference's HashMap), else a vector of
    length ninput."""
    if value is None:
        value = [fill] * ninput
    elif isinstance(value, dict):
        comps = [fill] * ninput
        for k, v in value.items():
            comps[int(k)] = v
        value = comps
    if isinstance(value, torch.Tensor):
        vec = value.to(like.dtype)
    else:
        vec = torch.stack([torch.as_tensor(c, dtype=like.dtype, device=like.device)
                           for c in value])
    if tuple(vec.shape) != (ninput,):
        raise DataError(f"lag/fa must return a vector of length {ninput}, "
                        f"got {tuple(vec.shape)}")
    return vec


def _per_bolus(fn, p, t, rows: OccasionArrays, ninput: int, fill: float,
               names: Sequence[str]) -> torch.Tensor:
    """``fn(p[s], t[.., r, b], cov_r)`` for every support s, row r and bolus
    slot b, as [S, R, NB, ninput]. ``t`` is [R, NB] or [S, R, NB]; ``p`` is
    [S, P], or [S, R, P] with a parameter row per (support, row) cell."""
    from torch.func import vmap

    def one(pp, tb, kt, kv, kf):
        return _as_input_vector(fn(pp, tb, CovView(kt, kv, kf, names)),
                                ninput, pp, fill)

    over_b = vmap(one, in_dims=(None, 0, None, None, None))
    over_r = vmap(over_b, in_dims=(0 if p.dim() == 3 else None, 0, 0, 0, 0))
    over_s = vmap(over_r, in_dims=(0, 0 if t.dim() == 3 else None,
                                   None, None, None))
    return over_s(p, t, rows.cov_t, rows.cov_v, rows.cov_fixed)


def build_segments(rows: OccasionArrays, ninput: int,
                   p: Optional[torch.Tensor] = None,
                   lag_fn: Optional[Callable] = None,
                   fa_fn: Optional[Callable] = None,
                   cov_names: Sequence[str] = ()) -> Segments:
    """Sorted segment streams for every row of ``rows`` (tensors [R, ...]).

    Without ``lag_fn`` and ``fa_fn`` the segments depend on the data only
    and every stream is [R, ...]. With either (JAX ``engine/grid.py:500-513``)
    they depend on the support points ``p`` [S, P]: lag is evaluated at each
    bolus's original time and shifts it, fa at the shifted time and scales
    its amount, and every stream gains a leading axis S ([S, R, ...]).
    ``p`` may also be [S, R, P], a parameter row per (support, row) cell
    (the per-row mode of ``engine/sim.py::SegmentMarch``, S = 1).
    """
    if lag_fn is None and fa_fn is None:
        return _sorted_segments(rows.obs_t, rows.bolus_t, rows.bolus_amt,
                                rows.bolus_input, rows, ninput)
    S = p.shape[0]
    R, NB = rows.bolus_t.shape
    names = tuple(cov_names)
    real = rows.bolus_t < BIG_TIME / 2
    pick = rows.bolus_input.view(1, R, NB, 1).expand(S, R, NB, 1)
    bolus_t = rows.bolus_t.expand(S, R, NB)
    if lag_fn is not None:
        lag = _per_bolus(lag_fn, p, rows.bolus_t, rows, ninput, 0.0, names)
        shift = lag.gather(3, pick)[..., 0]
        bolus_t = torch.where(real, rows.bolus_t + shift, rows.bolus_t)
    bolus_amt = rows.bolus_amt.expand(S, R, NB)
    if fa_fn is not None:
        fa = _per_bolus(fa_fn, p, bolus_t, rows, ninput, 1.0, names)
        bolus_amt = bolus_amt * fa.gather(3, pick)[..., 0]

    def flat(a):
        return a.expand((S,) + tuple(a.shape)).reshape((S * R,) + tuple(a.shape[1:]))

    flat_rows = rows._replace(inf_t=flat(rows.inf_t), inf_dur=flat(rows.inf_dur),
                              inf_amt=flat(rows.inf_amt),
                              inf_input=flat(rows.inf_input))
    segs = _sorted_segments(flat(rows.obs_t), bolus_t.reshape(S * R, NB),
                            bolus_amt.reshape(S * R, NB), flat(rows.bolus_input),
                            flat_rows, ninput)
    return Segments(*(a.reshape((S, R) + tuple(a.shape[1:])) for a in segs))


def _sorted_segments(obs_t, bolus_t, bolus_amt, bolus_input,
                     rows: OccasionArrays, ninput: int) -> Segments:
    """The breakpoint sort of :func:`build_segments` on rows [R, ...], with
    the (possibly shifted and scaled) boluses given apart.

    The sort reproduces ``jnp.lexsort((ranks, times))`` of the JAX package:
    a stable sort on rank, then a stable sort on time, so equal times keep
    the rank order (observation before bolus).
    """
    fd = bolus_t.dtype
    dev = bolus_t.device
    R, NB = bolus_t.shape
    NI = rows.inf_t.shape[1]
    NO = obs_t.shape[1]
    inf_t = rows.inf_t
    inf_valid = inf_t < BIG_TIME / 2
    inf_end = torch.where(inf_valid, inf_t + rows.inf_dur, inf_t)

    times = torch.cat([obs_t, bolus_t, inf_t, inf_end], dim=1)
    ranks = torch.cat(
        [
            torch.full((R, NO), RANK_OBSERVATION, dtype=torch.int64, device=dev),
            torch.full((R, NB), RANK_BOLUS, dtype=torch.int64, device=dev),
            torch.full((R, NI), RANK_INFUSION, dtype=torch.int64, device=dev),
            torch.full((R, NI), RANK_INF_END, dtype=torch.int64, device=dev),
        ],
        dim=1,
    )
    zeros_o = torch.zeros((R, NO), dtype=fd, device=dev)
    zeros_i = torch.zeros((R, 2 * NI), dtype=fd, device=dev)
    b_amt_unsorted = torch.cat([zeros_o, bolus_amt, zeros_i], dim=1)
    b_input_unsorted = torch.cat(
        [torch.zeros((R, NO), dtype=torch.int64, device=dev),
         bolus_input,
         torch.zeros((R, 2 * NI), dtype=torch.int64, device=dev)],
        dim=1,
    )

    # lexsort((ranks, times)): secondary key first, then a stable primary sort
    o1 = torch.sort(ranks, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(times, 1, o1), dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)
    t_sorted = torch.gather(times, 1, order)
    rank_sorted = torch.gather(ranks, 1, order)
    M = t_sorted.shape[1]

    t_next = torch.cat([t_sorted[:, 1:], t_sorted[:, -1:]], dim=1)
    live = t_next < BIG_TIME / 2
    dt = torch.where(live, torch.clamp(t_next - t_sorted, min=0.0),
                     torch.zeros_like(t_sorted))

    # Per-segment infusion rates: an infusion covers segment j iff the
    # segment midpoint lies in [start, end). The duration floor is the
    # dtype's smallest normal number (1e-300 of the JAX package underflows
    # to 0 in float32).
    tiny = torch.finfo(fd).tiny
    t_mid = t_sorted + dt * 0.5
    rate = torch.where(
        inf_valid, rows.inf_amt / torch.clamp(rows.inf_dur, min=tiny),
        torch.zeros_like(rows.inf_amt),
    )  # [R, NI]
    active = (
        (t_mid[:, None, :] >= inf_t[:, :, None])
        & (t_mid[:, None, :] < inf_end[:, :, None])
        & inf_valid[:, :, None]
    )  # [R, NI, M]
    one_hot = torch.nn.functional.one_hot(rows.inf_input, ninput).to(fd)
    rateiv = torch.einsum("rim,rik->rmk", active.to(fd) * rate[:, :, None],
                          one_hot)

    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(M, device=dev).expand(R, M).contiguous())
    obs_pos = inv[:, :NO]

    return Segments(
        t=t_sorted,
        dt=dt,
        b_amt=torch.gather(b_amt_unsorted, 1, order),
        b_input=torch.gather(b_input_unsorted, 1, order),
        rateiv=rateiv,
        is_event=rank_sorted >= RANK_OBSERVATION,
        obs_pos=obs_pos,
    )
