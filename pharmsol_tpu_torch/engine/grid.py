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

Lag and bioavailability (parameter-dependent breakpoint shifts) are not
ported yet: the segments here depend only on the data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Sequence

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


def build_segments(rows: OccasionArrays, ninput: int) -> Segments:
    """Sorted segment streams for every row of ``rows`` (tensors [R, ...]).

    The sort reproduces ``jnp.lexsort((ranks, times))`` of the JAX package:
    a stable sort on rank, then a stable sort on time, so equal times keep
    the rank order (observation before bolus).
    """
    fd = rows.bolus_t.dtype
    dev = rows.bolus_t.device
    bolus_t = rows.bolus_t
    R, NB = bolus_t.shape
    NI = rows.inf_t.shape[1]
    NO = rows.obs_t.shape[1]
    inf_t = rows.inf_t
    inf_valid = inf_t < BIG_TIME / 2
    inf_end = torch.where(inf_valid, inf_t + rows.inf_dur, inf_t)

    times = torch.cat([rows.obs_t, bolus_t, inf_t, inf_end], dim=1)
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
    b_amt_unsorted = torch.cat([zeros_o, rows.bolus_amt, zeros_i], dim=1)
    b_input_unsorted = torch.cat(
        [torch.zeros((R, NO), dtype=torch.int64, device=dev),
         rows.bolus_input,
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
