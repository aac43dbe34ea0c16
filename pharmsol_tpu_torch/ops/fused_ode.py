"""Fused psi for ODE models: CUDA kernel wrapper, plain twin, dense output.

The population log-likelihood matrix of an ODE model is, per (row, support)
cell, one adaptive explicit Runge-Kutta march over the row's segments: add
the observation term (read before the dose), apply the row's boluses by the
RHS difference, integrate the segment, and cross observation-only
breakpoints of a merged run with dense output instead of stopping there.

- :func:`psi_ode` is the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/fused_ode.cu``, built at first use with the
  model's generated RHS (:mod:`.rhs_codegen`, :mod:`._build`): K2a, or K2e
  when the call has any feature input (covariates, init, lag, fa). It raises
  if the build or the launch fails; on a CPU tensor it runs the plain twin.
- :func:`psi_ode_plain` is that twin: the explicit tier of the JAX package's
  ``ops/pallas_ode.py::psi_ode`` (``integrate``, :708) and its feature tier
  (covariate lanes through :class:`LaneCov`, init, the lag/fa split march
  with slot tables, :1614-1807) in plain PyTorch on ``[R, S]`` lanes, with a
  masked loop that ends when every lane is done. It calls the user's closure
  directly. The CPU tests hold it against the JAX kernel in interpret mode;
  ``chip_smoke.py`` holds the CUDA kernel against it on the card.

What the march does, as the JAX kernel: the I-controller with growth clamped
to [0.2, 5]; the Hairer-Norsett-Wanner starting step on the first run (with
lag, on its first pass only), floored at ``h0``; the last controller step
carried into the next run; the stall guard and NaN poisoning of a lane that
runs out of steps (-inf cells); lanes that arrive non-finite stay dead;
observations captured from the tableau's quartic interpolant at ``T_eff =
min(T, target - 1e-6 target)``, zero-offset ones at the run's start. With
lag, each bolus plane holds one pending dose: doses due at a breakpoint fire
after its observation, new doses park with their lag, and the segment is
marched in one pass per bolus plane to the next fire time (equal times fire
together), then to its end. Censored observations use the exact log of the
normal CDF (the TPU kernel's was approximate). Unlike the TPU kernel there is
no padding: R, S and M are free.

With ``solver='expm'`` (kernel K2d; the JAX kernel's ``integrate_expm``,
:1152) a pass is no step loop but one exact propagation of an RHS affine in
the state and autonomous within the pass, ``x' = A x + u``: ``u`` is the RHS
at the zero state, ``A``'s columns its forward-mode tangents there (the twin
by ``torch.func.jvp`` of the closure, the kernel by the generated
``rhs_jvp``), both scaled by the pass length; the exponential of the block
``[[A, u], [0, 0]]`` by a Taylor-13 Horner chain after scaling by ``2^-s``,
``s = ceil(max(log2 norm, 0))``, then ``s`` squarings per lane; a lane with
``s > 16`` or a non-finite result is NaN (a -inf cell). Runs are never merged,
nothing is carried between passes, and the lag/fa split, covariates (constant
within a pass) and init are the feature tier's own.

Stream layout: ``seg_dt``, the observation streams and ``seg_t0`` are
[R, M]; ``seg_bolus`` is [nb, R, M], one plane per active bolus input
(``bolus_inputs`` names the RHS input of each); ``seg_rateiv`` [nr, R, M]
likewise (``rate_inputs``) or None; support [S, P]; output coefficients
[n_out, n_states, S] and biases [n_out, S] or None. The feature inputs are
described by :class:`Features`. The result is [R, S].
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine.ode import (
    _BDF_ALPHA,
    _BDF_ERROR_CONST,
    _BDF_GAMMA,
    _EXPM_SQUARINGS,
    _EXPM_TAYLOR,
    BDF_MAX_ORDER,
    SDIRK_TABLEAUS,
    TABLEAUS,
)
from .rhs_codegen import LaneCov

LOG_2PI = math.log(2.0 * math.pi)

# Kernel launches through psi_ode on a CUDA tensor (not the twin): K2a,
# K2e (the feature tier: covariates, init, lag, fa), and K2d (the exact
# propagation tier, ``solver='expm'``, with or without features).
LAUNCHES = 0
FEATURE_LAUNCHES = 0
EXPM_LAUNCHES = 0
# K2b (the SDIRK tier: trbdf2, kvaerno3/esdirk34, kvaerno5) and K2c (the BDF
# tier), with or without features.
SDIRK_LAUNCHES = 0
BDF_LAUNCHES = 0

# The kernel's solver codes (csrc/fused_ode.cu); esdirk34 is kvaerno3.
SOLVER_CODES = {"dopri5": 0, "tsit5": 1, "expm": 2, "trbdf2": 3, "kvaerno3": 4,
                "esdirk34": 4, "kvaerno5": 5, "bdf": 6}
# The solvers whose march needs the RHS's Jacobian columns (rhs_jvp).
JACOBIAN_SOLVERS = ("expm", "trbdf2", "kvaerno3", "esdirk34", "kvaerno5", "bdf")
# The order cap of the BDF tier unless the caller says otherwise: the JAX
# kernel's own default, so that the fused psi of the two packages agree.
BDF_DEFAULT_MAX_ORDER = 3
_BDF_MAX_GROWTH = 10.0

# The explicit and implicit tiers (K2a, K2e; K2b, K2c) run a persistent grid:
# blocks of EXPLICIT_THREADS or IMPLICIT_THREADS threads, as many as the card
# holds at once (the library's occupancy query, :func:`explicit_occupancy_of`,
# :func:`implicit_occupancy_of`), and each lane marches its cells one after
# the other, :func:`implicit_lane_cell` giving which.
EXPLICIT_THREADS = IMPLICIT_THREADS = 128


def implicit_lane_cell(g, k, lanes):
    """The k-th cell that lane ``g`` of a persistent grid of ``lanes`` lanes
    marches, as ``csrc/fused_ode.cu::CellWalk`` walks them: pass k covers the
    cells [k lanes, (k + 1) lanes), one a lane, rotated by one warp a pass, so
    that a lane does not meet the same row in every pass where ``lanes`` is a
    multiple of R. Cells are support-major: cell c is row ``c % R`` of
    support ``c // R`` (:func:`implicit_cell`). Works elementwise on numpy
    arrays; a cell past R S is no cell (the lane is done)."""
    return k * lanes + (g + 32 * k) % lanes


def implicit_cell(c, R: int):
    """(row, support) of cell ``c`` of the implicit tiers' walk over R rows."""
    return c % R, c // R


def _occupancy_query(path, symbol: str):
    """The library's occupancy export ``symbol`` as a function of its three
    int arguments returning resident blocks per SM, or None where the library
    has no such export."""
    fn = getattr(ctypes.CDLL(str(path)), symbol, None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def query(*args) -> int:
        blocks = ctypes.c_int(0)
        err = fn(*(int(v) for v in args), ctypes.addressof(blocks))
        if err != 0:
            raise RuntimeError(f"{symbol} failed with CUDA error {err}")
        return blocks.value

    return query


def implicit_occupancy_of(path):
    """The occupancy query of the implicit tiers' library at ``path`` as a
    function ``(is_f64, feature, cap) -> resident blocks per SM`` of the
    kernel instantiation the library launches for those (``cap``: the BDF
    order cap; ignored by K2b), or None for a library without one (the
    explicit and exact tiers')."""
    return _occupancy_query(path, "fused_ode_occupancy")


def explicit_occupancy_of(path):
    """The occupancy query of the explicit tier's library at ``path`` as a
    function ``(is_f64, feature, solver_code) -> resident blocks per SM`` of
    K2a (``feature`` false) or K2e with dopri5 (code 0) or tsit5 (1), or None
    for a library without one (the implicit and exact tiers')."""
    query = _occupancy_query(path, "fused_ode_explicit_occupancy")
    if query is None:
        return None
    return lambda is_f64, feature, code: query(is_f64, code, feature)


def implicit_lanes(n_cells: int, blocks: int) -> int:
    """The lanes of the implicit tiers' grid for ``n_cells`` cells and a grid
    of at most ``blocks`` blocks (no block without a cell)."""
    return min(blocks, -(-n_cells // IMPLICIT_THREADS)) * IMPLICIT_THREADS


def bdf_U():
    """R(1), the involutory backward-difference transform, as 6 x 6 floats
    (row 0 ones, column 0 zero below it): the constant table of the BDF
    tier's difference-array rescaling."""
    K = BDF_MAX_ORDER + 1
    U = np.zeros((K, K))
    U[0, :] = 1.0
    for i in range(1, K):
        for j in range(1, K):
            U[i, j] = U[i - 1, j] * ((i - 1.0 - j) / i)
    return U


_BDF_U = bdf_U()

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


class Features(NamedTuple):
    """The feature inputs of one call, validated (:func:`_check_inputs`).

    ``cov``: (name, a [R, M], b [R, M] or None) per covariate in the RHS's
    order (a constant covariate's value sits in column 0 of ``a``);
    ``lag``/``fa``: lists of [R, S] planes or None, selected per (bolus
    plane, segment) by ``lag_slots``/``fa_slots`` ([nb][M] tables, -1 = no
    dose there) or, without a table, one plane per bolus plane;
    ``init_rows`` [N, S] or ``init_planes`` [N, R, S] with ``init_mask``
    [R] (1 on occasion-0 rows)."""

    cov: tuple = ()
    lag: Optional[list] = None
    fa: Optional[list] = None
    lag_slots: Optional[tuple] = None
    fa_slots: Optional[tuple] = None
    init_rows: Optional[torch.Tensor] = None
    init_planes: Optional[torch.Tensor] = None
    init_mask: Optional[torch.Tensor] = None

    @property
    def any(self) -> bool:
        return bool(self.cov) or self.lag is not None or self.fa is not None \
            or self.init_mask is not None

    def lag_src(self, k: int, m: int):
        """The lag plane of bolus plane k's dose at segment m, or None."""
        if self.lag_slots is not None:
            si = self.lag_slots[k][m]
            return None if si < 0 else self.lag[si]
        return self.lag[k]

    def fa_src(self, k: int, m: int):
        """The fa plane scaling bolus plane k at segment m, or None."""
        if self.fa is None:
            return None
        if self.fa_slots is not None:
            si = self.fa_slots[k][m]
            return None if si < 0 else self.fa[si]
        return self.fa[k]


def _plane_list(planes, slots, nb: int, M: int, R: int, S: int, what: str):
    """Normalise a lag/fa argument (JAX ``psi_ode`` :2056-2087): one [R, S]
    plane per bolus plane, or the slot-indexed list its table selects."""
    if planes is None:
        return None, None
    if isinstance(planes, torch.Tensor):
        lst = [planes] if planes.dim() == 2 else list(planes.unbind(0))
    else:
        lst = list(planes)
    if slots is None:
        expect = nb
    else:
        slots = tuple(tuple(int(v) for v in row) for row in slots)
        if len(slots) != nb or any(len(row) != M for row in slots):
            raise ValueError(f"{what} slots must be [{nb}][{M}] (bolus plane x segment)")
        expect = max(max(row) for row in slots) + 1
    if len(lst) != expect:
        raise ValueError(f"{what} carries {len(lst)} planes, expected {expect}")
    for pl in lst:
        if tuple(pl.shape) != (R, S):
            raise ValueError(f"{what} must be [R, S] = [{R}, {S}], got {list(pl.shape)}")
    return lst, slots


def check_features(gen, shapes: dict, R: int, M: int, S: int, nb: int, cov_streams,
                   cov_names, init_rows, init_planes, init_mask, lag, fa, lag_slots,
                   fa_slots, plane_names=("lag_planes", "fa_planes")) -> Features:
    """Validate the feature inputs of the ODE or SDE kernel against the
    generated closures ``gen`` (their ``cov_names``/``cov_modes``) and return
    them as :class:`Features`; adds each array with its expected shape to
    ``shapes`` for the caller's shape, dtype and device checks."""
    N = gen.n_states
    cov_names = tuple(str(n) for n in cov_names)
    if cov_names != tuple(gen.cov_names):
        raise ValueError(f"cov_names {cov_names} differ from the RHS's (the generated "
                         f"closures') {tuple(gen.cov_names)}")
    cov = []
    for name, mode in zip(cov_names, gen.cov_modes):
        entry = (cov_streams or {}).get(name)
        if entry is None:
            raise ValueError(f"cov_streams has no stream for covariate `{name}`")
        if isinstance(entry, tuple) != (mode == "affine"):
            raise ValueError(f"covariate `{name}` is `{mode}` in the closures: pass "
                             + ("an (a, b) pair" if mode == "affine" else "one [R, M] stream"))
        ca, cb = entry if isinstance(entry, tuple) else (entry, None)
        shapes[f"cov {name} a"] = (ca, (R, M))
        shapes[f"cov {name} b"] = (cb, (R, M))
        cov.append((name, ca, cb))
    if init_rows is not None and init_planes is not None:
        raise ValueError("pass init_rows OR init_planes, not both")
    if (init_rows is not None or init_planes is not None) != (init_mask is not None):
        raise ValueError("init_rows / init_planes and init_mask go together")
    shapes["init_rows"] = (init_rows, (N, S))
    shapes["init_planes"] = (init_planes, (N, R, S))
    shapes["init_mask"] = (init_mask, (R,))
    lag, lag_slots = _plane_list(lag, lag_slots, nb, M, R, S, plane_names[0])
    fa, fa_slots = _plane_list(fa, fa_slots, nb, M, R, S, plane_names[1])
    for what, lst in zip(plane_names, (lag, fa)):
        for i, pl in enumerate(lst or ()):
            shapes[f"{what} {i}"] = (pl, (R, S))
    return Features(tuple(cov), lag, fa, lag_slots, fa_slots, init_rows, init_planes,
                    init_mask)


def _check_inputs(seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value,
                  obs_sigma, obs_cens, seg_t0, support, rhs, obs_outeq,
                  out_coef, out_bias, bolus_inputs, rate_inputs, merge_runs,
                  solver, cov_streams=None, cov_names=(), init_rows=None,
                  init_planes=None, init_mask=None, lag_plane=None,
                  fa_plane=None, lag_slots=None, fa_slots=None):
    """Validate the layout (the JAX wrapper's checks, :2056-2131); returns
    (n_out, runs, features) with ``runs`` the (m0, m1) spans tiling [0, M)
    and ``features`` a :class:`Features`."""
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

    feats = check_features(rhs, shapes, R, M, S, nb, cov_streams, cov_names, init_rows,
                           init_planes, init_mask, lag_plane, fa_plane, lag_slots,
                           fa_slots, ("lag_plane", "fa_plane"))
    lag = feats.lag

    for name, (arr, shape) in shapes.items():
        if arr is not None and tuple(arr.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(arr.shape)}")
    for name, arr in dict(seg_dt=seg_dt, support=support,
                          **{k: v for k, (v, _) in shapes.items()}).items():
        if arr is None:
            continue
        if arr.dtype != dtype or arr.device != dev:
            raise ValueError(f"{name} is {arr.dtype} on {arr.device}; expected {dtype} on {dev}")
        if not arr.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_out > 1 and obs_outeq is None:
        raise ValueError("obs_outeq stream required for multi-output psi")
    if solver in JACOBIAN_SOLVERS and not rhs.jacobian:
        raise ValueError(f"solver `{solver}` needs an RHS generated with jacobian=True")
    if merge_runs is None:
        runs = tuple((m, m + 1) for m in range(M))
    else:
        if solver == "expm":
            raise ValueError("expm never merges (each capture costs a full propagation)")
        if solver == "bdf":
            raise ValueError("bdf never merges (it has no dense-output interpolant)")
        if solver in SDIRK_TABLEAUS and SDIRK_TABLEAUS[solver]["order"] > 3.0:
            raise ValueError(f"{solver} never merges (the cubic Hermite capture is "
                             "order-matched for the 2nd and 3rd order pairs only)")
        if lag is not None:
            raise ValueError("merge_runs is incompatible with lag planes")
        runs = tuple((int(a), int(b)) for a, b in merge_runs)
        flat = [0]
        for a, b in runs:
            if a != flat[-1] or b <= a:
                raise ValueError(f"merge_runs must tile [0, {M}) consecutively, got {runs}")
            flat.append(b)
        if flat[-1] != M:
            raise ValueError(f"merge_runs must cover all {M} segments, got {runs}")
    return n_out, runs, feats


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------


def psi_ode_plain(
    seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
    seg_t0, support, rhs, *, obs_outeq=None, out_coef=None, out_bias=None,
    bolus_inputs=(0,), rate_inputs=(0,), merge_runs=None, solver="dopri5",
    rtol=1e-4, atol=1e-4, h0=1e-3, max_steps=10_000, cov_streams=None,
    cov_names=(), init_rows=None, init_planes=None, init_mask=None,
    lag_plane=None, fa_plane=None, lag_slots=None, fa_slots=None, counts=None,
    newton_iters=6, bdf_max_order=BDF_DEFAULT_MAX_ORDER,
):
    """Plain PyTorch twin of the fused ODE psi kernel (same arguments as
    :func:`psi_ode`), on ``[R, S]`` lanes. A ``counts`` dict receives the
    number of step attempts over all cells (``"steps"``, and per row
    ``"steps_by_row"`` [R]; every adaptive solver; per march call, in the
    order of the calls, ``"trials_by_call"``, a list of int64 [R, S] tensors
    holding each lane's attempts in that call; with ``solver='bdf'`` also
    ``"bdf_by_row"``, int64 [R, 5, 6]: per row and order k the trials, the
    accepted steps and the order adaptations at order k, and the rescalings of
    the difference array that the kernel performs, for the clip at order k
    and for a step factor other than 1 at the new order k) or, with
    ``solver='expm'``, of exact propagations (``"passes"``) and of the
    squarings they took (``"squarings"``): the work this data needs, for the
    kernel's bound."""
    from ..engine.sim import as_components

    n_out, runs, ft = _check_inputs(
        seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma,
        obs_cens, seg_t0, support, rhs, obs_outeq, out_coef, out_bias,
        bolus_inputs, rate_inputs, merge_runs, solver, cov_streams, cov_names,
        init_rows, init_planes, init_mask, lag_plane, fa_plane, lag_slots, fa_slots)
    use_expm = solver == "expm"
    A, B, E, C = TABLEAUS[solver if solver in TABLEAUS else "dopri5"]
    dense_P = dense_P_for(solver)
    if not 1 <= int(bdf_max_order) <= BDF_MAX_ORDER:
        raise ValueError(f"bdf_max_order must lie in 1..{BDF_MAX_ORDER}, got {bdf_max_order}")
    n_stages = len(C)
    N, nin = rhs.n_states, rhs.ninput
    R, M = seg_dt.shape
    S = support.shape[0]
    nb = len(bolus_inputs)
    dtype, dev = seg_dt.dtype, seg_dt.device
    shape = (R, S)
    zeros = torch.zeros(shape, dtype=dtype, device=dev)
    nan = torch.full(shape, float("nan"), dtype=dtype, device=dev)
    p_lanes = [support[:, i].reshape(1, S).expand(shape) for i in range(rhs.n_params)]
    coefs = [[out_coef[k, i].reshape(1, S) for i in range(N)] for k in range(n_out)]
    biases = ([out_bias[k].reshape(1, S) for k in range(n_out)]
              if out_bias is not None else None)
    diffeq = rhs.diffeq
    has_lag = ft.lag is not None

    # covariate lanes: per-row constants once, affine (a, b) per segment
    const_lanes = {name: a[:, 0:1] for name, a, b in ft.cov if b is None}

    def cov_for(m):
        lanes = dict(const_lanes)
        for name, a, b in ft.cov:
            if b is not None:
                lanes[name] = (a[:, m:m + 1], b[:, m:m + 1])
        return LaneCov(lanes)

    def f(xs, t, rate, cov, b=None):
        bl = [zeros] * nin
        if b is not None:
            bl[b[0]] = b[1]
        out = diffeq(list(xs), p_lanes, t.expand(shape), bl, rate, cov)
        return as_components(out, N, shape, dtype, dev)

    def dose(xs, j, amt, t, rate, cov):
        """The RHS difference (ode/mod.rs:644-687), as the general engine."""
        d_w = f(xs, t, rate, cov, (j, amt.expand(shape)))
        d_o = f(xs, t, rate, cov)
        return [x + (w - o) for x, w, o in zip(xs, d_w, d_o)]

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

    def integrate(xs, h, dt_col, rate, t0_col, estimate_h, interior, cov):
        begin_call()
        target = dt_col.expand(shape)
        live0 = target > 0.0
        for s in range(N):
            live0 = live0 & torch.isfinite(xs[s])
        k1_0 = f(xs, t0_col, rate, cov)
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
            f1 = f(x1, t0_col + h0a, rate, cov)
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
            count_trials(live)
            rem = target - tau
            h_try = torch.minimum(h_c, torch.clamp(rem, min=1e-14))
            ks = [k1]
            for i in range(1, n_stages):
                xi = [xs_c[s] + h_try * _wsum([ks[j][s] for j in range(i)], A[i])
                      for s in range(N)]
                ks.append(f(xi, t0_col + tau + C[i] * h_try, rate, cov))
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

    def integrate_expm(xs, h, dt_col, rate, t0_col, estimate_h, interior, cov):
        """Exact propagation of an affine, autonomous RHS over one pass (JAX
        ``integrate_expm``, ops/pallas_ode.py:1152): ``u = f(0)``, ``A`` by
        forward-mode columns at 0, the Taylor-13 Horner chain on the scaled
        block ``[[A, u], [0, 0]]`` in (P, q) form, then each lane's own count
        of squarings (masked; the loop runs to the largest count, at most
        16). Lanes past the squaring budget or non-finite are NaN; ``dt ==
        0`` lanes are untouched."""
        assert not interior, "expm never merges"
        target = dt_col.expand(shape)
        t_base = t0_col + zeros
        zs = tuple(zeros for _ in range(N))
        u = f(list(zs), t_base, rate, cov)
        ones = torch.ones_like(zeros)
        cols = []
        for j in range(N):
            tangent = tuple(ones if s == j else zeros for s in range(N))
            _, jv = torch.func.jvp(
                lambda *x: tuple(c + zeros for c in f(list(x), t_base, rate, cov)), zs, tangent)
            cols.append(list(jv))
        Adt = [[cols[j][i] * target for j in range(N)] for i in range(N)]
        udt = [u[i] * target for i in range(N)]
        norm = None
        for i in range(N):
            row = torch.abs(udt[i])
            for j in range(N):
                row = row + torch.abs(Adt[i][j])
            norm = row if norm is None else torch.maximum(norm, row)
        norm = torch.clamp(norm, min=1e-30)
        s_cnt = torch.ceil(torch.clamp(torch.log2(norm), min=0.0))
        sc = torch.exp2(-s_cnt)
        As = [[Adt[i][j] * sc for j in range(N)] for i in range(N)]
        us = [udt[i] * sc for i in range(N)]

        def dot(a, b):
            acc = a[0] * b[0]
            for l in range(1, N):
                acc = acc + a[l] * b[l]
            return acc

        def mm(X, Y):
            return [[dot(X[i], [Y[l][j] for l in range(N)]) for j in range(N)]
                    for i in range(N)]

        def mv(X, v):
            return [dot(X[i], v) for i in range(N)]

        inv_d = 1.0 / float(_EXPM_TAYLOR)
        P = [[As[i][j] * inv_d + (1.0 if i == j else 0.0) for j in range(N)]
             for i in range(N)]
        q = [us[i] * inv_d for i in range(N)]
        for d in range(_EXPM_TAYLOR - 1, 0, -1):
            inv = 1.0 / float(d)
            AP, Aq = mm(As, P), mv(As, q)
            P = [[AP[i][j] * inv + (1.0 if i == j else 0.0) for j in range(N)]
                 for i in range(N)]
            q = [(Aq[i] + us[i]) * inv for i in range(N)]
        live = target > 0.0
        counted = torch.where(live & torch.isfinite(s_cnt), s_cnt, zeros)
        n_sq = int(min(float(counted.max()), float(_EXPM_SQUARINGS))) if counted.numel() else 0
        if counts is not None:
            counts["passes"] = counts.get("passes", 0) + int(live.sum())
            counts["squarings"] = counts.get("squarings", 0) + int(
                torch.clamp(counted, max=float(_EXPM_SQUARINGS)).sum())
        for it_sq in range(n_sq):
            on = s_cnt > float(it_sq)
            PP, Pq = mm(P, P), mv(P, q)
            P = [[torch.where(on, PP[i][j], P[i][j]) for j in range(N)] for i in range(N)]
            q = [torch.where(on, Pq[i] + q[i], q[i]) for i in range(N)]
        Px = mv(P, list(xs))
        xs_new = [Px[i] + q[i] for i in range(N)]
        bad = ~(s_cnt <= float(_EXPM_SQUARINGS))
        for i in range(N):
            bad = bad | ~torch.isfinite(xs_new[i])
        xs_out = [torch.where(live, torch.where(bad, nan, xn), x)
                  for xn, x in zip(xs_new, xs)]
        return xs_out, h, []

    def lane_jacobian(xs_c, t_base, rate, cov):
        """J[i][j] = df_i/dx_j on every lane: one forward-mode pass of the
        closure per unit vector (the kernel calls the generated rhs_jvp)."""
        ones = torch.ones_like(zeros)
        cols = []
        for j in range(N):
            tangent = tuple(ones if s == j else zeros for s in range(N))
            _, jv = torch.func.jvp(
                lambda *x: tuple(c + zeros for c in f(list(x), t_base, rate, cov)),
                tuple(x + zeros for x in xs_c), tangent)
            cols.append(list(jv))
        return [[cols[j][i] for j in range(N)] for i in range(N)]

    def lane_inverse(Mx):
        """Inverse of an N x N matrix of lanes by Gauss-Jordan without
        pivoting, the diagonal clamped at 1e-30 (JAX ``_lane_inverse``,
        :339): the iteration matrix has a dominant positive diagonal for
        compartment kinetics, and a singular lane gives garbage that the
        Newton residual check rejects."""
        aug = [[Mx[i][j] for j in range(N)]
               + [torch.full_like(zeros, 1.0 if j == i else 0.0) for j in range(N)]
               for i in range(N)]
        for k in range(N):
            d = aug[k][k]
            d = torch.where(torch.abs(d) > 1e-30, d, torch.full_like(d, 1e-30))
            inv_d = 1.0 / d
            aug[k] = [e * inv_d for e in aug[k]]
            for i in range(N):
                if i == k:
                    continue
                factor = aug[i][k]
                aug[i] = [e_i - factor * e_k for e_i, e_k in zip(aug[i], aug[k])]
        return [row[N:] for row in aug]

    def matvec(Mx, v):
        out = []
        for i in range(N):
            acc = Mx[i][0] * v[0]
            for j in range(1, N):
                acc = acc + Mx[i][j] * v[j]
            out.append(acc)
        return out

    def begin_call():
        # each march call's trials per (row, support) lane
        if counts is not None:
            counts.setdefault("trials_by_call", []).append(
                torch.zeros(shape, dtype=torch.int64, device=dev))

    def count_trials(live):
        if counts is not None:
            per_row = live.sum(dim=1)
            counts["steps"] = counts.get("steps", 0) + int(per_row.sum())
            counts["steps_by_row"] = counts.get("steps_by_row", 0) + per_row
            counts["trials_by_call"][-1] += live

    def count_bdf(kind, mask, order_l):
        # kind: 0 trials, 1 accepts, 2 adaptations, 3 clip and 4 factor rescalings
        tally = counts.setdefault("bdf_by_row", torch.zeros(
            (R, 5, BDF_MAX_ORDER + 1), dtype=torch.int64, device=dev))
        for k in range(1, BDF_MAX_ORDER + 1):
            tally[:, kind, k] += (mask & (order_l > k - 0.5) & (order_l < k + 0.5)).sum(dim=1)

    def integrate_sdirk(xs, h, dt_col, rate, t0_col, estimate_h, interior, cov):
        """Adaptive SDIRK march over one run (JAX ``integrate_sdirk``,
        ops/pallas_ode.py:949): the first stage explicit; each later stage a
        Newton iteration on ``I - h gamma J`` with J frozen at the step's
        start and inverted once per trial; a step whose Newton residual
        stays above 0.1 (WRMS) or whose state jumps more than tenfold is
        rejected. Interior observations of a merged run are captured by the
        cubic Hermite on (x0, f0, x1, f1): these 2nd and 3rd order pairs are
        stiffly accurate, so the last stage slope is f(x_new). No starting
        step estimate: ``estimate_h`` is unused."""
        tab = SDIRK_TABLEAUS[solver]
        sA, sB, sBHAT, sC = tab["A"], tab["B"], tab["BHAT"], tab["C"]
        gamma, order, max_growth = tab["gamma"], tab["order"], tab["max_growth"]
        ns = len(sC)
        begin_call()
        target = dt_col.expand(shape)
        # a lane that arrives non-finite must not march: every trial would
        # reject and, at tau = 0, the stall guard could never fire
        live0 = target > 0.0
        for s in range(N):
            live0 = live0 & torch.isfinite(xs[s])
        t_end_eff = target - 1e-6 * torch.clamp(target, min=1e-30)
        n_int = len(interior) if interior else 0
        if n_int:
            T_eff = [torch.minimum(Tj.expand(shape), t_end_eff) for Tj, _ in interior]
            start = [out_k(k, xs) for k in range(n_out)]
            preds = [torch.where(Tj.expand(shape) <= 0.0, sel_out(oe, start), zeros)
                     for Tj, oe in interior]
        tau = zeros
        xs_c = [x + zeros for x in xs]
        h_c = torch.minimum(h, torch.clamp(target, min=1e-14))
        live = live0
        it = 0
        while it < max_steps and bool(live.any()):
            count_trials(live)
            rem = target - tau
            h_try = torch.minimum(h_c, torch.clamp(rem, min=1e-14))
            t_base = t0_col + tau
            J = lane_jacobian(xs_c, t_base, rate, cov)
            Minv = lane_inverse([[(1.0 if i == j else 0.0) - h_try * gamma * J[i][j]
                                  for j in range(N)] for i in range(N)])
            ks = [f(xs_c, t_base, rate, cov)]
            resid_max = zeros
            for i in range(1, ns):
                base = [xs_c[s] + h_try * _wsum([ks[j][s] for j in range(i)], sA[i][:i])
                        for s in range(N)]
                t_st = t_base + sC[i] * h_try
                z = [b + h_try * gamma * k for b, k in zip(base, ks[i - 1])]
                for _ in range(newton_iters):
                    fz = f(z, t_st, rate, cov)
                    F = [zz - bb - h_try * gamma * ff for zz, bb, ff in zip(z, base, fz)]
                    z = [zz - dz for zz, dz in zip(z, matvec(Minv, F))]
                fz = f(z, t_st, rate, cov)
                r2 = zeros
                for s in range(N):
                    Fs = z[s] - base[s] - h_try * gamma * fz[s]
                    sc = atol + rtol * torch.abs(z[s])
                    r2 = r2 + (Fs / sc) ** 2
                resid_max = torch.maximum(resid_max, torch.sqrt(r2 / float(N)))
                ks.append(fz)
            xs_new = [x + h_try * _wsum([k[s] for k in ks], sB) for s, x in enumerate(xs_c)]
            err2 = zeros
            for s in range(N):
                e = h_try * (_wsum([k[s] for k in ks], sB) - _wsum([k[s] for k in ks], sBHAT))
                sc = atol + rtol * torch.maximum(torch.abs(xs_c[s]), torch.abs(xs_new[s]))
                err2 = err2 + (e / sc) ** 2
            ratio = torch.sqrt(err2 / float(N))
            finite = torch.isfinite(ratio) & (resid_max <= 0.1)
            growth = xmax = zeros
            for s in range(N):
                finite = finite & torch.isfinite(xs_new[s])
                growth = torch.maximum(growth, torch.abs(xs_new[s] - xs_c[s]))
                xmax = torch.maximum(xmax, torch.abs(xs_c[s]))
            # a tenfold jump of the state is a spurious Newton root
            finite = finite & (growth <= 10.0 * (1.0 + xmax))
            accept = live & (ratio <= 1.0) & finite
            factor = torch.where(
                finite,
                torch.clamp(0.9 * torch.pow(torch.clamp(ratio, min=1e-10),
                                            -1.0 / (order + 1.0)), 0.2, max_growth),
                torch.full_like(ratio, 0.25))
            tau_n = torch.where(accept, tau + h_try, tau)
            xs_n = [torch.where(accept, xn, x) for xn, x in zip(xs_new, xs_c)]
            h_n = torch.where(live, torch.clamp(h_try * factor, min=1e-14), h_c)
            done_n = tau_n >= t_end_eff
            stalled = live & ((tau_n + h_n) <= tau_n) & ~done_n
            if n_int:
                crossed = [accept & (tau < T_eff[j]) & (T_eff[j] <= tau + h_try)
                           for j in range(n_int)]
                if any(bool(c.any()) for c in crossed):
                    # cubic Hermite on (x0, f0, x1, f1), contracted with the
                    # output coefficients first
                    c0s = [out_k(k, xs_c) for k in range(n_out)]
                    c1s = [out_k(k, xs_new) for k in range(n_out)]
                    f0s = [out_k(k, ks[0]) for k in range(n_out)]
                    f1s = [out_k(k, ks[-1]) for k in range(n_out)]
                    for j, (_, oe) in enumerate(interior):
                        th = (T_eff[j] - tau) / h_try
                        per_out = []
                        for k in range(n_out):
                            d = c1s[k] - c0s[k]
                            a_ = h_try * f0s[k] - d
                            b_ = d - h_try * f1s[k]
                            per_out.append(c0s[k] + th * d
                                           + th * (1.0 - th) * ((1.0 - th) * a_ + th * b_))
                        preds[j] = torch.where(crossed[j], sel_out(oe, per_out), preds[j])
            tau, xs_c, h_c = tau_n, xs_n, h_n
            live = live & ~done_n & ~stalled
            it += 1
        incomplete = tau < t_end_eff
        xs_out = [torch.where(incomplete, nan, x) for x in xs_c]
        h_out = torch.where(live0, h_c, h)
        if n_int:
            preds = [torch.where((T_eff[j] > tau) & (Tj.expand(shape) > 0.0), nan, p)
                     for j, ((Tj, _), p) in enumerate(zip(interior, preds))]
            return xs_out, h_out, preds
        return xs_out, h_out, []

    def integrate_bdf(xs, h, dt_col, rate, t0_col, estimate_h, interior, cov):
        """Variable-order BDF march over one run (JAX ``integrate_bdf``,
        ops/pallas_ode.py:1289), orders 1 to ``bdf_max_order``: per lane a
        backward-difference array D[order cap + 3][N] and a float-valued
        order; the Jacobian frozen at the predicted point and inverted once
        per trial; the order chosen among k-1, k, k+1 after k+1 equal steps,
        the middle winning ties; a hard reset to order 1 at h/4 on the third
        rejection in a row; an immediate 1.4x growth after an accept whose
        error is below 0.25. The rescaling ``(R(factor) U)^T D`` is two masked
        transforms. Never merged."""
        assert not interior, "bdf never merges"
        begin_call()
        MAXO = int(bdf_max_order)
        K6 = MAXO + 1
        target = dt_col.expand(shape)
        live0 = target > 0.0
        for s in range(N):
            live0 = live0 & torch.isfinite(xs[s])
        t_end_eff = target - 1e-6 * torch.clamp(target, min=1e-30)
        one = torch.ones_like(zeros)

        def where(cond, a, b):
            # scalars become lanes of the working dtype (two Python floats
            # alone would give torch's default dtype)
            a = a if isinstance(a, torch.Tensor) else torch.full_like(zeros, a)
            b = b if isinstance(b, torch.Tensor) else torch.full_like(zeros, b)
            return torch.where(cond, a, b)

        def near(v, k):
            return (v > float(k) - 0.5) & (v < float(k) + 0.5)

        def tab_at(table, order_l, lo, hi):
            acc = zeros
            for k in range(lo, hi + 1):
                ki = min(k, len(table) - 1)
                acc = acc + where(near(order_l, k), float(table[ki]), 0.0)
            return acc

        def rms_states(vs, scales):
            r2 = zeros
            for s in range(N):
                r2 = r2 + (vs[s] / scales[s]) ** 2
            return torch.sqrt(r2 / float(N))

        def change_D(D, order_l, fac):
            # R(fac) per lane: R[0][j] = 1, R[i][0] = 0 (i >= 1),
            # R[i][j] = R[i-1][j] * (i - 1 - fac j) / i
            Rl = [[None] * K6 for _ in range(K6)]
            for i in range(1, K6):
                for j in range(1, K6):
                    m_ij = (float(i - 1) - fac * float(j)) / float(i)
                    Rl[i][j] = m_ij if i == 1 else Rl[i - 1][j] * m_ij

            def act(i, j):
                return order_l >= float(max(i, j))

            # tmp = Rm^T D[:K6], then out = Um^T tmp, both masked to the
            # identity beyond the lane's order
            tmp = [[None] * N for _ in range(K6)]
            for a in range(K6):
                for s in range(N):
                    acc = D[0][s] if a == 0 else where(act(0, a), 1.0, 0.0) * D[0][s]
                    for b in range(1, K6):
                        if a == 0:
                            continue
                        ent = where(act(b, a), Rl[b][a], 1.0 if b == a else 0.0)
                        acc = acc + ent * D[b][s]
                    tmp[a][s] = acc
            out = [[None] * N for _ in range(K6)]
            for c_ in range(K6):
                for s in range(N):
                    acc = zeros
                    for a in range(K6):
                        ent = where(act(a, c_), float(_BDF_U[a][c_]),
                                    1.0 if a == c_ else 0.0)
                        acc = acc + ent * tmp[a][s]
                    out[c_][s] = acc
            return out + [row[:] for row in D[K6:]]

        def fac_of(e_, order_l, dord):
            # exp(log): what the JAX kernel computes; pow would move step
            # decisions
            return torch.exp(torch.log(torch.clamp(e_, min=1e-16))
                             * (-1.0 / (order_l + dord)))

        h_start = torch.minimum(h, torch.clamp(target, min=1e-14))
        f0 = f(xs, t0_col, rate, cov)
        D = [[zeros] * N for _ in range(MAXO + 3)]
        D[0] = [x + zeros for x in xs]
        D[1] = [h_start * k for k in f0]
        tau, h_c = zeros, h_start
        order_l, neq, nrej = one, zeros, zeros
        live = live0
        it = 0
        while it < max_steps and bool(live.any()):
            count_trials(live)
            rem = target - tau
            # clip the step to the remaining span, rescaling the history
            h_try = torch.minimum(h_c, torch.clamp(rem, min=1e-14))
            fac_clip = h_try / torch.clamp(h_c, min=1e-30)
            clip = fac_clip < 1.0
            D_cl = change_D(D, order_l, fac_clip)
            D = [[torch.where(clip, D_cl[i][s], D[i][s]) for s in range(N)]
                 for i in range(len(D))]
            neq = torch.where(clip, zeros, neq)

            alpha_k = tab_at(_BDF_ALPHA, order_l, 1, MAXO)
            c = h_try / torch.clamp(alpha_k, min=1e-30)
            x_pred = [zeros] * N
            psi_v = [zeros] * N
            for i in range(K6):
                wi = (order_l >= float(i)).to(dtype)
                gi = float(_BDF_GAMMA[i]) if i >= 1 else 0.0
                for s in range(N):
                    x_pred[s] = x_pred[s] + wi * D[i][s]
                    if i >= 1:
                        psi_v[s] = psi_v[s] + wi * gi * D[i][s]
            psi_v = [p / torch.clamp(alpha_k, min=1e-30) * 1.0 for p in psi_v]
            scales = [atol + rtol * torch.abs(x_pred[s]) for s in range(N)]
            t_new = t0_col + tau + h_try

            J = lane_jacobian(x_pred, t_new, rate, cov)
            Minv = lane_inverse([[(1.0 if i == j else 0.0) - c * J[i][j]
                                  for j in range(N)] for i in range(N)])
            d_l = [zeros] * N
            y = list(x_pred)
            for _ in range(newton_iters):
                fy = f(y, t_new, rate, cov)
                res = [c * fy[s] - psi_v[s] - d_l[s] for s in range(N)]
                step = matvec(Minv, res)
                d_l = [dd + st for dd, st in zip(d_l, step)]
                y = [yy + st for yy, st in zip(y, step)]
            fy = f(y, t_new, rate, cov)
            resid = [c * fy[s] - psi_v[s] - d_l[s] for s in range(N)]

            ec_k = tab_at(_BDF_ERROR_CONST, order_l, 1, MAXO)
            err_norm = rms_states([ec_k * dd for dd in d_l], scales)
            res_norm = rms_states(resid, scales)
            finite = torch.isfinite(err_norm)
            for s in range(N):
                finite = finite & torch.isfinite(y[s])
            converged = res_norm <= 0.1
            accept = live & (err_norm <= 1.0) & converged & finite

            # accepted-path difference update: D[k+2] = d - D[k+1];
            # D[k+1] = d; D[i] += D[i+1] downward
            d_op1 = [zeros] * N
            for k in range(2, MAXO + 2):
                w = near(order_l + 1.0, k).to(dtype)
                for s in range(N):
                    d_op1[s] = d_op1[s] + w * D[k][s]
            D_acc = []
            for i in range(len(D)):
                is2 = near(order_l + 2.0, i)
                is1 = near(order_l + 1.0, i)
                D_acc.append([torch.where(is2, d_l[s] - d_op1[s],
                                          torch.where(is1, d_l[s], D[i][s]))
                              for s in range(N)])
            for i in range(MAXO, -1, -1):
                wi = (order_l >= float(i)).to(dtype)
                for s in range(N):
                    D_acc[i][s] = D_acc[i][s] + wi * D_acc[i + 1][s]

            neq_acc = neq + 1.0
            do_adapt = accept & (neq_acc > order_l)

            # order adaptation: the error norms at order - 1, order, order + 1
            d_at_k = [zeros] * N
            d_at_k2 = [zeros] * N
            for k in range(1, MAXO + 1):
                w = near(order_l, k).to(dtype)
                for s in range(N):
                    d_at_k[s] = d_at_k[s] + w * D_acc[k][s]
                    d_at_k2[s] = d_at_k2[s] + w * D_acc[k + 2][s]
            ec_m = tab_at(_BDF_ERROR_CONST, order_l - 1.0, 0, MAXO - 1)
            ec_p = tab_at(_BDF_ERROR_CONST, order_l + 1.0, 2, MAXO + 1)
            err_m = rms_states([ec_m * v for v in d_at_k], scales)
            err_p = rms_states([ec_p * v for v in d_at_k2], scales)
            e_mid = torch.clamp(err_norm, min=1e-16)
            f_m = fac_of(err_m, order_l, 0.0)
            f_0 = fac_of(e_mid, order_l, 1.0)
            f_p = fac_of(err_p, order_l, 2.0)
            minus = torch.full_like(zeros, -1.0)
            f_m = torch.where((order_l > 1.0) & torch.isfinite(f_m), f_m, minus)
            f_p = torch.where((order_l < float(MAXO)) & torch.isfinite(f_p), f_p, minus)
            best_p = (f_p > f_0) & (f_p > f_m)
            best_m = (f_m > f_0) & ~best_p
            order_adapted = torch.clamp(
                order_l + where(best_p, 1.0, where(best_m, -1.0, 0.0)),
                1.0, float(MAXO))
            fac_best = torch.where(best_p, f_p, torch.where(best_m, f_m, f_0))
            factor_adapt = torch.clamp(0.9 * fac_best, 0.2, _BDF_MAX_GROWTH)
            factor_rej = torch.where(
                finite & converged,
                torch.clamp(0.9 * fac_of(torch.clamp(err_norm, min=1e-16), order_l, 1.0),
                            0.2, 1.0),
                torch.full_like(zeros, 0.25))
            factor = torch.where(accept, torch.where(do_adapt, factor_adapt, one),
                                 factor_rej)
            order_n = torch.where(do_adapt, order_adapted, order_l)
            # a third rejection in a row resets to order 1 at h / 4: it clears
            # a high-order history whose error estimates cannot be trusted
            nrej_n = torch.where(accept, zeros, nrej + 1.0)
            hard = ~accept & (nrej >= 2.0) & live
            order_n = torch.where(hard, one, order_n)
            factor = torch.where(hard, torch.full_like(zeros, 0.25), factor)
            nrej_n = torch.where(hard, zeros, nrej_n)
            # the quasi-constant policy grows h only after order + 1 accepts
            # in a row, so a lane whose estimate flips around 1 would never
            # grow: an accept whose error is clearly small grows 1.4x at once
            grow_now = accept & ~do_adapt & (err_norm < 0.25)
            factor = torch.where(grow_now, torch.full_like(zeros, 1.4), factor)
            neq_n = torch.where(accept & ~do_adapt & ~grow_now, neq_acc, zeros)
            D_sel = [[torch.where(accept, D_acc[i][s], D[i][s]) for s in range(N)]
                     for i in range(len(D))]
            D_fac = change_D(D_sel, order_n, factor)
            refac = live & (factor != 1.0)
            D = [[torch.where(refac, D_fac[i][s], D_sel[i][s]) for s in range(N)]
                 for i in range(len(D))]
            if counts is not None:
                count_bdf(0, live, order_l)
                count_bdf(1, accept, order_l)
                count_bdf(2, do_adapt, order_l)
                count_bdf(3, live & clip, order_l)
                count_bdf(4, refac, order_n)
            tau_n = torch.where(accept, tau + h_try, tau)
            h_n = torch.where(live, torch.clamp(h_try * factor, min=1e-14), h_c)
            done_n = tau_n >= t_end_eff
            stalled = live & ((tau_n + h_n) <= tau_n) & ~done_n
            tau, h_c, order_l, neq, nrej = tau_n, h_n, order_n, neq_n, nrej_n
            live = live & ~done_n & ~stalled
            it += 1
        incomplete = tau < t_end_eff
        xs_out = [torch.where(incomplete, nan, D[0][s]) for s in range(N)]
        h_out = torch.where(live0, h_c, h)
        return xs_out, h_out, []

    if use_expm:
        integrate = integrate_expm  # noqa: F811 (the pass of this solver)
    elif solver in SDIRK_TABLEAUS:
        integrate = integrate_sdirk  # noqa: F811
    elif solver == "bdf":
        integrate = integrate_bdf  # noqa: F811

    if ft.init_mask is not None:
        im = ft.init_mask.reshape(R, 1)
        if ft.init_planes is not None:
            xs = [im * ft.init_planes[s] + zeros for s in range(N)]
        else:
            xs = [im * ft.init_rows[s].reshape(1, S) + zeros for s in range(N)]
    else:
        xs = [zeros] * N
    ll = zeros
    h = torch.full(shape, float(h0), dtype=dtype, device=dev)
    pend_amt = [zeros] * nb
    pend_rem = [zeros] * nb
    for m0, m1 in runs:
        ll = ll + obs_term(m0, with_bias(sel_out(outeq(m0), [out_k(k, xs) for k in range(n_out)]),
                                         outeq(m0)))
        rate = rate_at(m0)
        t0_col = col(seg_t0, m0)
        cov = cov_for(m0)

        def amt_for(k, m=m0):
            amt = seg_bolus[k, :, m:m + 1]
            fp = ft.fa_src(k, m)
            return amt * fp if fp is not None else amt

        if not has_lag:
            for k, j in enumerate(bolus_inputs):
                amt = amt_for(k)
                if bool((amt != 0.0).any()):
                    xs = dose(xs, j, amt, t0_col, rate, cov)
            dt_run = col(seg_dt, m0)
            interior = []
            for mm in range(m0 + 1, m1):
                interior.append((dt_run, outeq(mm)))
                dt_run = dt_run + col(seg_dt, mm)
            xs, h, preds = integrate(xs, h, dt_run, rate, t0_col, m0 == 0, interior, cov)
            for (_, oe), mm, pred in zip(interior, range(m0 + 1, m1), preds):
                ll = ll + obs_term(mm, with_bias(pred, oe))
            continue
        # lag: the split march of the JAX kernel (:1752-1807). Doses due at
        # this breakpoint fire first, after its observation; new doses park
        # with their lag per bolus plane; one pass per plane advances to the
        # next earliest fire time (equal times fire together), then the
        # march runs to the segment's end
        for k, j in enumerate(bolus_inputs):
            fire0 = (pend_amt[k] != 0.0) & (pend_rem[k] <= 0.0)
            if bool(fire0.any()):
                xs = dose(xs, j, torch.where(fire0, pend_amt[k], zeros), t0_col, rate, cov)
            pend_amt[k] = torch.where(fire0, zeros, pend_amt[k])
        for k in range(nb):
            lp = ft.lag_src(k, m0)
            if lp is None:
                continue
            arrive = seg_bolus[k, :, m0:m0 + 1] != 0.0
            pend_amt[k] = torch.where(arrive, pend_amt[k] + amt_for(k), pend_amt[k])
            pend_rem[k] = torch.where(arrive, lp + zeros, pend_rem[k])
        dt_b = col(seg_dt, m0).expand(shape)
        elapsed = zeros
        for pas in range(nb):
            will = [(pend_amt[k] != 0.0) & (pend_rem[k] < dt_b) for k in range(nb)]
            t_next = dt_b
            for k in range(nb):
                t_next = torch.minimum(t_next, torch.where(will[k], pend_rem[k], dt_b))
            t_next = torch.maximum(t_next, elapsed)
            xs, h, _ = integrate(xs, h, t_next - elapsed, rate, t0_col + elapsed,
                                 m0 == 0 and pas == 0, [], cov)
            for k, j in enumerate(bolus_inputs):
                fire = will[k] & (pend_rem[k] <= t_next)
                if bool(fire.any()):
                    xs = dose(xs, j, torch.where(fire, pend_amt[k], zeros),
                              t0_col + t_next, rate, cov)
                pend_amt[k] = torch.where(fire, zeros, pend_amt[k])
            elapsed = t_next
        xs, h, _ = integrate(xs, h, dt_b - elapsed, rate, t0_col + elapsed, False, [], cov)
        live = dt_b > 0.0
        for k in range(nb):
            pend_rem[k] = torch.where((pend_amt[k] != 0.0) & live, pend_rem[k] - dt_b,
                                      pend_rem[k])
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
    rtol=1e-4, atol=1e-4, h0=1e-3, max_steps=10_000, cov_streams=None,
    cov_names=(), init_rows=None, init_planes=None, init_mask=None,
    lag_plane=None, fa_plane=None, lag_slots=None, fa_slots=None,
    newton_iters=6, bdf_max_order=BDF_DEFAULT_MAX_ORDER, blocks=None,
):
    """Fused ODE psi [R, S]: the counterpart of the JAX package's
    ``ops/pallas_ode.py::psi_ode``, explicit tier (dopri5, tsit5), exact
    propagation tier (``solver='expm'``: an RHS affine in the state and
    autonomous within a segment; never merged), SDIRK tier (trbdf2,
    kvaerno3 = esdirk34, kvaerno5: ``newton_iters`` frozen-Jacobian Newton
    rounds per stage; kvaerno5 never merged), BDF tier (``solver='bdf'``,
    orders 1 to ``bdf_max_order``, never merged) and their feature tier.
    Every tier but the explicit one needs an RHS generated with
    ``jacobian=True``.

    ``rhs`` is the :class:`~.rhs_codegen.GeneratedRhs` of the model.
    ``seg_rateiv``, ``obs_cens`` and ``out_bias`` are None when the workload
    has no infusions, censoring or output bias; ``obs_outeq`` is None for one
    output. ``merge_runs``: (m0, m1) spans tiling [0, M) whose interior
    breakpoints the caller proved observation-only (no dose on any row, rates
    and covariate streams unchanged, contiguous times;
    :func:`~..likelihood.plans.ode._ode_merge_runs`); None marches segment by
    segment. Features (all optional, see :class:`Features`):
    ``cov_streams`` {name: [R, M] stream (column 0 = the row's constant) or
    an (a, b) pair of [R, M] streams, ``cov(t) = a + b t`` in each segment}
    for the RHS's ``cov_names``; ``init_rows`` [N, S] or ``init_planes``
    [N, R, S] with ``init_mask`` [R]; ``lag_plane``/``fa_plane``: one [R, S]
    plane per bolus plane, or the slot-indexed planes ``lag_slots``/
    ``fa_slots`` select per segment. Lag does not combine with merged runs.

    On a CUDA tensor this launches ``csrc/fused_ode.cu``: kernel K2a
    without features, K2e with any, K2b with an SDIRK solver and K2c with
    ``bdf`` (a persistent grid whose lanes march cell after cell:
    :func:`implicit_lane_cell`; ``blocks`` sets its blocks, None for as many
    as the card holds at once), K2d with ``solver='expm'`` (one thread per
    (row, support) cell; ``blocks`` is not read), and raises if the build or
    the launch fails; on a CPU tensor it runs :func:`psi_ode_plain`.
    """
    global LAUNCHES, FEATURE_LAUNCHES, EXPM_LAUNCHES, SDIRK_LAUNCHES, BDF_LAUNCHES
    args = (seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma,
            obs_cens, seg_t0, support, rhs)
    feat_kw = dict(cov_streams=cov_streams, cov_names=tuple(cov_names),
                   init_rows=init_rows, init_planes=init_planes, init_mask=init_mask,
                   lag_plane=lag_plane, fa_plane=fa_plane, lag_slots=lag_slots,
                   fa_slots=fa_slots)
    kw = dict(obs_outeq=obs_outeq, out_coef=out_coef, out_bias=out_bias,
              bolus_inputs=tuple(bolus_inputs), rate_inputs=tuple(rate_inputs),
              merge_runs=merge_runs, solver=solver, rtol=rtol, atol=atol,
              h0=h0, max_steps=max_steps, newton_iters=int(newton_iters),
              bdf_max_order=int(bdf_max_order))
    dev = seg_dt.device
    if dev.type == "cpu":
        return psi_ode_plain(*args, **kw, **feat_kw)
    if dev.type != "cuda":
        raise ValueError(f"fused ODE psi runs on cpu or cuda tensors, got {dev}")
    n_out, runs, ft = _check_inputs(*args, obs_outeq, out_coef, out_bias,
                                    kw["bolus_inputs"], kw["rate_inputs"],
                                    merge_runs, solver, **feat_kw)
    R, M = seg_dt.shape
    S = support.shape[0]
    if R == 0 or S == 0:
        return torch.empty((R, S), dtype=seg_dt.dtype, device=dev)  # nothing to launch
    if not 1 <= kw["bdf_max_order"] <= BDF_MAX_ORDER:
        raise ValueError(f"bdf_max_order must lie in 1..{BDF_MAX_ORDER}, got {bdf_max_order}")
    from ._build import load_generated_library, ode_kind

    lib = load_generated_library(ode_kind(solver), rhs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out, err = _launch(lib, stream, args, kw, n_out, runs, ft, blocks or 0)
    if err != 0:
        raise RuntimeError(
            f"fused ODE psi kernel launch failed (R={R}, S={S}, M={M}): "
            f"{lib.fused_ode_error_string(err).decode()}"
        )
    if solver == "expm":
        EXPM_LAUNCHES += 1
    elif solver in SDIRK_TABLEAUS:
        SDIRK_LAUNCHES += 1
    elif solver == "bdf":
        BDF_LAUNCHES += 1
    elif ft.any:
        FEATURE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def _launch(lib, stream: int, args, kw, n_out: int, runs, ft: Features, blocks: int = 0):
    """Pack the validated inputs for the kernel's C interface and launch K2a
    (no features) or K2e on ``stream``: returns (out, cudaError_t code)."""
    (seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
     seg_t0, support, _) = args
    R, M = seg_dt.shape
    S = support.shape[0]
    dev = seg_dt.device
    out = torch.empty((R, S), dtype=seg_dt.dtype, device=dev)
    # parameter rows [P, S]: coalesced along supports
    params = support.t().contiguous()
    # one int32 table: bolus inputs, rate inputs, run boundaries, then (K2e)
    # the lag and fa slot tables [nb, M]
    nb = len(kw["bolus_inputs"])
    rate_in = kw["rate_inputs"] if seg_rateiv is not None else ()
    table = list(kw["bolus_inputs"]) + list(rate_in) + [runs[0][0]] + [b for _, b in runs]
    feat_ptrs = None
    if ft.any:
        for planes, slots in ((ft.lag, ft.lag_slots), (ft.fa, ft.fa_slots)):
            if planes is not None:
                rows = slots if slots is not None else [[k] * M for k in range(nb)]
                table += [int(v) for row in rows for v in row]
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
        feat_ptrs = (ctypes.c_void_p * 7)(*(_ptr(t) for t in (
            cov_a, cov_b, lag, fa, ft.init_rows, ft.init_planes, ft.init_mask)))
    ints = torch.tensor(table, dtype=torch.int32, device=dev)
    # the quartic interpolant of the explicit pairs (expm has none: unread)
    dense = torch.tensor(dense_P_for(kw["solver"]) or dense_P_for("dopri5"),
                         dtype=seg_dt.dtype, device=dev)
    base = (_ptr(seg_dt), _ptr(seg_bolus), _ptr(seg_rateiv),
            _ptr(obs_mask), _ptr(obs_value), _ptr(obs_sigma), _ptr(obs_cens),
            _ptr(kw["obs_outeq"] if n_out > 1 else None), _ptr(seg_t0),
            _ptr(params), _ptr(kw["out_coef"]), _ptr(kw["out_bias"]), _ptr(dense))
    dims = (R, S, M, nb, len(rate_in), n_out, len(runs))
    tols = (ctypes.c_double(kw["rtol"]), ctypes.c_double(kw["atol"]),
            ctypes.c_double(kw["h0"]))
    is_f64, code = int(seg_dt.dtype == torch.float64), SOLVER_CODES[kw["solver"]]
    # the implicit tiers' Newton rounds, the BDF tier's order cap, and the
    # persistent grid's blocks (unread by the expm tier)
    stiff = (int(kw.get("newton_iters", 0)), int(kw.get("bdf_max_order", BDF_DEFAULT_MAX_ORDER)),
             int(blocks))
    if feat_ptrs is None:
        err = lib.fused_ode_launch(is_f64, code, *base, _ptr(ints), _ptr(out), *dims,
                                   *tols, int(kw["max_steps"]), *stiff,
                                   ctypes.c_void_p(stream))
    else:
        err = lib.fused_ode_feature_launch(
            is_f64, code, (ctypes.c_void_p * 13)(*base), feat_ptrs, _ptr(ints),
            _ptr(out), *dims, len(ft.lag or ()), len(ft.fa or ()), *tols,
            int(kw["max_steps"]), *stiff, ctypes.c_void_p(stream))
    return out, err


def rhs_jvp_on_device(rhs, x, p, t, rate, v, cov_a=None, cov_b=None):
    """The generated ``rhs`` and ``rhs_jvp`` of ``rhs`` (generated with
    ``jacobian=True``) as the kernel's library computes them, on n samples:
    ``x``, ``v`` [n, N], ``p`` [n, n_params], ``t`` [n], ``rate`` [n, ninput],
    ``cov_a``/``cov_b`` [n, n_cov] CUDA tensors of one dtype. Returns ``(f,
    jv)`` [n, N]: what :func:`psi_ode`'s kernel evaluates, for checks against
    ``torch.func.jvp`` of the closure."""
    from ._build import ODE, load_generated_library

    if not rhs.jacobian:
        raise ValueError("the RHS was generated without jacobian=True")
    n, dev, dtype = x.shape[0], x.device, x.dtype
    if dev.type != "cuda":
        raise ValueError("rhs_jvp_on_device needs CUDA tensors")
    ncov = max(len(rhs.cov_names), 1)
    if cov_a is None:
        cov_a = torch.zeros((n, ncov), dtype=dtype, device=dev)
    if cov_b is None:
        cov_b = torch.zeros_like(cov_a)
    ins = [a.to(dtype).contiguous() for a in (x, p, t, rate, cov_a, cov_b, v)]
    for a, width in zip(ins, (rhs.n_states, rhs.n_params, None, rhs.ninput, ncov, ncov,
                              rhs.n_states)):
        if a.shape[0] != n or (width is not None and tuple(a.shape[1:]) != (width,)):
            raise ValueError(f"sample arrays must be [n, width]; got {tuple(a.shape)}")
    f, jv = torch.empty_like(ins[0]), torch.empty_like(ins[0])
    lib = load_generated_library(ODE, rhs)  # the expm tier's library holds the probe
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_ode_jvp_probe(int(dtype == torch.float64), n, *(_ptr(a) for a in ins),
                                      _ptr(f), _ptr(jv), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"rhs_jvp probe failed: {lib.fused_ode_error_string(err).decode()}")
    return f, jv
