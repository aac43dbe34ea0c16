"""Fused psi for the closed-form structures: CUDA kernel, plain twin, streams.

The population log-likelihood matrix ("psi", rows x support points) of a
closed-form PK model is one chain of scalar recurrences per (row, support)
cell: prepare the support point's eigen quantities once, then for every
segment add the observation term (read before the dose), add the bolus, and
propagate the state over the segment's span.

- :func:`psi_analytical` is the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/fused_psi.cu`` (built at first use by
  :mod:`._build`) or raises; on a CPU tensor it runs the plain twin.
- :func:`psi_analytical_plain` is that twin: the same math in plain PyTorch
  on ``[R, S]`` tensors. The CPU tests hold it against the JAX package's
  ``ops/pallas_psi.py::psi_oral``; ``chip_smoke.py`` holds the kernel
  against it on the card.
- :func:`streams_from_grid`, :func:`segment_schedule` and
  :func:`extract_linear_out` build the kernel's inputs on the host, as in
  the JAX package.

The stream layout is the JAX ``psi_oral``'s: segment streams ``[R, M]``,
support ``[S, n_cols]`` whose leading columns are the structure's parameters,
output coefficients ``[n_out, n_states, S]`` and biases ``[n_out, S]``;
the result is ``[R, S]``. Unlike the TPU kernel there is no padding: R, S and
M are free.

Censored observations use the exact log of the normal CDF (the TPU kernel
carried an approximation, ~6e-5 absolute, because Mosaic has no ``erf``).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ..config import int_dtype

LOG_2PI = math.log(2.0 * math.pi)

# Kernel launches through psi_analytical on a CUDA tensor (not the twin):
# K1a (no feature input), K1b (any feature input but K1c's) and K1c (slot
# tables, event codes or post slots).
LAUNCHES = 0
FEATURE_LAUNCHES = 0
K1C_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Structure definitions (the JAX package's ops/pallas_psi.py:127-429).
#
# ``prepare(params)`` does parameter-only work once (eigen quantities,
# coefficient ratios); it receives the micro-constant parameter rows (plus
# the 3-cmt decay constants) and returns an aux tuple. ``propagate(aux, xs,
# dt, rate)`` advances the state over one segment; ``rate`` is None when the
# workload has no infusions. Parameter rows are [1, S], states [R, S].
# ---------------------------------------------------------------------------


def _prep_1cmt_iv(p):
    (ke,) = p
    return (ke, 1.0 / ke)


def _prop_1cmt_iv(aux, xs, dt, rate):
    ke, inv_ke = aux
    (x1,) = xs
    e = torch.exp(-ke * dt)
    if rate is None:
        return [x1 * e]
    ss = rate * inv_ke
    return [ss + (x1 - ss) * e]


def _prep_1cmt_oral(p):
    ka, ke = p
    return (ka, ke, ka / (ka - ke), 1.0 / ke)


def _prop_1cmt_oral(aux, xs, dt, rate):
    ka, ke, ratio, inv_ke = aux
    x0, x1 = xs
    eka = torch.exp(-ka * dt)
    eke = torch.exp(-ke * dt)
    nx1 = x1 * eke + ratio * x0 * (eke - eka)
    if rate is not None:
        nx1 = nx1 + rate * inv_ke * (1.0 - eke)
    return [x0 * eka, nx1]


def _two_cmt_eigs(ke, kcp, kpc):
    disc = (ke + kcp + kpc) ** 2 - 4.0 * ke * kpc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    l1 = (ke + kcp + kpc + sq) * 0.5
    l2 = (ke + kcp + kpc - sq) * 0.5
    return l1, l2


def _prep_2cmt_iv(p):
    ke, kcp, kpc = p
    l1, l2 = _two_cmt_eigs(ke, kcp, kpc)
    inv_denom = 1.0 / (l1 - l2)
    return (ke, kcp, kpc, l1, l2, inv_denom, 1.0 / ke, kcp / (ke * kpc))


def _prop_2cmt_iv(aux, xs, dt, rate):
    ke, kcp, kpc, l1, l2, inv_denom, inv_ke, ss_ratio2 = aux
    x1, x2 = xs
    if rate is not None:
        ss1 = rate * inv_ke
        ss2 = rate * ss_ratio2
        y1 = x1 - ss1
        y2 = x2 - ss2
    else:
        y1, y2 = x1, x2
    e1 = torch.exp(-l1 * dt)
    e2 = torch.exp(-l2 * dt)
    nx1 = (((l1 - kpc) * e1 + (kpc - l2) * e2) * y1
           + kpc * (e2 - e1) * y2) * inv_denom
    nx2 = (kcp * (e2 - e1) * y1
           + ((l1 - ke - kcp) * e1 + (ke + kcp - l2) * e2) * y2) * inv_denom
    if rate is not None:
        nx1 = nx1 + ss1
        nx2 = nx2 + ss2
    return [nx1, nx2]


def _prep_2cmt_oral(p):
    ke, ka, kcp, kpc = p
    l1, l2 = _two_cmt_eigs(ke, kcp, kpc)
    return (ke, ka, kcp, kpc, l1, l2, 1.0 / (l1 - l2),
            1.0 / (ka - l1), 1.0 / (ka - l2), 1.0 / ke, kcp / (ke * kpc))


def _prop_2cmt_oral(aux, xs, dt, rate):
    (ke, ka, kcp, kpc, l1, l2, inv_denom, inv_ka_l1, inv_ka_l2, inv_ke,
     ss_ratio2) = aux
    x0, x1, x2 = xs
    e1 = torch.exp(-l1 * dt)
    e2 = torch.exp(-l2 * dt)
    eka = torch.exp(-ka * dt)
    if rate is not None:
        ss1 = rate * inv_ke
        ss2 = rate * ss_ratio2
        y1 = x1 - ss1
        y2 = x2 - ss2
    else:
        y1, y2 = x1, x2
    hom0 = ((l1 - kpc) * e1 + (kpc - l2) * e2) * y1 + kpc * (e2 - e1) * y2
    hom1 = kcp * (e2 - e1) * y1 + ((l1 - ke - kcp) * e1 + (ke + kcp - l2) * e2) * y2
    abs0 = (l1 - kpc) * inv_ka_l1 * (e1 - eka) + (kpc - l2) * inv_ka_l2 * (e2 - eka)
    abs1 = kcp * (inv_ka_l2 * (e2 - eka) - inv_ka_l1 * (e1 - eka))
    scale = ka * x0 * inv_denom
    nx1 = hom0 * inv_denom + abs0 * scale
    nx2 = hom1 * inv_denom + abs1 * scale
    if rate is not None:
        nx1 = nx1 + ss1
        nx2 = nx2 + ss2
    return [x0 * eka, nx1, nx2]


def _prep_3cmt_projectors(k10, k12, k13, k21, k31, lam):
    """Lagrange spectral projectors of the mammillary rate matrix:
    ``P_k = prod_{j!=k}(A + l_j I) / prod_{j!=k}(l_j - l_k)``."""
    a11 = -(k10 + k12 + k13)
    m11 = a11 * a11 + k21 * k12 + k31 * k13
    m12 = k21 * (a11 - k21)
    m13 = k31 * (a11 - k31)
    m21 = k12 * (a11 - k21)
    m22 = k12 * k21 + k21 * k21
    m23 = k12 * k31
    m31 = k13 * (a11 - k31)
    m32 = k13 * k21
    m33 = k13 * k31 + k31 * k31
    proj = []
    for k in range(3):
        lk = lam[k]
        lj, ll_ = lam[(k + 1) % 3], lam[(k + 2) % 3]
        s = lj + ll_
        pr = lj * ll_
        invd = 1.0 / ((lj - lk) * (ll_ - lk))
        P = (
            (m11 + s * a11 + pr) * invd,
            (m12 + s * k21) * invd,
            (m13 + s * k31) * invd,
            (m21 + s * k12) * invd,
            (m22 + s * (-k21) + pr) * invd,
            m23 * invd,
            (m31 + s * k13) * invd,
            m32 * invd,
            (m33 + s * (-k31) + pr) * invd,
        )
        proj.append((lk, P))
    return proj


def _prep_3cmt_iv(p):
    k10, k12, k13, k21, k31, l1, l2, l3 = p
    proj = _prep_3cmt_projectors(k10, k12, k13, k21, k31, (l1, l2, l3))
    return (proj, 1.0 / k10, k12 / (k10 * k21), k13 / (k10 * k31))


def _prop_3cmt_iv(aux, xs, dt, rate):
    proj, inv_k10, ss_ratio2, ss_ratio3 = aux
    x1, x2, x3 = xs
    if rate is not None:
        ss1 = rate * inv_k10
        ss2 = rate * ss_ratio2
        ss3 = rate * ss_ratio3
        y1, y2, y3 = x1 - ss1, x2 - ss2, x3 - ss3
        nx1, nx2, nx3 = ss1, ss2, ss3
    else:
        y1, y2, y3 = x1, x2, x3
        nx1 = nx2 = nx3 = torch.zeros_like(x1)
    for lk, P in proj:
        ek = torch.exp(-lk * dt)
        nx1 = nx1 + ek * (P[0] * y1 + P[1] * y2 + P[2] * y3)
        nx2 = nx2 + ek * (P[3] * y1 + P[4] * y2 + P[5] * y3)
        nx3 = nx3 + ek * (P[6] * y1 + P[7] * y2 + P[8] * y3)
    return [nx1, nx2, nx3]


def _prep_3cmt_oral(p):
    ka, k10, k12, k13, k21, k31, l1, l2, l3 = p
    proj = _prep_3cmt_projectors(k10, k12, k13, k21, k31, (l1, l2, l3))
    proj = [(lk, P, 1.0 / (ka - lk)) for lk, P in proj]
    return (ka, proj, 1.0 / k10, k12 / (k10 * k21), k13 / (k10 * k31))


def _prop_3cmt_oral(aux, xs, dt, rate):
    ka, proj, inv_k10, ss_ratio2, ss_ratio3 = aux
    x0, x1, x2, x3 = xs
    eka = torch.exp(-ka * dt)
    if rate is not None:
        ss1 = rate * inv_k10
        ss2 = rate * ss_ratio2
        ss3 = rate * ss_ratio3
        y1, y2, y3 = x1 - ss1, x2 - ss2, x3 - ss3
        nx1, nx2, nx3 = ss1, ss2, ss3
    else:
        y1, y2, y3 = x1, x2, x3
        nx1 = nx2 = nx3 = torch.zeros_like(x1)
    for lk, P, inv_ka_lk in proj:
        ek = torch.exp(-lk * dt)
        nx1 = nx1 + ek * (P[0] * y1 + P[1] * y2 + P[2] * y3)
        nx2 = nx2 + ek * (P[3] * y1 + P[4] * y2 + P[5] * y3)
        nx3 = nx3 + ek * (P[6] * y1 + P[7] * y2 + P[8] * y3)
        # depot forcing: ka*x0 * (ek - eka)/(ka - lk) * (P @ e1)
        f = ka * x0 * (ek - eka) * inv_ka_lk
        nx1 = nx1 + f * P[0]
        nx2 = nx2 + f * P[3]
        nx3 = nx3 + f * P[6]
    return [x0 * eka, nx1, nx2, nx3]


def _prep_3cmt_eigenvalues(base_rows):
    """Decay constants of the mammillary 3-cmt rate matrix, per support.

    Trigonometric solution of the monic cubic l^3 - A l^2 + B l - C with the
    symmetric sums of the three decay constants
    (three_compartment_models.rs:24-45); the arccos argument is clipped to
    [-1, 1]. ``base_rows`` is the micro-constant parameterization; for oral
    structures the leading ka row is present and skipped.
    """
    k10, k12, k13, k21, k31 = base_rows[-5:]
    A = k10 + k12 + k13 + k21 + k31
    B = k10 * k21 + k10 * k31 + k12 * k31 + k13 * k21 + k21 * k31
    C = k10 * k21 * k31
    p = B - A * A / 3.0
    q = -2.0 * A * A * A / 27.0 + A * B / 3.0 - C
    mp3 = torch.clamp(-p / 3.0, min=1e-30)
    rt = torch.sqrt(mp3)
    arg = torch.clamp(3.0 * q / (2.0 * torch.clamp(p, max=-1e-30)) / rt, -1.0, 1.0)
    phi = torch.acos(arg) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    l1 = 2.0 * rt * torch.cos(phi) + A / 3.0
    l2 = 2.0 * rt * torch.cos(phi - two_pi_3) + A / 3.0
    l3 = 2.0 * rt * torch.cos(phi - 2.0 * two_pi_3) + A / 3.0
    return [l1, l2, l3]


# CL-parameterization remaps: the same micro-constant reparameterizations as
# engine/analytical.py one/two/three_compartments_cl* (parity: *_cl_models.rs).


def _remap_1cmt_cl(r):
    cl, v = r
    return [cl / v]


def _remap_1cmt_cl_abs(r):
    ka, cl, v = r
    return [ka, cl / v]


def _remap_2cmt_cl(r):
    cl, q, vc, vp = r
    return [cl / vc, q / vc, q / vp]


def _remap_2cmt_cl_abs(r):
    ka, cl, q, vc, vp = r
    return [cl / vc, ka, q / vc, q / vp]


def _remap_3cmt_cl(r):
    cl, q1, q2, vc, vp1, vp2 = r
    return [cl / vc, q1 / vc, q2 / vc, q1 / vp1, q2 / vp2]


def _remap_3cmt_cl_abs(r):
    ka, cl, q1, q2, vc, vp1, vp2 = r
    return [ka, cl / vc, q1 / vc, q2 / vc, q1 / vp1, q2 / vp2]


def _struct(n_params, n_states, dose_state, central, prepare, propagate,
            eigs=None, remap=None):
    return {
        "n_params": n_params,       # support columns consumed by the kernel
        "n_states": n_states,
        "dose_state": dose_state,   # bolus destination
        "central": central,         # state index of the default central/v output
        "prepare": prepare,
        "propagate": propagate,
        "eigs": eigs,               # extra decay-constant rows (3-cmt)
        "remap": remap,             # CL -> micro-constant reparameterization
    }


# The order is the kernel's structure code (csrc/fused_psi.cu): code // 4 is
# the compartment count less one, (code // 2) % 2 the CL flag, code % 2 the
# absorption flag.
STRUCTURES = {
    "one_compartment": _struct(1, 1, 0, 0, _prep_1cmt_iv, _prop_1cmt_iv),
    "one_compartment_with_absorption": _struct(
        2, 2, 0, 1, _prep_1cmt_oral, _prop_1cmt_oral),
    "one_compartment_cl": _struct(
        2, 1, 0, 0, _prep_1cmt_iv, _prop_1cmt_iv, remap=_remap_1cmt_cl),
    "one_compartment_cl_with_absorption": _struct(
        3, 2, 0, 1, _prep_1cmt_oral, _prop_1cmt_oral, remap=_remap_1cmt_cl_abs),
    "two_compartments": _struct(3, 2, 0, 0, _prep_2cmt_iv, _prop_2cmt_iv),
    "two_compartments_with_absorption": _struct(
        4, 3, 0, 1, _prep_2cmt_oral, _prop_2cmt_oral),
    "two_compartments_cl": _struct(
        4, 2, 0, 0, _prep_2cmt_iv, _prop_2cmt_iv, remap=_remap_2cmt_cl),
    "two_compartments_cl_with_absorption": _struct(
        5, 3, 0, 1, _prep_2cmt_oral, _prop_2cmt_oral, remap=_remap_2cmt_cl_abs),
    "three_compartments": _struct(
        5, 3, 0, 0, _prep_3cmt_iv, _prop_3cmt_iv, eigs=_prep_3cmt_eigenvalues),
    "three_compartments_with_absorption": _struct(
        6, 4, 0, 1, _prep_3cmt_oral, _prop_3cmt_oral,
        eigs=_prep_3cmt_eigenvalues),
    "three_compartments_cl": _struct(
        6, 3, 0, 0, _prep_3cmt_iv, _prop_3cmt_iv,
        eigs=_prep_3cmt_eigenvalues, remap=_remap_3cmt_cl),
    "three_compartments_cl_with_absorption": _struct(
        7, 4, 0, 1, _prep_3cmt_oral, _prop_3cmt_oral,
        eigs=_prep_3cmt_eigenvalues, remap=_remap_3cmt_cl_abs),
}
STRUCTURE_CODES = {name: i for i, name in enumerate(STRUCTURES)}


# ---------------------------------------------------------------------------
# The wrapper and its plain twin
# ---------------------------------------------------------------------------


def _check_inputs(seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value,
                  obs_sigma, obs_cens, support, structure, obs_outeq,
                  out_coef, out_bias):
    """Validate the stream layout; returns (sdef, coef, bias, n_out).

    ``coef`` [n_out, n_states, S] and ``bias`` ([n_out, S] or None) are the
    output rows: ``out_coef``/``out_bias`` as given, or the classic
    convention (one output, central / v with v the support's last column)
    when ``out_coef`` is None.
    """
    if structure not in STRUCTURES:
        raise ValueError(
            f"unknown fused psi structure `{structure}` "
            f"(available: {', '.join(sorted(STRUCTURES))})"
        )
    sdef = STRUCTURES[structure]
    n_params, n_states = sdef["n_params"], sdef["n_states"]
    if seg_dt.dim() != 2:
        raise ValueError(f"segment streams must be [R, M], got {tuple(seg_dt.shape)}")
    R, M = seg_dt.shape
    if support.dim() != 2:
        raise ValueError(f"support must be [S, n_cols], got {tuple(support.shape)}")
    S = support.shape[0]
    dtype, dev = seg_dt.dtype, seg_dt.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fused psi takes float32 or float64, got {dtype}")
    named = {"seg_bolus": seg_bolus, "seg_rateiv": seg_rateiv,
             "obs_mask": obs_mask, "obs_value": obs_value,
             "obs_sigma": obs_sigma, "obs_cens": obs_cens,
             "obs_outeq": obs_outeq}
    for name, a in named.items():
        if a is None:
            continue
        if tuple(a.shape) != (R, M):
            raise ValueError(f"{name} must be [{R}, {M}], got {tuple(a.shape)}")
    for name, a in dict(named, seg_dt=seg_dt, support=support,
                        out_coef=out_coef, out_bias=out_bias).items():
        if a is None:
            continue
        if a.dtype != dtype or a.device != dev:
            raise ValueError(
                f"{name} is {a.dtype} on {a.device}; expected {dtype} on {dev}"
            )
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_coef is None:
        if support.shape[1] != n_params + 1:
            raise ValueError(
                f"{structure} needs {n_params} support columns plus v (last)"
            )
        v = support[:, n_params]
        coef = torch.zeros((1, n_states, S), dtype=dtype, device=dev)
        coef[0, sdef["central"]] = 1.0 / v
        bias = None
        n_out = 1
    else:
        if support.shape[1] < n_params:
            raise ValueError(f"{structure} needs >= {n_params} support columns")
        n_out = out_coef.shape[0]
        if tuple(out_coef.shape) != (n_out, n_states, S):
            raise ValueError(
                f"out_coef must be [n_out, {n_states}, {S}], "
                f"got {tuple(out_coef.shape)}"
            )
        coef = out_coef
        bias = out_bias
        if bias is not None and tuple(bias.shape) != (n_out, S):
            raise ValueError(f"out_bias must be [{n_out}, {S}], got {tuple(bias.shape)}")
    if n_out > 1 and obs_outeq is None:
        raise ValueError("obs_outeq stream required for multi-output psi")
    return sdef, coef, bias, n_out


# K1b's and K1c's feature inputs, in the wrapper's argument order (psi_oral's)
FEATURES = ("param_mult", "param_offset", "param_mult_seg", "param_offset_seg",
            "param_levels", "param_planes", "seg_depth", "seg_evcode", "seg_postdepth",
            "lag_plane", "fa_plane", "init_rows", "init_planes", "init_mask")
# the input that selects each parameter mode, and the mode's kernel code
_MODE_INPUTS = {"param_mult": "row", "param_mult_seg": "segment",
                "param_levels": "levels", "param_planes": "planes"}
MODES = {None: 0, "row": 1, "segment": 2, "levels": 3, "planes": 4}


def _plane_list(planes, slots, M: int, what: str):
    """A lag/fa argument as (list of planes, slot table): one [R, S] plane
    or one row per support [1, S] (no table), or with ``slots`` (an [M]
    tuple of plane indices, -1 where no dose lands) the sequence of [R, S]
    planes it selects (JAX :1177-1200)."""
    if planes is None:
        if slots is not None:
            raise ValueError(f"{what} slots given without planes")
        return None, None
    if slots is None:
        if not isinstance(planes, torch.Tensor):
            raise ValueError(f"{what} must be one [R, S] plane or [1, S] row without slots")
        return [planes], None
    slots = tuple(int(v) for v in slots)
    lst = list(planes.unbind(0)) if isinstance(planes, torch.Tensor) else list(planes)
    if len(slots) != M:
        raise ValueError(f"{what} slots must have one entry per segment ({M})")
    if len(lst) != max(slots) + 1 or min(slots) < -1:
        raise ValueError(f"{what} carries {len(lst)} planes, its slots select "
                         f"{max(slots) + 1}")
    return lst, slots


def _check_features(seg_dt, support, sdef, f: dict, lag_slots=None, fa_slots=None):
    """Validate the feature inputs ``f`` (name -> tensor or None; lag_plane
    and fa_plane may be plane sequences selected by the slot tables); returns
    (the parameter mode: None, ``row``, ``segment``, ``levels``, ``planes``;
    the lag planes; the fa planes; lag_slots; fa_slots)."""
    R, M = seg_dt.shape
    S = support.shape[0]
    P, NS = sdef["n_params"], sdef["n_states"]
    given = [name for name in _MODE_INPUTS if f[name] is not None]
    if len(given) > 1:
        raise ValueError(f"{' and '.join(given)} are mutually exclusive")
    mode = _MODE_INPUTS[given[0]] if given else None
    table = f["param_levels"] if f["param_levels"] is not None else f["param_planes"]
    L = table.shape[0] if table is not None else 0
    lag, lag_slots = _plane_list(f["lag_plane"], lag_slots, M, "lag_plane")
    fa, fa_slots = _plane_list(f["fa_plane"], fa_slots, M, "fa_plane")
    shapes = {
        "param_mult": (R, P), "param_offset": (R, P),
        "param_mult_seg": (R, P, M), "param_offset_seg": (R, P, M),
        "param_levels": (L, n_micro(sdef), S), "param_planes": (L, n_micro(sdef), R, S),
        "seg_depth": (R, M), "seg_evcode": (R, M), "seg_postdepth": (R, M),
        "init_rows": (NS, S), "init_planes": (NS, R, S), "init_mask": (R,),
    }
    arrays = [(n, a) for n, a in f.items() if n not in ("lag_plane", "fa_plane")]
    arrays += [(f"lag_plane {i}", a) for i, a in enumerate(lag or ())]
    arrays += [(f"fa_plane {i}", a) for i, a in enumerate(fa or ())]
    for name, a in arrays:
        if a is None:
            continue
        want = shapes.get(name, (R, S))
        # a lag or fa without slots may be one row per support
        row = ((name == "lag_plane 0" and lag_slots is None)
               or (name == "fa_plane 0" and fa_slots is None)) and tuple(a.shape) == (1, S)
        if tuple(a.shape) != want and not row:
            raise ValueError(f"{name} must be {list(want)}"
                             + (f" or [1, {S}]" if name.endswith(" 0") else "")
                             + f", got {list(a.shape)}")
        if a.dtype != seg_dt.dtype or a.device != seg_dt.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; expected "
                             f"{seg_dt.dtype} on {seg_dt.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if f["param_offset"] is not None and mode != "row":
        raise ValueError("param_offset requires param_mult")
    if f["param_offset_seg"] is not None and mode != "segment":
        raise ValueError("param_offset_seg requires param_mult_seg")
    if ((f["seg_depth"] is not None) + (f["seg_evcode"] is not None)
            != (mode in ("levels", "planes"))):
        raise ValueError("param_levels and param_planes require seg_depth (or, with "
                         "lag, seg_evcode), and only they")
    if f["seg_evcode"] is not None and lag is None:
        raise ValueError("seg_evcode (lag with a seq chain deeper than one) requires "
                         "param_levels/param_planes and a lag_plane")
    if f["seg_postdepth"] is not None and (mode != "planes" or f["seg_depth"] is None
                                           or lag is None):
        raise ValueError("seg_postdepth (lag with time-varying seq column planes) "
                         "requires param_planes, seg_depth and a lag_plane")
    has_init = f["init_rows"] is not None or f["init_planes"] is not None
    if f["init_rows"] is not None and f["init_planes"] is not None:
        raise ValueError("pass init_rows or init_planes, not both")
    if (f["init_mask"] is not None) != has_init:
        raise ValueError("init_rows and init_planes require init_mask, and only they")
    return mode, lag, fa, lag_slots, fa_slots


def observation_terms(obs_mask, obs_sigma, obs_cens):
    """The observation work that depends on the row alone, as the kernels'
    launch computes it once per row before the cells: ``obs_isig``
    [R, M], 1 / sigma (1 where the mask is off), and ``obs_const`` [R], each
    row's sum over its uncensored observations of ``-log(2 pi) / 2 - log
    sigma``. A cell's sum starts at ``obs_const`` and adds ``-z^2 / 2`` with
    ``z = (y - pred) * obs_isig`` per observation (``log_ndtr(sign * z)``
    censored)."""
    mask = obs_mask > 0
    sig = torch.where(mask, obs_sigma, torch.ones_like(obs_sigma))
    keep = mask if obs_cens is None else mask & (obs_cens == 0)
    const = torch.where(keep, -0.5 * LOG_2PI - torch.log(sig), torch.zeros_like(sig))
    return 1.0 / sig, const.sum(1)


def n_micro(sdef) -> int:
    """The structure's micro-constant count: its support columns less the
    volume a CL parameterization divides by."""
    return sdef["n_params"] - (1 if sdef["remap"] is not None else 0)


def psi_analytical_plain(
    seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
    support,
    structure: str = "two_compartments_with_absorption",
    obs_outeq=None,
    out_coef=None,
    out_bias=None,
    param_mult=None,
    param_offset=None,
    param_mult_seg=None,
    param_offset_seg=None,
    param_levels=None,
    param_planes=None,
    seg_depth=None,
    seg_evcode=None,
    seg_postdepth=None,
    lag_plane=None,
    fa_plane=None,
    lag_slots=None,
    fa_slots=None,
    init_rows=None,
    init_planes=None,
    init_mask=None,
    counts=None,
):
    """Plain PyTorch twin of the fused psi kernels (same arguments, [R, S]).

    The math of the JAX package's ``psi_oral`` (base tier; feature tier:
    ``pallas_psi.py:583-606``, ``:678-723``, ``:762-782``; K1c's slot-selected
    planes, ``lag_depth`` and ``lag_post`` paths: ``:498-527``, ``:655-690``,
    ``:725-758``), segment by segment on ``[R, S]`` tensors, with the exact
    log of the normal CDF for censored observations. The observation terms
    are the kernels' (:func:`observation_terms`): each row's sum starts
    at ``obs_const`` and adds ``-z^2 / 2`` with ``z = (y - pred) *
    obs_isig``. A lag or fa row [1, S] broadcasts over
    the rows. A ``counts`` dict receives the work this data needs in levels
    and planes mode, as the kernel does it: ``"propagates"`` (spanned
    segments, plus the second part of each split march), ``"fires"`` (lagged
    doses that fire), ``"fires_with_rate"`` (those of them in a segment with
    an infusion), ``"level_changes"`` (a cell's one model taking another
    chain level or slot: at a segment, or for the rest of a split march) and
    ``"prepares"`` (in levels mode one per level and support, the kernel's
    table; in planes mode one per level change).
    """
    sdef, coef, bias, n_out = _check_inputs(
        seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma,
        obs_cens, support, structure, obs_outeq, out_coef, out_bias)
    mode, lags, fas, lag_slots, fa_slots = _check_features(
        seg_dt, support, sdef, dict(zip(FEATURES, (
            param_mult, param_offset, param_mult_seg, param_offset_seg, param_levels,
            param_planes, seg_depth, seg_evcode, seg_postdepth, lag_plane, fa_plane,
            init_rows, init_planes, init_mask))), lag_slots, fa_slots)
    obs_isig, obs_const = observation_terms(obs_mask, obs_sigma, obs_cens)
    n_params, n_states = sdef["n_params"], sdef["n_states"]
    R, M = seg_dt.shape
    S = support.shape[0]
    raw = [support[:, i].reshape(1, S) for i in range(n_params)]

    def prepared(rows, micro=False):
        # CL remap (unless the rows are micro constants already), the 3-cmt
        # decay constants, then the structure's parameter-only work
        if not micro and sdef["remap"] is not None:
            rows = sdef["remap"](rows)
        if sdef["eigs"] is not None:
            rows = rows + sdef["eigs"](rows)
        return sdef["prepare"](rows)

    def affine(mult, off):  # raw * mult (+ off); mult/off [R, n_params]
        eff = [raw[i] * mult[:, i:i + 1] for i in range(n_params)]
        if off is not None:
            eff = [e + off[:, i:i + 1] for i, e in enumerate(eff)]
        return eff

    if mode is None:
        aux = prepared(raw)
    elif mode == "row":
        aux = prepared(affine(param_mult, param_offset))
    if mode in ("levels", "planes"):
        table = param_levels if mode == "levels" else param_planes
        shape = (1, S) if mode == "levels" else (R, S)
        table = [[table[lv, i].reshape(shape) for i in range(table.shape[1])]
                 for lv in range(table.shape[0])]
    propagate = sdef["propagate"]
    dose_state = sdef["dose_state"]
    has_inf = seg_rateiv is not None
    has_cens = obs_cens is not None
    has_lag = lags is not None
    lag_depth = seg_evcode is not None
    lag_post = seg_postdepth is not None

    def level_select(d):
        """The parameter rows of depth (or slot) d [R, 1|S], 1-based."""
        eff = []
        for i in range(len(table[0])):
            e = (d == 1.0).to(d.dtype) * table[0][i]
            for lv in range(1, len(table)):
                e = e + (d == float(lv + 1)).to(d.dtype) * table[lv][i]
            eff.append(e)
        return eff

    def plane_at(planes, slots, m):
        """The lag or fa plane of segment m (None: no dose lands there)."""
        if planes is None:
            return None
        if slots is None:
            return planes[0]
        return None if slots[m] < 0 else planes[slots[m]]

    if lag_depth:
        # the in-kernel chain state: dc the applied depth of the engine
        # segment under way, app 1 once it applied seq; after a fire the
        # rest of its segment runs at depth 1
        dc = app = torch.zeros((R, S), dtype=seg_dt.dtype, device=seg_dt.device)
        aux_fire = prepared(list(table[0]), micro=True)
    coef_rows = [[coef[k, i].reshape(1, S) for i in range(n_states)]
                 for k in range(n_out)]
    bias_rows = ([bias[k].reshape(1, S) for k in range(n_out)]
                 if bias is not None else None)

    zeros = torch.zeros((R, S), dtype=seg_dt.dtype, device=seg_dt.device)
    if init_mask is None:
        xs = [zeros] * n_states
    else:
        im = init_mask.reshape(R, 1)
        xs = [im * (init_rows[i].reshape(1, S) if init_rows is not None
                    else init_planes[i]) + zeros for i in range(n_states)]
    ll = obs_const.reshape(R, 1) + zeros
    pend_amt = pend_rem = zeros
    for m in range(M):
        dt = seg_dt[:, m:m + 1]
        mask = obs_mask[:, m:m + 1] > 0
        val = obs_value[:, m:m + 1]

        # observation before dose: y_k = C_k . x (+ b_k)
        def pred_out(k):
            p = coef_rows[k][0] * xs[0]
            for i in range(1, n_states):
                p = p + coef_rows[k][i] * xs[i]
            if bias_rows is not None:
                p = p + bias_rows[k]
            return p

        if n_out == 1:
            pred = pred_out(0)
        else:
            oe = obs_outeq[:, m:m + 1]
            pred = zeros
            for k in range(n_out):
                pred = torch.where(oe == float(k), pred_out(k), pred)
        z = (val - pred) * obs_isig[:, m:m + 1]
        term = -0.5 * z * z
        if has_cens:
            s_c = obs_cens[:, m:m + 1]
            term = torch.where(s_c == 0.0, term, torch.special.log_ndtr(s_c * z))
        ll = ll + torch.where(mask, term, zeros)

        # the bolus (0 on padded slots), scaled by fa; with lag it waits in
        # the pending registers until its lag has elapsed
        xs = list(xs)
        bol = seg_bolus[:, m:m + 1]
        fp = plane_at(fas, fa_slots, m)
        bol_eff = bol * fp if fp is not None else bol
        if has_lag:
            lp = plane_at(lags, lag_slots, m)
            if lp is not None:
                new = bol != 0.0
                pend_amt = torch.where(new, bol_eff, pend_amt)
                pend_rem = torch.where(new, lp, pend_rem)
        else:
            xs[dose_state] = xs[dose_state] + bol_eff
        live = dt > 0.0
        if mode == "segment":
            aux_m = prepared(affine(param_mult_seg[:, :, m], None if param_offset_seg
                                    is None else param_offset_seg[:, :, m]))
        elif mode in ("levels", "planes"):
            if lag_depth:
                # the engine's reset/carry rule on the event codes: 1 resets
                # (observation, infusion start), 2 compounds (infusion end),
                # 0 is a bolus column whose event moved with its lag: the
                # engine segment runs on through it, applying seq once
                code = seg_evcode[:, m:m + 1]
                span = live.to(dt.dtype)
                is_ev, is_ie = code == 1.0, code == 2.0
                dc = torch.where(is_ev, span + torch.zeros_like(dc),
                                 torch.where(is_ie, dc + span, dc + span * (1.0 - app)))
                app = torch.where(is_ev | is_ie, span + torch.zeros_like(app),
                                  torch.maximum(app, span))
                d = dc
            else:
                d = seg_depth[:, m:m + 1]
            aux_m = prepared(level_select(d), micro=True)
            if lag_post:
                aux_fire = prepared(level_select(seg_postdepth[:, m:m + 1]), micro=True)
        else:
            aux_m = aux
        rate = seg_rateiv[:, m:m + 1] if has_inf else None
        if counts is not None and mode in ("levels", "planes"):
            lv = (d if lag_depth else seg_depth[:, m:m + 1]).expand(R, S)
            fired = (pend_amt != 0.0) & (pend_rem < dt) & live if has_lag else zeros.bool()
            # the level (slot) a cell's one model holds: a spanned segment's,
            # then after a fire the post-fire one (depth 1, or the post slot)
            cur = counts.setdefault("_level", torch.zeros_like(lv))
            changes = int((live.expand(R, S) & (lv != cur)).sum())
            cur = torch.where(live.expand(R, S), lv, cur)
            if lag_depth or lag_post:
                post = (seg_postdepth[:, m:m + 1] if lag_post else torch.ones_like(dt)
                        ).expand(R, S)
                changes += int((fired & (post != cur)).sum())
                cur = torch.where(fired, post, cur)
            counts["_level"] = cur
            counts["level_changes"] = counts.get("level_changes", 0) + changes
            counts["prepares"] = (len(table) * S if mode == "levels"
                                  else counts["level_changes"])
            counts["propagates"] = counts.get("propagates", 0) + int(
                live.expand(R, S).sum()) + int(fired.sum())
            counts["fires"] = counts.get("fires", 0) + int(fired.sum())
            with_rate = fired & (rate != 0.0) if rate is not None else zeros.bool()
            counts["fires_with_rate"] = counts.get("fires_with_rate", 0) + int(
                with_rate.sum())
        if lag_depth or lag_post:
            # the true split march: the fire resets the chain, so march to
            # it at the pre-fire parameters, add the dose, and march the rest
            # at the post-fire ones (the infusion rides both parts)
            fire = (pend_amt != 0.0) & (pend_rem < dt)
            dt1 = torch.where(fire, pend_rem, dt)
            nxs = propagate(aux_m, xs, dt1, rate)
            xs = [torch.where(dt1 > 0.0, nx, x) for nx, x in zip(nxs, xs)]
            xs[dose_state] = xs[dose_state] + torch.where(fire, pend_amt, zeros)
            dt2 = torch.where(fire, dt - pend_rem, zeros)
            nxs = propagate(aux_fire, xs, dt2, rate)
            xs = [torch.where(dt2 > 0.0, nx, x) for nx, x in zip(nxs, xs)]
            if lag_depth:
                dc = torch.where(fire, torch.ones_like(dc), dc)
                app = torch.where(fire, torch.ones_like(app), app)
            pend_amt = torch.where(fire, zeros, pend_amt)
            pend_rem = torch.where(
                fire, zeros,
                torch.where(live, torch.clamp(pend_rem - dt, min=0.0), pend_rem))
            continue
        nxs = propagate(aux_m, xs, dt, rate)
        xs = [torch.where(live, nx, x) for nx, x in zip(nxs, xs)]
        if has_lag:
            # the pending dose fires once its lag elapses inside this
            # segment: by superposition, the dose vector propagated over the
            # rest of the span, without infusion forcing
            fire = (pend_amt != 0.0) & (pend_rem < dt)
            dose_xs = [pend_amt if i == dose_state else zeros for i in range(n_states)]
            contrib = propagate(aux_m, dose_xs, torch.clamp(dt - pend_rem, min=0.0), None)
            xs = [torch.where(fire, x + c, x) for x, c in zip(xs, contrib)]
            pend_amt = torch.where(fire, zeros, pend_amt)
            pend_rem = torch.where(
                fire, zeros,
                torch.where(live, torch.clamp(pend_rem - dt, min=0.0), pend_rem))
    return ll


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def psi_analytical(
    seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
    support,
    structure: str = "two_compartments_with_absorption",
    obs_outeq=None,
    out_coef=None,
    out_bias=None,
    param_mult=None,
    param_offset=None,
    param_mult_seg=None,
    param_offset_seg=None,
    param_levels=None,
    param_planes=None,
    seg_depth=None,
    seg_evcode=None,
    seg_postdepth=None,
    lag_plane=None,
    fa_plane=None,
    lag_slots=None,
    fa_slots=None,
    init_rows=None,
    init_planes=None,
    init_mask=None,
    blocks=None,
):
    """Fused psi [R, S] for the closed-form structures.

    The counterpart of the JAX package's ``ops/pallas_psi.py::psi_oral``.
    ``seg_rateiv`` and ``obs_cens`` are None for a workload without
    infusions or censoring (the kernel then skips that work), and
    ``obs_outeq`` is None for one output. All tensors share one dtype
    (float32 or float64) and one device, and are contiguous.

    Feature inputs (kernel K1b; all None: kernel K1a), in ``psi_oral``'s
    order and layout:

    - parameters per row, ``param_mult`` [R, n_params] (and
      ``param_offset``): effective support columns ``p * mult + offset``;
    - per segment, ``param_mult_seg`` [R, n_params, M] (and
      ``param_offset_seg``);
    - per chain level, ``param_levels`` [L, n_micro, S] or per (row,
      support) ``param_planes`` [L, n_micro, R, S] in micro constants (the CL
      remap applied), selected per segment by ``seg_depth`` [R, M] (1-based,
      0 on dead segments);
    - ``lag_plane`` / ``fa_plane`` [R, S], or one row per support [1, S]
      for a closure that reads no covariate: each bolus waits its lag in a
      pending slot and is scaled by fa; no two doses of a row may be
      pending at once (the plan checks it);
    - ``init_rows`` [n_states, S] or ``init_planes`` [n_states, R, S] with
      ``init_mask`` [R]: the initial state on rows whose mask is 1.

    and kernel K1c's (JAX ``psi_oral`` :1037-1070, :1177-1216):

    - ``lag_plane`` / ``fa_plane`` as sequences of [R, S] planes, selected
      per dose segment by ``lag_slots`` / ``fa_slots`` (an [M] tuple of
      plane indices, -1 where no dose lands);
    - ``seg_evcode`` [R, M] in place of ``seg_depth`` (lag with a seq chain
      deeper than one): event codes 1 reset, 2 compound, 0 a bolus column,
      replayed by an in-kernel depth counter, with a split march at the fire;
    - ``seg_postdepth`` [R, M] beside ``seg_depth`` (lag with a time-varying
      seq, planes mode): the post-fire slot of each column.

    The launch first computes the observation terms of each row
    (:func:`observation_terms`), then runs a persistent grid of ``blocks``
    blocks (None: as many as the card holds at once; psi does not depend on
    it).

    On a CUDA tensor this launches ``csrc/fused_psi.cu``: kernel K1a (the
    base tier of the one kernel body) without features, counted in
    ``LAUNCHES``, else kernel K1b, counted in ``FEATURE_LAUNCHES``, or K1c
    (slot tables, ``seg_evcode`` or ``seg_postdepth``), counted in
    ``K1C_LAUNCHES``; it raises if the launch fails. On a CPU tensor it runs
    :func:`psi_analytical_plain`.
    """
    global LAUNCHES, FEATURE_LAUNCHES, K1C_LAUNCHES
    f = dict(zip(FEATURES, (param_mult, param_offset, param_mult_seg,
                            param_offset_seg, param_levels, param_planes, seg_depth,
                            seg_evcode, seg_postdepth, lag_plane, fa_plane, init_rows,
                            init_planes, init_mask)))
    args = (seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
            support, structure, obs_outeq, out_coef, out_bias)
    dev = seg_dt.device
    if dev.type == "cpu":
        return psi_analytical_plain(*args, **f, lag_slots=lag_slots, fa_slots=fa_slots)
    if dev.type != "cuda":
        raise ValueError(f"fused psi runs on cpu or cuda tensors, got {dev}")
    from ._build import load_library

    out, kernel = _launch(load_library(), *args, **f, lag_slots=lag_slots,
                          fa_slots=fa_slots, blocks=blocks)
    if kernel == "K1c":
        K1C_LAUNCHES += 1
    elif kernel == "K1b":
        FEATURE_LAUNCHES += 1
    elif kernel == "K1a":
        LAUNCHES += 1
    return out


def _launch(lib, seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma, obs_cens,
            support, structure="two_compartments_with_absorption", obs_outeq=None,
            out_coef=None, out_bias=None, lag_slots=None, fa_slots=None, blocks=None,
            **features):
    """:func:`psi_analytical`'s launch through ``lib``, a loaded build of
    ``csrc/fused_psi.cu`` (``_build.bind_psi_library``), on the tensors'
    device; returns (psi [R, S], the kernel launched: "K1a", "K1b", "K1c",
    or None where there was nothing to launch). Raises if the launch fails.
    A separate function so that the tests can launch a host build of the
    same source on CPU tensors."""
    f = {name: features.get(name) for name in FEATURES}
    sdef, coef, bias, n_out = _check_inputs(
        seg_dt, seg_bolus, seg_rateiv, obs_mask, obs_value, obs_sigma,
        obs_cens, support, structure, obs_outeq, out_coef, out_bias)
    mode, lags, fas, lag_slots, fa_slots = _check_features(
        seg_dt, support, sdef, f, lag_slots, fa_slots)
    R, M = seg_dt.shape
    S = support.shape[0]
    dev = seg_dt.device
    out = torch.empty((R, S), dtype=seg_dt.dtype, device=dev)
    if R == 0 or S == 0:
        return out, None  # nothing to launch
    n_params = sdef["n_params"]
    # the kernel reads parameter rows [n_params, S]: coalesced along supports
    params = support[:, :n_params].t().contiguous()
    is_f64 = int(seg_dt.dtype == torch.float64)
    code = STRUCTURE_CODES[structure]
    feature = any(a is not None for a in f.values())
    k1c = (f["seg_evcode"] is not None or f["seg_postdepth"] is not None
           or lag_slots is not None or fa_slots is not None)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream
                             if dev.type == "cuda" else None)
    base = (_ptr(seg_dt), _ptr(seg_bolus), _ptr(seg_rateiv), _ptr(obs_mask), _ptr(obs_value),
            _ptr(obs_sigma), _ptr(obs_cens), _ptr(obs_outeq if n_out > 1 else None),
            _ptr(params), _ptr(coef), _ptr(bias), _ptr(out))
    # the launch's scratch, which it fills first: the observation terms
    # [R, M] (K1a in float32: the segment records) and [R]
    tier = 2 if k1c else 1 if feature else 0
    terms = torch.empty(lib.fused_psi_terms_size(is_f64, tier, R, M), dtype=seg_dt.dtype,
                        device=dev)
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        if not feature:
            err = lib.fused_psi_launch(is_f64, code, *base, _ptr(terms), R, S, M, n_out,
                                       int(blocks or 0), stream)
        else:
            levels = f["param_levels"] if f["param_levels"] is not None else f["param_planes"]
            L = 0 if levels is None else levels.shape[0]
            # lag and fa as [n, R, S] plane stacks, or without slots one row
            # per support (row stride 0); the slot tables as int32 on the
            # device
            rows = []
            for key, planes, slots in (("lag_plane", lags, lag_slots),
                                       ("fa_plane", fas, fa_slots)):
                one_row = (planes is not None and slots is None
                           and tuple(planes[0].shape) == (1, S))
                f[key] = torch.stack(planes).contiguous() if planes is not None else None
                rows.append(0 if one_row else S)
            slots = [torch.tensor(t, dtype=int_dtype(), device=dev) if t is not None
                     else None for t in (lag_slots, fa_slots)]
            ptrs = (ctypes.c_void_p * (len(FEATURES) + 2))(
                *(a.data_ptr() if a is not None else None
                  for a in list(f.values()) + slots))
            ints = (ctypes.c_int * 4)(MODES[mode], L, *rows)
            # levels mode: the prepared level models, a table the launch fills
            # (its width, the kernel's prepared fields per model)
            table = (torch.empty((L, lib.fused_psi_prep_fields(code), S), dtype=seg_dt.dtype,
                                 device=dev) if mode == "levels" else None)
            err = lib.fused_psi_feature_launch(
                is_f64, code, *base, _ptr(table), _ptr(terms),
                ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(ints, ctypes.c_void_p),
                R, S, M, n_out, int(blocks or 0), stream)
    if err != 0:
        raise RuntimeError(
            f"fused psi kernel launch failed ({structure}, mode {mode}, "
            f"{'K1c' if k1c else 'K1b' if feature else 'K1a'}, R={R}, "
            f"S={S}, M={M}): {lib.fused_psi_error_string(err).decode()}"
        )
    return out, "K1c" if k1c else "K1b" if feature else "K1a"


# ---------------------------------------------------------------------------
# Host-side inputs: output coefficients and segment streams
# ---------------------------------------------------------------------------


class _CheckedParams:
    """Bounds-checking support-row proxy for output-coefficient extraction:
    an out closure reading a support column that doesn't exist raises
    IndexError for static integer indices past the row width."""

    def __init__(self, p):
        self._p = p

    def __getitem__(self, idx):
        n = self._p.shape[0]
        if isinstance(idx, (int, np.integer)):
            if not (-n <= idx < n):
                raise IndexError(
                    f"support column {idx} out of range ({n} support columns)"
                )
        return self._p[idx]

    def __len__(self):
        return self._p.shape[0]

    def __iter__(self):
        return iter(self._p)

    def __getattr__(self, name):
        return getattr(self._p, name)


def extract_linear_out(out_fn, support, n_states: int, n_out: int, cov,
                       dtype=torch.float64, ts=(0.0, 17.31)):
    """Extract per-support linear output coefficients from an out closure.

    Evaluates ``out_fn(e_i, p, t, cov)`` on the state basis per support row
    (``torch.func.vmap`` over supports, on the host) to recover
    ``y = C(p) x + b(p)``; verifies linearity on a fixed state and
    time-invariance at a second t. Returns (C [S, n_out, n_states],
    b [S, n_out]) as float64 numpy, or raises ValueError when the output is
    not linear or not time-invariant.
    """
    from torch.func import vmap

    from ..engine.sim import as_vector

    sp = torch.as_tensor(np.asarray(support, dtype=np.float64)).to(dtype)
    like = torch.zeros((), dtype=dtype)

    def as_vec(v):
        # a list of components (a support batch's tensors, Python constants)
        # is stacked, as the general engine's outputs are
        return as_vector(v, like).reshape(n_out)

    def eval_all(t):
        tt = torch.tensor(t, dtype=dtype)

        def one(p):
            pc = _CheckedParams(p)
            zero = as_vec(out_fn(torch.zeros(n_states, dtype=dtype), pc, tt, cov))
            cols = []
            for i in range(n_states):
                e = torch.zeros(n_states, dtype=dtype)
                e[i] = 1.0
                cols.append(as_vec(out_fn(e, pc, tt, cov)) - zero)
            return torch.stack(cols, dim=1), zero  # [n_out, n_states], [n_out]

        return vmap(one)(sp)

    C, b = eval_all(ts[0])
    C2, b2 = eval_all(ts[1])
    Cn, bn = C.double().numpy(), b.double().numpy()
    scale = np.maximum(np.abs(Cn).max(), 1e-12)
    if (np.abs(C2.double().numpy() - Cn).max() > 1e-5 * scale
            or np.abs(b2.double().numpy() - bn).max() > 1e-5 * scale):
        raise ValueError("output equation depends on t")
    # linearity probe at a fixed non-trivial state
    x_probe = torch.as_tensor(1.0 + np.linspace(0.3, 1.7, n_states)).to(dtype)
    tt0 = torch.tensor(ts[0], dtype=dtype)
    direct = vmap(lambda p: as_vec(out_fn(x_probe, p, tt0, cov)))(sp)
    direct = direct.double().numpy()
    lin = np.einsum("ski,i->sk", Cn, x_probe.double().numpy()) + bn
    denom = np.maximum(np.abs(direct).max(), 1e-12)
    if np.abs(direct - lin).max() > 1e-4 * denom:
        raise ValueError("output equation is not linear in the state")
    return Cn, bn


def segment_schedule(rows, with_ranks: bool = False):
    """Host-side replica of the engine's breakpoint sort (grid.build_segments).

    The order depends on the data only, also under lag: a lagged dose stays
    in its original column and rides the kernel's pending-dose registers, so
    lag never moves a breakpoint of these streams. Returns ``(order,
    t_sorted, seg_dt, is_event)`` each [R, M]: the lexsort permutation,
    sorted breakpoint times, segment spans, and the engine's seq-reset flag
    (rank >= RANK_OBSERVATION); ``with_ranks=True`` appends the sorted
    ranks (inf-end 0, observation 1, bolus 2, inf-start 3).
    """
    from ..config import BIG_TIME

    bolus_t = np.asarray(rows.bolus_t, dtype=np.float64)
    inf_t = np.asarray(rows.inf_t, dtype=np.float64)
    obs_t = np.asarray(rows.obs_t, dtype=np.float64)
    inf_dur = np.asarray(rows.inf_dur, dtype=np.float64)
    inf_end = np.where(inf_t < BIG_TIME / 2, inf_t + inf_dur, inf_t)
    # breakpoints: [obs..., bolus..., inf-start..., inf-end...]; sort by
    # (time, rank) with engine ranks inf-end 0 < obs 1 < bolus 2 < inf-start 3
    times = np.concatenate([obs_t, bolus_t, inf_t, inf_end], axis=1)
    ranks = np.concatenate(
        [
            np.ones_like(obs_t),
            2.0 * np.ones_like(bolus_t),
            3.0 * np.ones_like(inf_t),
            np.zeros_like(inf_end),
        ],
        axis=1,
    )
    order = np.lexsort((ranks, times), axis=1)
    t_sorted = np.take_along_axis(times, order, axis=1)
    rank_sorted = np.take_along_axis(ranks, order, axis=1)
    t_next = np.concatenate([t_sorted[:, 1:], t_sorted[:, -1:]], axis=1)
    live = t_next < BIG_TIME / 2
    seg_dt = np.where(live, np.maximum(t_next - t_sorted, 0.0), 0.0)
    if with_ranks:
        return order, t_sorted, seg_dt, rank_sorted >= 1.0, rank_sorted
    return order, t_sorted, seg_dt, rank_sorted >= 1.0


def streams_from_grid(rows, lowered_em, inputs: Optional[int] = None):
    """Convert stacked host OccasionArrays rows into kernel segment streams.

    ``inputs=None`` (the analytical plan): doses must target input 0 (the
    structure's dose compartment: depot for *_with_absorption, central for
    IV structures) and ``seg_bolus`` / ``seg_rateiv`` are [R, M].
    ``inputs=k`` (the ODE plan): doses may target any input below k, and the
    two dose streams come back stacked per input as [R, M, k].

    Outputs must be linear in the state, with additive or proportional assay
    error. BLOQ/ALOQ-censored observations contribute log CDF/CCDF terms.
    Multi-dose schedules and mixed bolus+infusion regimens are supported; the
    per-segment infusion rate uses the same midpoint containment as the
    general engine. Observation sigmas use each observation's own outeq error
    model (loglik.observation_sigmas parity), so multi-output models work.

    Returns float64 numpy (seg_dt, seg_bolus, seg_rateiv, obs_mask,
    obs_value, obs_sigma, obs_cens, obs_outeq), each [R, M] (the dose
    streams as above). Raises ValueError for a dose into an input outside
    that rule.
    """
    from ..config import BIG_TIME

    bolus_t = np.asarray(rows.bolus_t, dtype=np.float64)
    inf_t = np.asarray(rows.inf_t, dtype=np.float64)
    valid_rows = np.asarray(rows.obs_valid) & np.asarray(rows.obs_has_value)
    real_bolus = bolus_t < BIG_TIME / 2
    bolus_input = np.asarray(rows.bolus_input)
    if inputs is None and np.any(bolus_input[real_bolus] != 0):
        raise ValueError(
            "the fused psi kernel supports boluses into input 0 (the "
            "structure's dose compartment) only"
        )
    if inputs is not None and np.any(bolus_input[real_bolus] >= inputs):
        raise ValueError(f"bolus targets input >= ninput ({inputs})")
    NI = inf_t.shape[1]
    inf_input = np.asarray(rows.inf_input)
    if NI:
        real_inf = inf_t < BIG_TIME / 2
        if inputs is None and np.any(inf_input[real_inf] != 0):
            raise ValueError(
                "the fused psi kernel supports infusions into input 0 "
                "(central) only"
            )
        if inputs is not None and np.any(inf_input[real_inf] >= inputs):
            raise ValueError(f"infusion targets input >= ninput ({inputs})")
    obs_t = np.asarray(rows.obs_t, dtype=np.float64)
    R, NO = obs_t.shape
    inf_dur = np.asarray(rows.inf_dur, dtype=np.float64)
    inf_end = np.where(inf_t < BIG_TIME / 2, inf_t + inf_dur, inf_t)
    order, t_sorted, seg_dt, _ = segment_schedule(rows)

    def scatter(unsorted):
        return np.take_along_axis(unsorted, order, axis=1)

    def with_zero_pads(obs_col, bolus_col):
        return np.concatenate(
            [obs_col, bolus_col, np.zeros((R, 2 * NI))], axis=1
        )

    # padded bolus slots (time >= BIG_TIME) must contribute zero dose — the
    # kernel applies the bolus column even on dt==0 terminal segments
    bolus_amt = np.where(
        bolus_t < BIG_TIME / 2, np.asarray(rows.bolus_amt, dtype=np.float64), 0.0
    )
    if inputs is None:
        seg_bolus = scatter(with_zero_pads(np.zeros_like(obs_t), bolus_amt))
    else:
        seg_bolus = np.stack([
            scatter(with_zero_pads(np.zeros_like(obs_t),
                                   np.where(bolus_input == j, bolus_amt, 0.0)))
            for j in range(inputs)
        ], axis=-1)  # [R, M, inputs]
    # per-segment infusion rate: midpoint containment (engine parity)
    if NI:
        rate = np.where(
            (inf_t < BIG_TIME / 2) & (inf_dur > 0),
            np.asarray(rows.inf_amt, dtype=np.float64) / np.maximum(inf_dur, 1e-300),
            0.0,
        )
        mid = t_sorted + 0.5 * seg_dt  # [R, M]
        contained = (
            (mid[:, :, None] >= inf_t[:, None, :])
            & (mid[:, :, None] < inf_end[:, None, :])
            & (seg_dt[:, :, None] > 0)
        )
        contained = contained.astype(np.float64)
        if inputs is None:
            seg_rateiv = np.einsum("rmi,ri->rm", contained, rate)
        else:
            seg_rateiv = np.stack([
                np.einsum("rmi,ri->rm", contained,
                          np.where(inf_input == j, rate, 0.0))
                for j in range(inputs)
            ], axis=-1)  # [R, M, inputs]
    elif inputs is None:
        seg_rateiv = np.zeros_like(seg_dt)
    else:
        seg_rateiv = np.zeros(seg_dt.shape + (inputs,))
    obs_value_u = np.asarray(rows.obs_value, dtype=np.float64)
    # observation-based sigma from each observation's outeq error model;
    # per-observation errorpoly overrides replace the poly, keeping
    # kind/factor (loglik.observation_sigmas parity)
    outeq_u = np.asarray(rows.obs_outeq, dtype=np.int64)
    kind = np.asarray(lowered_em.kind)[outeq_u]          # [R, NO]
    factor = np.asarray(lowered_em.factor, dtype=np.float64)[outeq_u]
    shared_poly = np.asarray(lowered_em.poly, dtype=np.float64)[outeq_u]
    poly = np.where(
        np.asarray(rows.obs_has_poly)[:, :, None],
        np.asarray(rows.obs_poly, dtype=np.float64),
        shared_poly,
    )
    alpha = (poly[..., 0] + poly[..., 1] * obs_value_u
             + poly[..., 2] * obs_value_u**2 + poly[..., 3] * obs_value_u**3)
    sigma_u = np.where(
        kind == 1, np.sqrt(alpha**2 + factor**2), factor * alpha
    )
    seg_mask = scatter(with_zero_pads(valid_rows.astype(np.float64),
                                      np.zeros_like(bolus_t)))
    seg_value = scatter(with_zero_pads(obs_value_u, np.zeros_like(bolus_t)))
    seg_sigma = scatter(with_zero_pads(sigma_u, np.zeros_like(bolus_t)))
    seg_sigma = np.where(seg_mask > 0, seg_sigma, 1.0)
    # censoring sign: +1 BLOQ (logCDF), -1 ALOQ (logCCDF), 0 uncensored
    cens_code = np.asarray(rows.obs_cens, dtype=np.int64)
    cens_sign = np.where(cens_code == 1, 1.0, np.where(cens_code == 2, -1.0, 0.0))
    cens_sign = np.where(valid_rows, cens_sign, 0.0)
    seg_cens = scatter(with_zero_pads(cens_sign, np.zeros_like(bolus_t)))
    seg_outeq = scatter(
        with_zero_pads(outeq_u.astype(np.float64), np.zeros_like(bolus_t))
    )
    return (seg_dt, seg_bolus, seg_rateiv, seg_mask, seg_value, seg_sigma,
            seg_cens, seg_outeq)
