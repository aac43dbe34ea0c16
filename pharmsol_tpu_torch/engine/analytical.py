"""Closed-form compartmental kernels as PyTorch functions.

Each kernel advances the state over one smooth segment of length ``dt`` with
constant infusion rate ``rateiv``:  ``x(dt) = A(dt) @ x(0) + forcing(dt)``.
The signatures are the JAX package's (its ``engine/analytical.py``),
written for one (state, parameter) pair; the engine evaluates them batched
over supports and rows through ``torch.func.vmap``.

- ``one_compartment``            p = [ke],                x dim 1
- ``one_compartment_with_absorption``  p = [ka, ke],      x dim 2
- ``two_compartments``           p = [ke, kcp, kpc],      x dim 2
- ``two_compartments_with_absorption`` p = [ke, ka, kcp, kpc], x dim 3
- ``three_compartments``         p = [k10, k12, k13, k21, k31], x dim 3
- ``three_compartments_with_absorption`` p = [ka, k10, k12, k13, k21, k31], x dim 4
- ``*_cl`` variants re-parameterize to CL/V and delegate
  (one_compartment_cl_models.rs:16-45 etc.).

Divergence note (as in the JAX package): where the reference panics on a
negative 2-cmt discriminant or positive 3-cmt cubic ``q`` ("Imaginary
solutions"), these kernels clamp at zero.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "one_compartment",
    "one_compartment_with_absorption",
    "one_compartment_cl",
    "one_compartment_cl_with_absorption",
    "two_compartments",
    "two_compartments_with_absorption",
    "two_compartments_cl",
    "two_compartments_cl_with_absorption",
    "three_compartments",
    "three_compartments_with_absorption",
    "three_compartments_cl",
    "three_compartments_cl_with_absorption",
    "KERNELS",
]


# -- one compartment -----------------------------------------------------------


def one_compartment(x, p, t, rateiv, cov=None):
    """1-cmt IV: x dim 1, p = [ke], rateiv dim >= 1."""
    ke = p[0]
    e = torch.exp(-ke * t)
    return torch.stack([x[0] * e + rateiv[0] / ke * (1.0 - e)])


def one_compartment_with_absorption(x, p, t, rateiv, cov=None):
    """1-cmt oral: x = [depot, central], p = [ka, ke]."""
    ka, ke = p[0], p[1]
    eka = torch.exp(-ka * t)
    eke = torch.exp(-ke * t)
    depot = x[0] * eka
    central = (
        x[1] * eke
        + rateiv[0] / ke * (1.0 - eke)
        + (ka * x[0]) / (ka - ke) * (eke - eka)
    )
    return torch.stack([depot, central])


def one_compartment_cl(x, p, t, rateiv, cov=None):
    """p = [cl, v] -> ke = cl/v."""
    ke = p[0] / p[1]
    return one_compartment(x, torch.stack([ke]), t, rateiv, cov)


def one_compartment_cl_with_absorption(x, p, t, rateiv, cov=None):
    """p = [ka, cl, v]."""
    ka = p[0]
    ke = p[1] / p[2]
    return one_compartment_with_absorption(x, torch.stack([ka, ke]), t, rateiv, cov)


# -- two compartments -----------------------------------------------------------


def _two_cmt_core(x2, ke, kcp, kpc, t, rate):
    """Eigen solution for the central/peripheral pair; returns [2]."""
    disc = (ke + kcp + kpc) ** 2 - 4.0 * ke * kpc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    l1 = (ke + kcp + kpc + sq) / 2.0
    l2 = (ke + kcp + kpc - sq) / 2.0
    e1 = torch.exp(-l1 * t)
    e2 = torch.exp(-l2 * t)
    denom = l1 - l2
    a11 = (l1 - kpc) * e1 + (kpc - l2) * e2
    a12 = -kpc * e1 + kpc * e2
    a21 = -kcp * e1 + kcp * e2
    a22 = (l1 - ke - kcp) * e1 + (ke + kcp - l2) * e2
    hom0 = (a11 * x2[0] + a12 * x2[1]) / denom
    hom1 = (a21 * x2[0] + a22 * x2[1]) / denom
    inf0 = ((l1 - kpc) / l1) * (1.0 - e1) + ((kpc - l2) / l2) * (1.0 - e2)
    inf1 = (-kcp / l1) * (1.0 - e1) + (kcp / l2) * (1.0 - e2)
    scale = rate / denom
    return torch.stack([hom0 + inf0 * scale, hom1 + inf1 * scale]), (l1, l2, e1, e2, denom)


def two_compartments(x, p, t, rateiv, cov=None):
    """2-cmt IV: x = [central, peripheral], p = [ke, kcp, kpc]."""
    out, _ = _two_cmt_core(x, p[0], p[1], p[2], t, rateiv[0])
    return out


def two_compartments_with_absorption(x, p, t, rateiv, cov=None):
    """2-cmt oral: x = [depot, central, peripheral], p = [ke, ka, kcp, kpc]."""
    ke, ka, kcp, kpc = p[0], p[1], p[2], p[3]
    core, (l1, l2, e1, e2, denom) = _two_cmt_core(
        x[1:3], ke, kcp, kpc, t, rateiv[0]
    )
    eka = torch.exp(-ka * t)
    abs0 = ((l1 - kpc) / (ka - l1)) * (e1 - eka) + ((kpc - l2) / (ka - l2)) * (e2 - eka)
    abs1 = (-kcp / (ka - l1)) * (e1 - eka) + (kcp / (ka - l2)) * (e2 - eka)
    scale = ka * x[0] / denom
    return torch.stack([x[0] * eka, core[0] + abs0 * scale, core[1] + abs1 * scale])


def two_compartments_cl(x, p, t, rateiv, cov=None):
    """p = [cl, q, vc, vp]."""
    cl, q, vc, vp = p[0], p[1], p[2], p[3]
    return two_compartments(x, torch.stack([cl / vc, q / vc, q / vp]), t, rateiv, cov)


def two_compartments_cl_with_absorption(x, p, t, rateiv, cov=None):
    """p = [ka, cl, q, vc, vp]."""
    ka, cl, q, vc, vp = p[0], p[1], p[2], p[3], p[4]
    return two_compartments_with_absorption(
        x, torch.stack([cl / vc, ka, q / vc, q / vp]), t, rateiv, cov
    )


# -- three compartments -----------------------------------------------------------


def _three_cmt_eigs(k10, k12, k13, k21, k31):
    """Real eigenvalues of the 3-cmt mamillary rate matrix via the
    trigonometric cubic solution (three_compartment_models.rs:24-45)."""
    a = k10 + k12 + k13 + k21 + k31
    b = k10 * k21 + k13 * k21 + k10 * k31 + k12 * k31 + k21 * k31
    c = k10 * k21 * k31
    m = (3.0 * b - a**2) / 3.0
    n = (2.0 * a**3 - 9.0 * a * b + 27.0 * c) / 27.0
    q = n**2 / 4.0 + m**3 / 27.0
    alpha = torch.sqrt(torch.clamp(-q, min=0.0))
    beta = -n / 2.0
    gamma = torch.sqrt(beta**2 + alpha**2)
    theta = torch.atan2(alpha, beta)
    g3 = gamma ** (1.0 / 3.0)
    ct = torch.cos(theta / 3.0)
    st = torch.sin(theta / 3.0)
    sqrt3 = math.sqrt(3.0)
    l1 = a / 3.0 + g3 * (ct + sqrt3 * st)
    l2 = a / 3.0 + g3 * (ct - sqrt3 * st)
    l3 = a / 3.0 - 2.0 * g3 * ct
    return l1, l2, l3


def _three_cmt_core(x3, k10, k12, k13, k21, k31, t, rate):
    l1, l2, l3 = _three_cmt_eigs(k10, k12, k13, k21, k31)
    e1 = torch.exp(-l1 * t)
    e2 = torch.exp(-l2 * t)
    e3 = torch.exp(-l3 * t)
    d1 = (l2 - l1) * (l3 - l1)
    d2 = (l1 - l2) * (l3 - l2)
    d3 = (l1 - l3) * (l2 - l3)

    def row(f1, f2, f3):
        return f1 / d1, f2 / d2, f3 / d3

    c1, c2, c3 = row((k21 - l1) * (k31 - l1), (k21 - l2) * (k31 - l2), (k21 - l3) * (k31 - l3))
    c4, c5, c6 = row(k21 * (k31 - l1), k21 * (k31 - l2), k21 * (k31 - l3))
    c7, c8, c9 = row(k31 * (k21 - l1), k31 * (k21 - l2), k31 * (k21 - l3))
    c10, c11, c12 = row(k12 * (k31 - l1), k12 * (k31 - l2), k12 * (k31 - l3))
    c13, c14, c15 = row(
        (k10 + k12 + k13 - l1) * (k31 - l1) - k13 * k31,
        (k10 + k12 + k13 - l2) * (k31 - l2) - k13 * k31,
        (k10 + k12 + k13 - l3) * (k31 - l3) - k13 * k31,
    )
    c16, c17, c18 = row(k12 * k31, k12 * k31, k12 * k31)
    c19, c20, c21 = row(k13 * (k21 - l1), k13 * (k21 - l2), k13 * (k21 - l3))
    c22, c23, c24 = row(k21 * k13, k21 * k13, k21 * k13)
    c25, c26, c27 = row(
        (k10 + k12 + k13 - l1) * (k21 - l1) - k12 * k21,
        (k10 + k12 + k13 - l2) * (k21 - l2) - k12 * k21,
        (k10 + k12 + k13 - l3) * (k21 - l3) - k12 * k21,
    )

    m = torch.stack(
        [
            torch.stack([c1 * e1 + c2 * e2 + c3 * e3, c4 * e1 + c5 * e2 + c6 * e3, c7 * e1 + c8 * e2 + c9 * e3]),
            torch.stack([c10 * e1 + c11 * e2 + c12 * e3, c13 * e1 + c14 * e2 + c15 * e3, c16 * e1 + c17 * e2 + c18 * e3]),
            torch.stack([c19 * e1 + c20 * e2 + c21 * e3, c22 * e1 + c23 * e2 + c24 * e3, c25 * e1 + c26 * e2 + c27 * e3]),
        ]
    )
    hom = torch.matmul(m, x3)
    inf = torch.stack(
        [
            (1.0 - e1) * c1 / l1 + (1.0 - e2) * c2 / l2 + (1.0 - e3) * c3 / l3,
            (1.0 - e1) * c10 / l1 + (1.0 - e2) * c11 / l2 + (1.0 - e3) * c12 / l3,
            (1.0 - e1) * c19 / l1 + (1.0 - e2) * c20 / l2 + (1.0 - e3) * c21 / l3,
        ]
    )
    return hom + inf * rate, (l1, l2, l3, e1, e2, e3, c1, c2, c3, c10, c11, c12, c19, c20, c21)


def three_compartments(x, p, t, rateiv, cov=None):
    """3-cmt IV: x dim 3, p = [k10, k12, k13, k21, k31]."""
    out, _ = _three_cmt_core(x, p[0], p[1], p[2], p[3], p[4], t, rateiv[0])
    return out


def three_compartments_with_absorption(x, p, t, rateiv, cov=None):
    """3-cmt oral: x = [depot, c1, c2, c3], p = [ka, k10, k12, k13, k21, k31]."""
    ka = p[0]
    core, aux = _three_cmt_core(x[1:4], p[1], p[2], p[3], p[4], p[5], t, rateiv[0])
    (l1, l2, l3, e1, e2, e3, c1, c2, c3, c10, c11, c12, c19, c20, c21) = aux
    eka = torch.exp(-ka * t)
    g1 = (e1 - eka) / (ka - l1)
    g2 = (e2 - eka) / (ka - l2)
    g3 = (e3 - eka) / (ka - l3)
    absb = torch.stack(
        [
            g1 * c1 + g2 * c2 + g3 * c3,
            g1 * c10 + g2 * c11 + g3 * c12,
            g1 * c19 + g2 * c20 + g3 * c21,
        ]
    )
    scale = ka * x[0]
    res = core + absb * scale
    return torch.stack([x[0] * eka, res[0], res[1], res[2]])


def three_compartments_cl(x, p, t, rateiv, cov=None):
    """p = [cl, q1, q2, vc, vp1, vp2] -> micro constants.

    Parity: three_compartment_cl_models.rs:16-45.
    """
    cl, q1, q2, vc, vp1, vp2 = p[0], p[1], p[2], p[3], p[4], p[5]
    k10 = cl / vc
    k12 = q1 / vc
    k21 = q1 / vp1
    k13 = q2 / vc
    k31 = q2 / vp2
    return three_compartments(x, torch.stack([k10, k12, k13, k21, k31]), t, rateiv, cov)


def three_compartments_cl_with_absorption(x, p, t, rateiv, cov=None):
    """p = [ka, cl, q1, q2, vc, vp1, vp2]."""
    ka, cl, q1, q2, vc, vp1, vp2 = p[0], p[1], p[2], p[3], p[4], p[5], p[6]
    k10 = cl / vc
    k12 = q1 / vc
    k21 = q1 / vp1
    k13 = q2 / vc
    k31 = q2 / vp2
    return three_compartments_with_absorption(
        x, torch.stack([ka, k10, k12, k13, k21, k31]), t, rateiv, cov
    )


# Registry: kernel name -> (fn, nstates, nparams). Names match the
# AnalyticalKernel enum / DSL `structure:` identifiers.
KERNELS = {
    "one_compartment": (one_compartment, 1, 1),
    "one_compartment_with_absorption": (one_compartment_with_absorption, 2, 2),
    "one_compartment_cl": (one_compartment_cl, 1, 2),
    "one_compartment_cl_with_absorption": (one_compartment_cl_with_absorption, 2, 3),
    "two_compartments": (two_compartments, 2, 3),
    "two_compartments_with_absorption": (two_compartments_with_absorption, 3, 4),
    "two_compartments_cl": (two_compartments_cl, 2, 4),
    "two_compartments_cl_with_absorption": (two_compartments_cl_with_absorption, 3, 5),
    "three_compartments": (three_compartments, 3, 5),
    "three_compartments_with_absorption": (three_compartments_with_absorption, 4, 6),
    "three_compartments_cl": (three_compartments_cl, 3, 6),
    "three_compartments_cl_with_absorption": (three_compartments_cl_with_absorption, 4, 7),
}


# ---------------------------------------------------------------------------
# Prepared kernels: split parameter-only work (eigenvalues, coefficient
# ratios) from per-segment work (exponentials). When a model has no
# secondary equations, parameters are constant across a subject's segments,
# so `prepare` hoists out of the lax.scan and each segment only pays for its
# exponentials. Biggest effect on the 3-cmt kernels (cubic roots + 27
# coefficient divisions per segment otherwise).
# ---------------------------------------------------------------------------


def _one_cmt_prepare(p):
    return (p[0],)


def _one_cmt_apply(aux, x, t, rateiv):
    (ke,) = aux
    e = torch.exp(-ke * t)
    return torch.stack([x[0] * e + rateiv[0] / ke * (1.0 - e)])


def _one_cmt_abs_prepare(p):
    ka, ke = p[0], p[1]
    return (ka, ke, ka / (ka - ke))


def _one_cmt_abs_apply(aux, x, t, rateiv):
    ka, ke, ratio = aux
    eka = torch.exp(-ka * t)
    eke = torch.exp(-ke * t)
    return torch.stack(
        [
            x[0] * eka,
            x[1] * eke + rateiv[0] / ke * (1.0 - eke) + ratio * x[0] * (eke - eka),
        ]
    )


def _two_cmt_prepare_core(ke, kcp, kpc):
    disc = (ke + kcp + kpc) ** 2 - 4.0 * ke * kpc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    l1 = (ke + kcp + kpc + sq) / 2.0
    l2 = (ke + kcp + kpc - sq) / 2.0
    inv_denom = 1.0 / (l1 - l2)
    return (l1, l2, inv_denom, 1.0 / l1, 1.0 / l2, ke, kcp, kpc)


def _two_cmt_apply_core(aux, x0, x1, t, rate):
    l1, l2, inv_denom, inv_l1, inv_l2, ke, kcp, kpc = aux
    e1 = torch.exp(-l1 * t)
    e2 = torch.exp(-l2 * t)
    hom0 = ((l1 - kpc) * e1 + (kpc - l2) * e2) * x0 + (-kpc * e1 + kpc * e2) * x1
    hom1 = (-kcp * e1 + kcp * e2) * x0 + ((l1 - ke - kcp) * e1 + (ke + kcp - l2) * e2) * x1
    inf0 = (l1 - kpc) * inv_l1 * (1.0 - e1) + (kpc - l2) * inv_l2 * (1.0 - e2)
    inf1 = -kcp * inv_l1 * (1.0 - e1) + kcp * inv_l2 * (1.0 - e2)
    return (
        (hom0 + inf0 * rate) * inv_denom,
        (hom1 + inf1 * rate) * inv_denom,
        (e1, e2),
    )


def _two_cmt_prepare(p):
    return _two_cmt_prepare_core(p[0], p[1], p[2])


def _two_cmt_apply(aux, x, t, rateiv):
    a, b, _ = _two_cmt_apply_core(aux, x[0], x[1], t, rateiv[0])
    return torch.stack([a, b])


def _two_cmt_abs_prepare(p):
    ke, ka, kcp, kpc = p[0], p[1], p[2], p[3]
    core = _two_cmt_prepare_core(ke, kcp, kpc)
    l1, l2 = core[0], core[1]
    return core + (ka, 1.0 / (ka - l1), 1.0 / (ka - l2))


def _two_cmt_abs_apply(aux, x, t, rateiv):
    core = aux[:8]
    ka, inv_ka_l1, inv_ka_l2 = aux[8], aux[9], aux[10]
    l1, l2, inv_denom = core[0], core[1], core[2]
    ke, kcp, kpc = core[5], core[6], core[7]
    a, b, (e1, e2) = _two_cmt_apply_core(core, x[1], x[2], t, rateiv[0])
    eka = torch.exp(-ka * t)
    abs0 = (l1 - kpc) * inv_ka_l1 * (e1 - eka) + (kpc - l2) * inv_ka_l2 * (e2 - eka)
    abs1 = -kcp * inv_ka_l1 * (e1 - eka) + kcp * inv_ka_l2 * (e2 - eka)
    scale = ka * x[0] * inv_denom
    return torch.stack([x[0] * eka, a + abs0 * scale, b + abs1 * scale])


def _three_cmt_prepare_core(k10, k12, k13, k21, k31):
    l1, l2, l3 = _three_cmt_eigs(k10, k12, k13, k21, k31)
    d1 = 1.0 / ((l2 - l1) * (l3 - l1))
    d2 = 1.0 / ((l1 - l2) * (l3 - l2))
    d3 = 1.0 / ((l1 - l3) * (l2 - l3))
    c = {}
    c[1], c[2], c[3] = (k21 - l1) * (k31 - l1) * d1, (k21 - l2) * (k31 - l2) * d2, (k21 - l3) * (k31 - l3) * d3
    c[4], c[5], c[6] = k21 * (k31 - l1) * d1, k21 * (k31 - l2) * d2, k21 * (k31 - l3) * d3
    c[7], c[8], c[9] = k31 * (k21 - l1) * d1, k31 * (k21 - l2) * d2, k31 * (k21 - l3) * d3
    c[10], c[11], c[12] = k12 * (k31 - l1) * d1, k12 * (k31 - l2) * d2, k12 * (k31 - l3) * d3
    s = k10 + k12 + k13
    c[13] = ((s - l1) * (k31 - l1) - k13 * k31) * d1
    c[14] = ((s - l2) * (k31 - l2) - k13 * k31) * d2
    c[15] = ((s - l3) * (k31 - l3) - k13 * k31) * d3
    c[16], c[17], c[18] = k12 * k31 * d1, k12 * k31 * d2, k12 * k31 * d3
    c[19], c[20], c[21] = k13 * (k21 - l1) * d1, k13 * (k21 - l2) * d2, k13 * (k21 - l3) * d3
    c[22], c[23], c[24] = k21 * k13 * d1, k21 * k13 * d2, k21 * k13 * d3
    c[25] = ((s - l1) * (k21 - l1) - k12 * k21) * d1
    c[26] = ((s - l2) * (k21 - l2) - k12 * k21) * d2
    c[27] = ((s - l3) * (k21 - l3) - k12 * k21) * d3
    coeffs = torch.stack([c[i] for i in range(1, 28)])
    return (l1, l2, l3, 1.0 / l1, 1.0 / l2, 1.0 / l3, coeffs)


def _three_cmt_apply_core(aux, x3, t, rate):
    l1, l2, l3, il1, il2, il3, c = aux
    e1 = torch.exp(-l1 * t)
    e2 = torch.exp(-l2 * t)
    e3 = torch.exp(-l3 * t)

    def row(i):  # c indices are 1-based in the reference derivation
        return (
            (c[i - 1] * e1 + c[i] * e2 + c[i + 1] * e3),
            (c[i + 2] * e1 + c[i + 3] * e2 + c[i + 4] * e3),
            (c[i + 5] * e1 + c[i + 6] * e2 + c[i + 7] * e3),
        )

    m11, m12, m13 = row(1)
    m21, m22, m23 = row(10)
    m31, m32, m33 = row(19)
    hom = (
        m11 * x3[0] + m12 * x3[1] + m13 * x3[2],
        m21 * x3[0] + m22 * x3[1] + m23 * x3[2],
        m31 * x3[0] + m32 * x3[1] + m33 * x3[2],
    )
    inf = (
        (1.0 - e1) * c[0] * il1 + (1.0 - e2) * c[1] * il2 + (1.0 - e3) * c[2] * il3,
        (1.0 - e1) * c[9] * il1 + (1.0 - e2) * c[10] * il2 + (1.0 - e3) * c[11] * il3,
        (1.0 - e1) * c[18] * il1 + (1.0 - e2) * c[19] * il2 + (1.0 - e3) * c[20] * il3,
    )
    return (
        hom[0] + inf[0] * rate,
        hom[1] + inf[1] * rate,
        hom[2] + inf[2] * rate,
        (e1, e2, e3),
    )


def _three_cmt_prepare(p):
    return _three_cmt_prepare_core(p[0], p[1], p[2], p[3], p[4])


def _three_cmt_apply(aux, x, t, rateiv):
    a, b, cc, _ = _three_cmt_apply_core(aux, x, t, rateiv[0])
    return torch.stack([a, b, cc])


def _three_cmt_abs_prepare(p):
    ka = p[0]
    core = _three_cmt_prepare_core(p[1], p[2], p[3], p[4], p[5])
    l1, l2, l3 = core[0], core[1], core[2]
    return core + (ka, 1.0 / (ka - l1), 1.0 / (ka - l2), 1.0 / (ka - l3))


def _three_cmt_abs_apply(aux, x, t, rateiv):
    core = aux[:7]
    ka, ik1, ik2, ik3 = aux[7], aux[8], aux[9], aux[10]
    c = core[6]
    a, b, cc, (e1, e2, e3) = _three_cmt_apply_core(core, x[1:4], t, rateiv[0])
    eka = torch.exp(-ka * t)
    g1 = (e1 - eka) * ik1
    g2 = (e2 - eka) * ik2
    g3 = (e3 - eka) * ik3
    scale = ka * x[0]
    return torch.stack(
        [
            x[0] * eka,
            a + (g1 * c[0] + g2 * c[1] + g3 * c[2]) * scale,
            b + (g1 * c[9] + g2 * c[10] + g3 * c[11]) * scale,
            cc + (g1 * c[18] + g2 * c[19] + g3 * c[20]) * scale,
        ]
    )


def _cl_reparam(prepare, mapping):
    """Wrap a prepare fn with a CL/V -> micro-constant reparameterization."""

    def prep(p):
        return prepare(torch.stack(mapping(p)))

    return prep


PREPARED_KERNELS = {
    "one_compartment": (_one_cmt_prepare, _one_cmt_apply),
    "one_compartment_with_absorption": (_one_cmt_abs_prepare, _one_cmt_abs_apply),
    "one_compartment_cl": (
        _cl_reparam(_one_cmt_prepare, lambda p: [p[0] / p[1]]),
        _one_cmt_apply,
    ),
    "one_compartment_cl_with_absorption": (
        _cl_reparam(_one_cmt_abs_prepare, lambda p: [p[0], p[1] / p[2]]),
        _one_cmt_abs_apply,
    ),
    "two_compartments": (_two_cmt_prepare, _two_cmt_apply),
    "two_compartments_with_absorption": (_two_cmt_abs_prepare, _two_cmt_abs_apply),
    "two_compartments_cl": (
        _cl_reparam(_two_cmt_prepare, lambda p: [p[0] / p[2], p[1] / p[2], p[1] / p[3]]),
        _two_cmt_apply,
    ),
    "two_compartments_cl_with_absorption": (
        _cl_reparam(
            _two_cmt_abs_prepare,
            lambda p: [p[1] / p[3], p[0], p[2] / p[3], p[2] / p[4]],
        ),
        _two_cmt_abs_apply,
    ),
    "three_compartments": (_three_cmt_prepare, _three_cmt_apply),
    "three_compartments_with_absorption": (_three_cmt_abs_prepare, _three_cmt_abs_apply),
    "three_compartments_cl": (
        _cl_reparam(
            _three_cmt_prepare,
            lambda p: [p[0] / p[3], p[1] / p[3], p[2] / p[3], p[1] / p[4], p[2] / p[5]],
        ),
        _three_cmt_apply,
    ),
    "three_compartments_cl_with_absorption": (
        _cl_reparam(
            _three_cmt_abs_prepare,
            lambda p: [
                p[0],
                p[1] / p[4],
                p[2] / p[4],
                p[3] / p[4],
                p[2] / p[5],
                p[3] / p[6],
            ],
        ),
        _three_cmt_abs_apply,
    ),
}

# kernel function object -> prepared pair, for spec construction
PREPARED_BY_FN = {KERNELS[name][0]: pair for name, pair in PREPARED_KERNELS.items()}
