"""Per-observation and per-occasion log-likelihood on batched tensors.

Combines the lowered assay error models (per-outeq kind/factor/poly
tensors) with censoring-aware normal densities:

- Censor NONE -> lognormpdf, BLOQ -> lognormcdf, ALOQ -> lognormccdf
  (prediction.rs:105-125);
- sigma is observation-based: alpha = poly(obs);
  additive sigma = sqrt(alpha² + lambda²), proportional sigma = gamma·alpha
  (error_model.rs:1060-1072);
- per-observation ErrorPoly overrides beat the model default;
- missing observations contribute 0 (log 1), as does padding.

Every function takes tensors with any leading batch axes (rows).
"""

from __future__ import annotations

import torch

from ..data.error_model import KIND_ADDITIVE
from .distributions import lognormccdf, lognormcdf, lognormpdf


def observation_sigmas(occ, em_kind, em_factor, em_poly):
    """Observation-based sigma for occasion rows.

    ``occ``: OccasionArrays of tensors ([..., NO] observation fields);
    ``em_*``: lowered error-model tensors [nout] / [nout, 4]. Returns
    ``(sigma, active)`` [..., NO]: sigma is 1.0 on missing/padded slots so
    downstream math stays finite; those slots are masked out of the sum.
    """
    fd = occ.obs_value.dtype
    outeq = occ.obs_outeq
    kind = em_kind[outeq]
    factor = em_factor[outeq].to(fd)
    poly = torch.where(
        occ.obs_has_poly[..., None], occ.obs_poly.to(fd), em_poly[outeq].to(fd)
    )  # [..., NO, 4]
    v = occ.obs_value
    alpha = (poly[..., 0] + poly[..., 1] * v + poly[..., 2] * v**2
             + poly[..., 3] * v**3)
    sigma_add = torch.sqrt(alpha**2 + factor**2)
    sigma_prop = factor * alpha
    sigma = torch.where(kind == KIND_ADDITIVE, sigma_add, sigma_prop)
    active = occ.obs_valid & occ.obs_has_value & (kind != 0)
    return torch.where(active, sigma, torch.ones_like(sigma)), active


def observation_log_likelihood(value, pred, sigma, cens_code):
    """Per-observation log-likelihood by censoring code (0/1 BLOQ/2 ALOQ)."""
    ll_none = lognormpdf(value, pred, sigma)
    ll_bloq = lognormcdf(value, pred, sigma)
    ll_aloq = lognormccdf(value, pred, sigma)
    return torch.where(cens_code == 1, ll_bloq,
                       torch.where(cens_code == 2, ll_aloq, ll_none))


def occasion_log_likelihood(occ, pred, em_kind, em_factor, em_poly):
    """Sum over observation slots of the per-observation log-likelihood.

    ``pred`` [..., NO] are the simulated predictions. Observations with no
    value, padding slots, and outeqs with error model None contribute zero.
    """
    sigma, active = observation_sigmas(occ, em_kind, em_factor, em_poly)
    ll = observation_log_likelihood(occ.obs_value, pred, sigma, occ.obs_cens)
    return torch.where(active, ll, torch.zeros_like(ll)).sum(dim=-1)
