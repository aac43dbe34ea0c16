"""Numerically stable normal log-densities for likelihood calculations.

Parity with the reference's likelihood/distributions.rs:31-102 and the JAX
package. ``torch.special.log_ndtr`` is exact and stable over the whole
range, which subsumes the reference's asymptotic tail patch below z = -37.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def lognormpdf(obs, pred, sigma):
    """log N(obs; pred, sigma) — distributions.rs:31-35."""
    diff = obs - pred
    return -0.5 * LOG_2PI - torch.log(sigma) - diff * diff / (2.0 * sigma * sigma)


def lognormcdf(obs, pred, sigma):
    """log Phi((obs-pred)/sigma): BLOQ likelihood — distributions.rs:53-73."""
    return torch.special.log_ndtr((obs - pred) / sigma)


def lognormccdf(obs, pred, sigma):
    """log (1 - Phi(z)): ALOQ likelihood — distributions.rs:86-102."""
    return torch.special.log_ndtr(-(obs - pred) / sigma)
