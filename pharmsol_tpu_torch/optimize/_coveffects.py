"""Covariate effects on typical values for the parametric estimators.

NONMEM-style covariate modeling: the transformed-scale population mean of
parameter ``j`` becomes ``mu_j + sum_k beta_k * g_k(cov)`` per subject,
where each effect contributes one fitted coefficient. Forms:

- ``'power'``: g = log(cov / ref). On a log-transformed parameter this is
  the classic allometric/power model ``theta * (cov/ref)**beta`` (e.g.
  ``CL ~ theta1 * (WT/70)**0.75``).
- ``'linear'``: g = cov - ref (additive on the transformed scale; on a
  log parameter this is ``theta * exp(beta*(cov-ref))``).

Baseline covariate values are read host-side at t=0 of each subject's
first occasion (the engine's carry semantics apply — covariate.rs
boundary behavior). Both SAEM (closed-form GLS M-step per parameter row)
and Laplace (beta as free psi coordinates) consume the same spec.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from ..errors import PharmsolError

_FORMS = ("power", "linear")


class CovariateEffects(NamedTuple):
    """Resolved covariate-effect design (host-side, static)."""

    specs: tuple         # ((param_idx, cov_name, form, ref), ...)
    labels: tuple        # human labels, e.g. "ke~crcl(power,ref=100)"
    x: np.ndarray        # [n_sub, n_eff] transformed covariate values g(cov)
    param_idx: np.ndarray  # [n_eff] target parameter per effect
    onehot: np.ndarray   # [n_eff, p] scatter matrix: m = mu + (x*beta) @ onehot

    @property
    def n_eff(self) -> int:
        return len(self.specs)


def resolve_covariate_effects(
    covariate_effects: Optional[Sequence],
    subjects,
    p: int,
    names: Optional[tuple],
) -> Optional[CovariateEffects]:
    """Validate effect specs and evaluate baseline covariates per subject.

    Each spec is ``(parameter, covariate, form)`` or
    ``(parameter, covariate, form, reference)``; parameter is an index or
    a name (names require model metadata / dict theta0). Returns None for
    an empty spec list.
    """
    if not covariate_effects:
        return None
    specs = []
    labels = []
    for spec in covariate_effects:
        spec = tuple(spec)
        if len(spec) == 3:
            param, cov_name, form = spec
            ref = None
        elif len(spec) == 4:
            param, cov_name, form, ref = spec
        else:
            raise PharmsolError(
                "each covariate effect must be (parameter, covariate, "
                "form[, reference])"
            )
        if form not in _FORMS:
            raise PharmsolError(
                f"covariate-effect form must be one of {_FORMS}, got "
                f"{form!r}"
            )
        if isinstance(param, str):
            if names is None or param not in names:
                raise PharmsolError(
                    f"named covariate-effect parameter {param!r} needs "
                    f"model metadata (known: {list(names) if names else '-'})"
                )
            j = names.index(param)
        else:
            j = int(param)
            if not 0 <= j < p:
                raise PharmsolError(
                    f"covariate-effect parameter index {j} out of range "
                    f"for {p} parameters"
                )
        specs.append((j, str(cov_name), form, ref))

    n_sub = len(subjects)
    n_eff = len(specs)
    raw = np.zeros((n_sub, n_eff), dtype=np.float64)
    for i, subject in enumerate(subjects):
        occs = subject.occasions()
        covs = occs[0].get_covariates() if occs else None
        for k, (_, cov_name, _, _) in enumerate(specs):
            if covs is None or covs.get(cov_name) is None:
                raise PharmsolError(
                    f"subject {subject.id} has no covariate "
                    f"{cov_name!r} (needed by a covariate effect)"
                )
            raw[i, k] = float(covs.interpolate(cov_name, 0.0))

    # default reference = population median of the raw covariate
    final_specs = []
    x = np.zeros_like(raw)
    for k, (j, cov_name, form, ref) in enumerate(specs):
        if ref is None:
            ref = float(np.median(raw[:, k]))
        ref = float(ref)
        if form == "power":
            if ref <= 0 or np.any(raw[:, k] <= 0):
                raise PharmsolError(
                    f"'power' covariate effect on {cov_name!r} needs "
                    f"positive covariate values and reference"
                )
            x[:, k] = np.log(raw[:, k] / ref)
        else:
            x[:, k] = raw[:, k] - ref
        final_specs.append((j, cov_name, form, ref))
        pname = names[j] if names else f"p[{j}]"
        labels.append(f"{pname}~{cov_name}({form},ref={ref:g})")

    param_idx = np.asarray([s[0] for s in final_specs], dtype=np.int64)
    onehot = np.zeros((n_eff, p), dtype=np.float64)
    onehot[np.arange(n_eff), param_idx] = 1.0
    return CovariateEffects(
        specs=tuple(final_specs),
        labels=tuple(labels),
        x=x,
        param_idx=param_idx,
        onehot=onehot,
    )
