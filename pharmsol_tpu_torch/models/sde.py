"""SDE equation family: particle-filtered stochastic models.

Public surface parity with the JAX package's ``models/sde.py`` (and the
reference's sde/mod.rs) for what the population psi path needs:
``SDE(drift, diffusion, lag, fa, init, out, nparticles, ...)``, the options
``with_nparticles/with_seed/with_noise/with_resampling/with_em_control``,
metadata with its particle count and inject-to-destination routes, and the
spec the general engine runs (:mod:`~pharmsol_tpu_torch.engine.sde`).

- ``drift(x, p, t, rateiv, cov) -> dx`` and ``diffusion(p, t, cov) -> g``
  are written for one particle, as torch operations (``torch.stack([...])``
  or a list of components); ``init(p, t, cov) -> x0`` sets the state at
  t = 0 of the first occasion; ``lag(p, t, cov)`` and ``fa(p, t, cov)``
  give each input's absorption lag and bioavailability (a dict ``{input:
  value}`` or a vector), lag evaluated at the dose's time, fa at the
  lag-shifted one. Every closure may read covariates through ``cov(name,
  t)``.
- ``noise``: ``'common'`` (default) shares the draws across support points
  in the general engine, ``'independent'`` draws per (subject, support)
  cell. The fused CUDA kernel always draws per cell, as the JAX kernel.
- ``resampling``: ``'stratified'`` (the reference's scheme, default) or
  ``'systematic'`` (general engine only).
- ``em_control``: ``'independent'`` (reference-exact fresh draws for the
  full and the half steps, default) or ``'coupled'`` (shared increments).

Draws come from an explicit generator seeded by ``seed`` (the general
engine) or from the Philox counters of ``ops/philox.py`` (the fused kernel):
each run is reproducible per seed within the port, and equals the JAX
package's only at zero diffusion.

The single-subject API and the per-subject batch run the general engine:
``estimate_predictions`` advances the clouds with no weighting (the
reference's path without error models) and reports the particle means;
``estimate_log_likelihood`` is the particle filter, one psi cell.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..engine.sde import SDESim, SDESpec, simulate_occasion_sde, simulate_occasion_sde_ll
from ..metadata import ModelKind, RouteInputPolicy, ValidatedModelMetadata
from .equation import EquationBase

NOISE_MODES = ("common", "independent")
RESAMPLING = ("stratified", "systematic")
EM_CONTROL = ("independent", "coupled")


def _check_option(name: str, value: str, allowed) -> str:
    if value not in allowed:
        raise ValueError(f"{name} must be " + " or ".join(f"'{a}'" for a in allowed))
    return value


class SDE(EquationBase):
    """Stochastic differential equation family (sde/mod.rs)."""

    kind = "sde"

    def __init__(
        self,
        drift: Callable,
        diffusion: Callable,
        lag: Optional[Callable] = None,
        fa: Optional[Callable] = None,
        init: Optional[Callable] = None,
        out: Optional[Callable] = None,
        nparticles: int = 1000,
        nstates: int = 5,
        ndrugs: int = 5,
        nout: int = 5,
        seed: int = 0,
        noise: str = "common",
        resampling: str = "stratified",
        em_control: str = "independent",
    ):
        super().__init__(nstates, ndrugs, nout)
        self._drift = drift
        self._diffusion = diffusion
        self._lag = lag
        self._fa = fa
        self._init = init
        self._out = out
        self._nparticles = int(nparticles)
        self._seed = int(seed)
        self._noise = _check_option("noise", noise, NOISE_MODES)
        self._resampling = _check_option("resampling", resampling, RESAMPLING)
        self._em_control = _check_option("em_control", em_control, EM_CONTROL)
        # generated CUDA drift and diffusion, by (support columns, inputs,
        # covariates and their modes)
        self._sde_cache: Dict[tuple, object] = {}

    def _model_kind(self) -> ModelKind:
        return ModelKind.SDE

    def _invalidate(self):
        super()._invalidate()
        self._sde_cache = {}

    # -- options (sde/mod.rs) ----------------------------------------------------
    def with_nparticles(self, n: int):
        self._nparticles = int(n)
        self._invalidate()
        return self

    def with_seed(self, seed: int):
        self._seed = int(seed)
        self._invalidate()
        return self

    def with_noise(self, noise: str):
        """``'common'``: the general engine reuses its draws for every support
        point (common random numbers). ``'independent'``: fresh draws per
        (subject, support) cell, the reference's per-call RNG."""
        self._noise = _check_option("noise", noise, NOISE_MODES)
        self._invalidate()
        return self

    def with_resampling(self, resampling: str):
        """``'stratified'`` (default): ``u_j = (j + U_j)/M``, the reference's
        ``sysresample``. ``'systematic'``: one shared offset."""
        self._resampling = _check_option("resampling", resampling, RESAMPLING)
        self._invalidate()
        return self

    def with_em_control(self, em_control: str):
        """``'independent'`` (default, em.rs): fresh noise for the full step
        and each half step of the step-doubling error estimate.
        ``'coupled'``: ``dW_full = dW_1 + dW_2``, so the estimate measures
        truncation error and steps grow to what Euler-Maruyama earns."""
        self._em_control = _check_option("em_control", em_control, EM_CONTROL)
        self._invalidate()
        return self

    def nparticles(self) -> int:
        return self._nparticles

    def with_metadata(self, metadata):
        validated = (
            metadata
            if isinstance(metadata, ValidatedModelMetadata)
            else metadata.validate_for_with_particles(ModelKind.SDE, self._nparticles)
        )
        self._validate_metadata_dimensions(validated)
        self._metadata = validated
        if validated.particle_count:
            self._nparticles = validated.particle_count
        self._invalidate()
        return self

    # -- spec ----------------------------------------------------------------------
    def _bolus_dest(self) -> Optional[tuple]:
        """The state each input's bolus lands in, when metadata declares
        inject-to-destination routes (sde/mod.rs:46-79)."""
        if self._metadata is None:
            return None
        dest = list(range(self._ndrugs))
        for route in self._metadata.validated_routes:
            if (route.input_policy is RouteInputPolicy.INJECT_TO_DESTINATION
                    and route.input_index < self._ndrugs):
                dest[route.input_index] = route.destination_index
        return tuple(dest)

    def _build_spec(self) -> SDESpec:
        return SDESpec(
            nstates=self._nstates,
            ninput=self._ndrugs,
            nout=self._nout,
            nparticles=self._nparticles,
            drift=self._drift,
            diffusion=self._diffusion,
            out=self._out or (lambda x, p, t, cov: x[: self._nout]),
            init=self._init,
            lag=self._lag,
            fa=self._fa,
            bolus_dest=self._bolus_dest(),
            resampling=self._resampling,
            em_control=self._em_control,
            noise=self._noise,
        )

    # -- the rows' marches -----------------------------------------------------------
    def _generator(self, device) -> torch.Generator:
        """A generator seeded by the model: one seed, one result."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self._seed)
        return gen

    def _sim_rows(self, rows, p, cov_names) -> SDESim:
        return simulate_occasion_sde(self.spec, rows, p, self._generator(p.device), cov_names)

    def _ll_rows(self, rows, p, em_kind, em_factor, em_poly, cov_names):
        return simulate_occasion_sde_ll(self.spec, rows, p, em_kind, em_factor, em_poly,
                                        self._generator(p.device), cov_names)

    def _batch_predictions(self, rows, p_rows, cov_names):
        return simulate_occasion_sde(self.spec, rows, p_rows, self._generator(p_rows.device),
                                     cov_names, per_row=True).pred_mean[0]

    def _assemble_subject_predictions(self, subject, grid, sim: SDESim):
        return self._assemble(subject, sim.pred_mean, sim.state_mean)
