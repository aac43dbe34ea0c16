"""Fluent subject builder.

API parity with LAPKB/pharmsol src/data/builder.rs:19-361:
``bolus / infusion / observation / censored_observation / missing_observation /
observation_with_error / covariate / repeat(n, delta) / reset() / build()``.
"""

from __future__ import annotations

import copy
from typing import Optional

from .covariate import Covariate, Covariates
from .event import Bolus, Censor, Infusion, Observation
from .structs import Occasion, Subject


class SubjectBuilder:
    def __init__(self, id: str):
        self.id = str(id)
        self._occasions = []
        self._current = Occasion(0)
        self._covariates = Covariates()
        self._cov_fixed: dict = {}
        self._last_event = None

    # -- events ---------------------------------------------------------------
    def event(self, event) -> "SubjectBuilder":
        self._last_event = copy.copy(event)
        self._current.add_event(event)
        return self

    def bolus(self, time: float, amount: float, input) -> "SubjectBuilder":
        return self.event(Bolus(time, amount, input, self._current.index))

    def infusion(self, time: float, amount: float, input, duration: float) -> "SubjectBuilder":
        return self.event(Infusion(time, amount, input, duration, self._current.index))

    def observation(self, time: float, value: float, outeq) -> "SubjectBuilder":
        return self.event(
            Observation(time, value, outeq, None, self._current.index, Censor.NONE)
        )

    def censored_observation(
        self, time: float, value: float, outeq, censoring: Censor
    ) -> "SubjectBuilder":
        return self.event(
            Observation(time, value, outeq, None, self._current.index, censoring)
        )

    def missing_observation(self, time: float, outeq) -> "SubjectBuilder":
        return self.event(
            Observation(time, None, outeq, None, self._current.index, Censor.NONE)
        )

    def observation_with_error(
        self, time: float, value: float, outeq, errorpoly, censored: Censor = Censor.NONE
    ) -> "SubjectBuilder":
        return self.event(
            Observation(time, value, outeq, tuple(errorpoly), self._current.index, censored)
        )

    def repeat(self, n: int, delta: float) -> "SubjectBuilder":
        """Repeat the last event ``n`` times separated by ``delta``."""
        last = self._last_event
        if last is None:
            return self
        out = self
        for i in range(1, n + 1):
            t = last.time + delta * i
            if isinstance(last, Bolus):
                out = out.bolus(t, last.amount, last.input)
            elif isinstance(last, Infusion):
                out = out.infusion(t, last.amount, last.input, last.duration)
            else:
                if last.value is not None:
                    if last.errorpoly is not None:
                        out = out.observation_with_error(
                            t, last.value, last.outeq, last.errorpoly, last.censoring
                        )
                    elif last.censored:
                        out = out.censored_observation(t, last.value, last.outeq, last.censoring)
                    else:
                        out = out.observation(t, last.value, last.outeq)
                else:
                    out = out.missing_observation(t, last.outeq)
        return out

    # -- covariates -------------------------------------------------------------
    def covariate(self, name: str, time: float, value: float) -> "SubjectBuilder":
        fixed = name.endswith("!")
        clean = name[:-1] if fixed else name
        cov = self._covariates.get(clean)
        if cov is None:
            cov = Covariate(clean, fixed=fixed)
            self._covariates.add_covariate(clean, cov)
        cov.add_observation(time, value)
        return self

    # -- occasions ---------------------------------------------------------------
    def reset(self) -> "SubjectBuilder":
        """Finish the current occasion and start a new one with reset state."""
        self._current.sort()
        self._current.covariates = self._covariates
        self._occasions.append(self._current)
        self._current = Occasion(self._current.index + 1)
        self._covariates = Covariates()
        self._last_event = None
        return self

    def build(self) -> Subject:
        self.reset()
        return Subject(self.id, self._occasions)
