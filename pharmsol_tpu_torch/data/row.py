"""NONMEM/Pmetrics-style row ingestion.

Parity with LAPKB/pharmsol src/data/row.rs:

- ``DataRow``: {id, time, evid, dose, dur, addl, ii, input, out, outeq,
  cens, c0..c3, covariates};
- ``into_events``: EVID 0 -> Observation, 1|4 -> Bolus (or Infusion when
  DUR > 0); ADDL/II expansion with sign direction (positive forward,
  negative backward, row.rs:193-283);
- ``build_data``: groups rows by subject id, splits occasions at EVID=4
  boundaries, collects unclaimed columns as covariates (``name!`` forces
  carry-forward), sorts subjects by id (row.rs:496-572).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from ..errors import DataError
from .covariate import Covariate, Covariates
from .event import Bolus, Censor, Infusion, InputLabel, Observation, OutputLabel
from .structs import Data, Occasion, Subject


@dataclass
class DataRow:
    id: str
    time: float
    evid: int = 0
    dose: Optional[float] = None
    dur: Optional[float] = None
    addl: Optional[int] = None
    ii: Optional[float] = None
    input: Optional[str] = None
    out: Optional[float] = None
    outeq: Optional[str] = None
    cens: Optional[Censor] = None
    c0: Optional[float] = None
    c1: Optional[float] = None
    c2: Optional[float] = None
    c3: Optional[float] = None
    covariates: Dict[str, float] = field(default_factory=dict)

    @staticmethod
    def builder(id: str, time: float) -> "DataRowBuilder":
        return DataRowBuilder(id, time)

    def _errorpoly(self):
        cs = (self.c0, self.c1, self.c2, self.c3)
        if all(c is not None for c in cs):
            return tuple(float(c) for c in cs)
        return None

    def is_occasion_reset(self) -> bool:
        return self.evid == 4

    def into_events(self) -> List:
        """Translate one row into events (row.rs:193-283)."""
        events: List = []
        if self.evid == 0:
            if self.outeq is None:
                raise DataError(
                    f"observation row for `{self.id}` at t={self.time} is missing OUTEQ"
                )
            events.append(
                Observation(
                    self.time,
                    self.out,
                    OutputLabel(self.outeq),
                    self._errorpoly(),
                    0,
                    self.cens or Censor.NONE,
                )
            )
        elif self.evid in (1, 4):
            if self.input is None:
                raise DataError(
                    f"dose row for `{self.id}` at t={self.time} is missing INPUT"
                )
            if self.dose is None:
                raise DataError(
                    f"dose row for `{self.id}` at t={self.time} is missing DOSE"
                )
            if (self.dur or 0.0) > 0.0:
                base = Infusion(self.time, self.dose, InputLabel(self.input), self.dur, 0)
            else:
                base = Bolus(self.time, self.dose, InputLabel(self.input), 0)
            # ADDL/II: additional doses before (addl<0) or after (addl>0)
            if self.addl and self.ii and self.ii > 0.0:
                interval = abs(self.ii)
                direction = 1.0 if self.addl > 0 else -1.0
                t = self.time
                for _ in range(abs(int(self.addl))):
                    t += direction * interval
                    events.append(replace(base, time=t))
            events.append(base)
        else:
            raise DataError(
                f"unknown EVID {self.evid} for `{self.id}` at t={self.time}"
            )
        return events


class DataRowBuilder:
    def __init__(self, id: str, time: float):
        self._row = DataRow(id=str(id), time=float(time))

    def evid(self, evid: int):
        self._row.evid = int(evid)
        return self

    def dose(self, dose: float):
        self._row.dose = float(dose)
        return self

    def dur(self, dur: float):
        self._row.dur = float(dur)
        return self

    def addl(self, addl: int):
        self._row.addl = int(addl)
        return self

    def ii(self, ii: float):
        self._row.ii = float(ii)
        return self

    def input(self, input):
        self._row.input = str(input)
        return self

    def out(self, out: float):
        self._row.out = float(out)
        return self

    def outeq(self, outeq):
        self._row.outeq = str(outeq)
        return self

    def cens(self, cens: Censor):
        self._row.cens = cens
        return self

    def errorpoly(self, c0, c1, c2, c3):
        self._row.c0, self._row.c1, self._row.c2, self._row.c3 = c0, c1, c2, c3
        return self

    def covariate(self, name: str, value: float):
        self._row.covariates[name] = float(value)
        return self

    def build(self) -> DataRow:
        return self._row


def build_data(rows) -> Data:
    """Assemble subjects/occasions from rows (row.rs:496-572)."""
    by_subject: Dict[str, List[DataRow]] = {}
    order: List[str] = []
    for row in rows:
        if row.id not in by_subject:
            by_subject[row.id] = []
            order.append(row.id)
        by_subject[row.id].append(row)

    subjects: List[Subject] = []
    for sid in sorted(by_subject):
        srows = by_subject[sid]
        # split at EVID=4 boundaries (the EVID=4 row starts the new block)
        blocks: List[List[DataRow]] = []
        current: List[DataRow] = []
        for row in srows:
            if row.evid == 4 and current:
                blocks.append(current)
                current = []
            current.append(row)
        if current:
            blocks.append(current)

        occasions: List[Occasion] = []
        for block_index, block in enumerate(blocks):
            occ = Occasion(block_index)
            observed_covs: Dict[str, List] = {}
            for row in block:
                for ev in row.into_events():
                    ev.occasion = block_index
                    occ.events.append(ev)
                for name, value in row.covariates.items():
                    observed_covs.setdefault(name, []).append((row.time, value))
            for raw_name, obs in observed_covs.items():
                fixed = raw_name.endswith("!")
                name = raw_name[:-1] if fixed else raw_name
                cov = Covariate(name, fixed=fixed)
                for t, v in obs:
                    cov.add_observation(t, v)
                if cov.observations():
                    occ.covariates.add_covariate(name, cov)
            occ.sort()
            occasions.append(occ)
        subjects.append(Subject(sid, occasions))

    return Data(subjects)
