"""Pmetrics CSV reader.

Parity with LAPKB/pharmsol src/data/parser/pmetrics.rs:75-180:

- headers lowercased (case-insensitive files);
- canonical columns: ID, TIME, EVID, DOSE, DUR, ADDL, II, INPUT, OUT,
  OUTEQ, CENS, C0..C3;
- every other column becomes a covariate (names ending ``!`` force
  carry-forward interpolation);
- ``OUT=-99`` means missing observation;
- empty / ``.`` / ``NA`` cells are missing; CENS accepts 1/-1/0 and
  bloq/aloq/none;
- ``#`` starts a comment line;
- occasions split at EVID=4.

Also provides ``write_pmetrics`` for round-tripping datasets.
"""

from __future__ import annotations

import csv
import io
from typing import List, Optional, Union

from ..errors import DataError
from .event import Bolus, Censor, Infusion, Observation
from .row import DataRow, build_data
from .structs import Data

_CANONICAL = {
    "id", "time", "evid", "dose", "dur", "addl", "ii",
    "input", "out", "outeq", "cens", "c0", "c1", "c2", "c3",
}

_MISSING = {"", ".", "na", "nan"}


def _opt_float(cell: Optional[str]) -> Optional[float]:
    if cell is None or cell.strip().lower() in _MISSING:
        return None
    try:
        return float(cell)
    except ValueError as e:
        raise DataError(f"could not parse number from `{cell}`") from e


def _opt_int(cell: Optional[str]) -> Optional[int]:
    v = _opt_float(cell)
    return None if v is None else int(v)


def _opt_str(cell: Optional[str]) -> Optional[str]:
    if cell is None or cell.strip() == "" or cell.strip() in (".", "NA"):
        return None
    return cell.strip()


def _opt_censor(cell: Optional[str]) -> Optional[Censor]:
    s = _opt_str(cell)
    if s is None:
        return None
    s = s.lower()
    if s in ("1", "bloq"):
        return Censor.BLOQ
    if s in ("0", "none"):
        return Censor.NONE
    if s in ("-1", "aloq"):
        return Censor.ALOQ
    raise DataError(f"expected CENS of 1/-1/0 or bloq/aloq/none, got `{s}`")


def read_pmetrics(source: Union[str, io.TextIOBase]) -> Data:
    """Parse a Pmetrics CSV file (path or file-like) into Data."""
    if isinstance(source, str):
        with open(source, "r", newline="") as f:
            return _read(f)
    return _read(source)


def _read(f) -> Data:
    raw_lines = iter(f)
    # the header is the first non-empty line; Pmetrics conventionally writes
    # it as `#ID,TIME,...`, so a leading '#' there is part of the header, not
    # a comment. Subsequent '#' lines are comments.
    header_line = None
    for line in raw_lines:
        if line.strip():
            header_line = line
            break
    if header_line is None:
        raise DataError("empty Pmetrics file")
    data_lines = (line for line in raw_lines if not line.lstrip().startswith("#"))
    reader = csv.reader(data_lines)
    header = [h.strip().lower() for h in next(csv.reader([header_line]))]
    if header and header[0].startswith("#"):
        header[0] = header[0].lstrip("#")
    cols = {name: i for i, name in enumerate(header)}
    if "id" not in cols or "time" not in cols or "evid" not in cols:
        raise DataError(f"Pmetrics file must have ID, TIME, EVID columns (got {header})")
    covariate_cols = [
        (name, i) for name, i in cols.items() if name not in _CANONICAL
    ]

    def cell(record, name):
        i = cols.get(name)
        if i is None or i >= len(record):
            return None
        return record[i]

    rows: List[DataRow] = []
    for record in reader:
        if not record or all(c.strip() == "" for c in record):
            continue
        rid = _opt_str(cell(record, "id"))
        time = _opt_float(cell(record, "time"))
        evid = _opt_int(cell(record, "evid"))
        if rid is None or time is None or evid is None:
            raise DataError(f"row missing ID/TIME/EVID: {record}")
        out = _opt_float(cell(record, "out"))
        if out is not None and out == -99.0:
            out = None  # Pmetrics missing-observation convention
        row = DataRow(
            id=rid,
            time=time,
            evid=evid,
            dose=_opt_float(cell(record, "dose")),
            dur=_opt_float(cell(record, "dur")),
            addl=_opt_int(cell(record, "addl")),
            ii=_opt_float(cell(record, "ii")),
            input=_opt_str(cell(record, "input")),
            out=out,
            outeq=_opt_str(cell(record, "outeq")),
            cens=_opt_censor(cell(record, "cens")),
            c0=_opt_float(cell(record, "c0")),
            c1=_opt_float(cell(record, "c1")),
            c2=_opt_float(cell(record, "c2")),
            c3=_opt_float(cell(record, "c3")),
        )
        for name, i in covariate_cols:
            if i < len(record):
                v = _opt_float(record[i])
                if v is not None:
                    row.covariates[name] = v
        rows.append(row)
    return build_data(rows)


def write_pmetrics(data: Data, destination: Union[str, io.TextIOBase]) -> None:
    """Write a Data object back to Pmetrics CSV format."""
    if isinstance(destination, str):
        with open(destination, "w", newline="") as f:
            _write(data, f)
            return
    _write(data, destination)


def _write(data: Data, f) -> None:
    cov_names: List[str] = []
    for s in data:
        for occ in s.occasions():
            for name, cov in occ.covariates.items():
                tag = name + ("!" if cov.fixed else "")
                if tag not in cov_names:
                    cov_names.append(tag)
    writer = csv.writer(f)
    writer.writerow(
        ["id", "time", "evid", "dose", "dur", "addl", "ii", "input", "out",
         "outeq", "cens", "c0", "c1", "c2", "c3"] + cov_names
    )

    def cov_cells(occ, t):
        out = []
        for tag in cov_names:
            name = tag.rstrip("!")
            cov = occ.covariates.get(name)
            if cov is None:
                out.append("")
                continue
            match = [v for (tt, v) in cov.observations() if tt == t]
            out.append(match[0] if match else "")
        return out

    for s in data:
        for occ in s.occasions():
            for i, e in enumerate(occ.events):
                evid_reset = 4 if (occ.index > 0 and i == 0 and not isinstance(e, Observation)) else None
                if isinstance(e, Observation):
                    cens = {Censor.NONE: "", Censor.BLOQ: "1", Censor.ALOQ: "-1"}[e.censoring]
                    poly = e.errorpoly or ("", "", "", "")
                    writer.writerow(
                        [s.id, e.time, 0, "", "", "", "", "",
                         -99 if e.value is None else e.value,
                         str(e.outeq), cens, *poly] + cov_cells(occ, e.time)
                    )
                elif isinstance(e, Bolus):
                    writer.writerow(
                        [s.id, e.time, evid_reset or 1, e.amount, 0, "", "",
                         str(e.input), "", "", "", "", "", "", ""] + cov_cells(occ, e.time)
                    )
                elif isinstance(e, Infusion):
                    writer.writerow(
                        [s.id, e.time, evid_reset or 1, e.amount, e.duration, "", "",
                         str(e.input), "", "", "", "", "", "", ""] + cov_cells(occ, e.time)
                    )
