"""Native-accelerated Pmetrics reader.

The counterpart of the JAX package's ``native/pmetrics.py``:
``read_pmetrics_native`` parses with the C++ columnar tokenizer
(``src/pharmsol_native.cpp``) and assembles the port's own ``Data`` (the
same object as ``data/pmetrics.py::read_pmetrics``): a single pass over the
file in native code, then numpy column handling. Falls back to the
pure-Python reader when the toolchain is unavailable.
"""

from __future__ import annotations

import copy as _copy
import ctypes
import math
from typing import Optional

import numpy as np

from ..data.covariate import Covariate
from ..data.event import Bolus, Censor, Infusion, InputLabel, Observation, OutputLabel
from ..data.structs import Data, Occasion, Subject
from ..errors import DataError
from .loader import get_library, native_available


def _read_string(lib, handle, table: str, idx: int) -> str:
    n = lib.psn_table_get(handle, table.encode(), idx, None, 0)
    buf = ctypes.create_string_buffer(n + 1)
    lib.psn_table_get(handle, table.encode(), idx, buf, n + 1)
    return buf.value.decode()


def _cov_name(lib, handle, idx: int) -> str:
    n = lib.psn_cov_name(handle, idx, None, 0)
    buf = ctypes.create_string_buffer(n + 1)
    lib.psn_cov_name(handle, idx, buf, n + 1)
    return buf.value.decode()


def read_pmetrics_native(source) -> Data:
    """Parse a Pmetrics CSV (path or text) via the native library."""
    lib = get_library()
    if lib is None:
        import io

        from ..data.pmetrics import read_pmetrics

        # CSV text goes to the Python reader as a stream (the JAX package's
        # fallback hands it over as a path)
        if isinstance(source, str) and "\n" in source:
            source = io.StringIO(source)
        return read_pmetrics(source)

    if isinstance(source, str) and "\n" not in source:
        with open(source, "rb") as f:
            text = f.read()
    elif isinstance(source, str):
        text = source.encode()
    else:
        text = source.read()
        if isinstance(text, str):
            text = text.encode()

    handle = lib.psn_parse(text, len(text))
    try:
        err = lib.psn_error(handle)
        if err:
            raise DataError(err.decode())
        n = lib.psn_nrows(handle)
        if n == 0:
            return Data([])

        def numeric(name: str) -> np.ndarray:
            out = np.empty(n, dtype=np.float64)
            if lib.psn_numeric(handle, name.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))) != 0:
                raise DataError(f"native parser missing column {name}")
            return out

        def interned(name: str) -> np.ndarray:
            out = np.empty(n, dtype=np.int64)
            if lib.psn_interned(handle, name.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_long))) != 0:
                raise DataError(f"native parser missing column {name}")
            return out

        time = numeric("time")
        evid = numeric("evid")
        dose = numeric("dose")
        dur = numeric("dur")
        addl = numeric("addl")
        ii = numeric("ii")
        out_col = numeric("out")
        cens = numeric("cens")
        c0 = numeric("c0")
        c1 = numeric("c1")
        c2 = numeric("c2")
        c3 = numeric("c3")
        id_idx = interned("id")
        input_idx = interned("input")
        outeq_idx = interned("outeq")

        ids = [_read_string(lib, handle, "id", i) for i in range(lib.psn_table_len(handle, b"id"))]
        inputs = [
            _read_string(lib, handle, "input", i)
            for i in range(lib.psn_table_len(handle, b"input"))
        ]
        outeqs = [
            _read_string(lib, handle, "outeq", i)
            for i in range(lib.psn_table_len(handle, b"outeq"))
        ]
        ncov = lib.psn_ncov(handle)
        cov_names = [_cov_name(lib, handle, i) for i in range(ncov)]
        cov_cols = []
        for i in range(ncov):
            col = np.empty(n, dtype=np.float64)
            lib.psn_cov_column(handle, i, col.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            cov_cols.append(col)
    finally:
        lib.psn_free(handle)

    # -- assemble subjects/occasions (row.rs build_data semantics) -------------
    # Python-list views: indexing np scalars in the assembly loop is ~5x
    # slower than list indexing, and every element is touched exactly once
    time = time.tolist()
    evid = evid.tolist()
    dose = dose.tolist()
    dur = dur.tolist()
    addl = addl.tolist()
    ii = ii.tolist()
    out_col = out_col.tolist()
    cens = cens.tolist()
    c0 = c0.tolist()
    c1 = c1.tolist()
    c2 = c2.tolist()
    c3 = c3.tolist()
    input_idx = input_idx.tolist()
    outeq_idx = outeq_idx.tolist()
    cov_cols = [c.tolist() for c in cov_cols]

    # group rows by subject in one stable argsort (the previous per-subject
    # `nonzero(id_idx == k)` scan was O(rows x subjects))
    order = np.argsort(id_idx, kind="stable")
    sorted_ids = id_idx[order]
    cuts = np.nonzero(np.diff(sorted_ids))[0] + 1
    groups = {
        int(sorted_ids[g[0]]): g for g in np.split(order, cuts) if g.size
    }
    subjects = []
    for sid_idx, sid in sorted(enumerate(ids), key=lambda kv: kv[1]):
        rows = groups.get(sid_idx)
        if rows is None:
            continue
        rows = rows.tolist()
        # occasion split at EVID=4
        blocks = []
        current = []
        for r in rows:
            if evid[r] == 4 and current:
                blocks.append(current)
                current = []
            current.append(r)
        if current:
            blocks.append(current)

        occasions = []
        for block_index, block in enumerate(blocks):
            occ = Occasion(block_index)
            observed_covs = {name: [] for name in cov_names}
            for r in block:
                e = int(evid[r])
                t = float(time[r])
                if e == 0:
                    if outeq_idx[r] < 0:
                        raise DataError(
                            f"observation row for `{sid}` at t={t} is missing OUTEQ"
                        )
                    value = None if (math.isnan(out_col[r]) or out_col[r] == -99.0) else float(out_col[r])
                    poly = None
                    if not (
                        math.isnan(c0[r]) or math.isnan(c1[r])
                        or math.isnan(c2[r]) or math.isnan(c3[r])
                    ):
                        poly = (float(c0[r]), float(c1[r]), float(c2[r]), float(c3[r]))
                    censor = Censor.NONE
                    if not math.isnan(cens[r]):
                        censor = {1: Censor.BLOQ, -1: Censor.ALOQ, 0: Censor.NONE}.get(
                            int(cens[r]), Censor.NONE
                        )
                    occ.events.append(
                        Observation(t, value, OutputLabel(outeqs[int(outeq_idx[r])]),
                                    poly, block_index, censor)
                    )
                elif e in (1, 4):
                    if input_idx[r] < 0:
                        raise DataError(f"dose row for `{sid}` at t={t} is missing INPUT")
                    if math.isnan(dose[r]):
                        raise DataError(f"dose row for `{sid}` at t={t} is missing DOSE")
                    label = InputLabel(inputs[int(input_idx[r])])
                    d = float(dose[r])
                    duration = 0.0 if math.isnan(dur[r]) else float(dur[r])
                    if duration > 0.0:
                        base = Infusion(t, d, label, duration, block_index)
                    else:
                        base = Bolus(t, d, label, block_index)
                    # ADDL/II expansion
                    a = 0 if math.isnan(addl[r]) else int(addl[r])
                    interval = 0.0 if math.isnan(ii[r]) else float(ii[r])
                    if a != 0 and interval > 0.0:
                        direction = 1.0 if a > 0 else -1.0
                        tt = t
                        for _ in range(abs(a)):
                            tt += direction * interval
                            extra = _copy.copy(base)
                            extra.time = tt
                            occ.events.append(extra)
                    occ.events.append(base)
                else:
                    raise DataError(f"unknown EVID {e} for `{sid}` at t={t}")
                for ci, name in enumerate(cov_names):
                    v = cov_cols[ci][r]
                    if not math.isnan(v):
                        observed_covs[name].append((t, float(v)))
            for raw_name, obs in observed_covs.items():
                if not obs:
                    continue
                fixed = raw_name.endswith("!")
                name = raw_name[:-1] if fixed else raw_name
                cov = Covariate(name, fixed=fixed)
                for t, v in obs:
                    cov.add_observation(t, v)
                occ.covariates.add_covariate(name, cov)
            occ.sort()
            occasions.append(occ)
        subjects.append(Subject(sid, occasions))
    return Data(subjects)
