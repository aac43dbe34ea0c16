"""Versioned JSON (de)serialization for the data layer.

Parity: every reference data type derives serde ``Serialize/Deserialize``
(LAPKB/pharmsol src/data/structs.rs:37,351; covariate.rs:322;
event.rs:106-114; error_model.rs) so PMcore-style callers can persist
populations. The format is the JAX package's ``data/serde.py``, so a file
written by either package loads in the other: plain-JSON dicts with a
``schema`` version tag at the roots, round-trip-stable (build -> dump ->
load -> identical content hash). The NCA result's schema waits for the
port's NCA layer: until then an NCA result is an unsupported root, and its
schema an unknown one.

Schema v1 shapes::

    Data        {"schema": "pharmsol-data-v1", "subjects": [Subject...]}
    Subject     {"id": str, "occasions": [Occasion...]}
    Occasion    {"index": int, "events": [Event...], "covariates": {name: Covariate}}
    Event       {"type": "bolus"|"infusion"|"observation", ...fields}
    Covariate   {"fixed": bool, "observations": [[t, v]...]}
    AssayErrorModels  {"schema": "pharmsol-error-models-v1", "models": {label: ...}}
    ResidualErrorModels {"schema": "pharmsol-residual-models-v1", ...}

All functions are pure host-side.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from ..errors import PharmsolError
from .covariate import Covariate, Covariates
from .error_model import AssayErrorModel, AssayErrorModels, ErrorPoly, Factor
from .event import Bolus, Censor, Infusion, Observation
from .residual_error import ResidualErrorModel, ResidualErrorModels, ResidualKind
from .structs import Data, Occasion, Subject

DATA_SCHEMA = "pharmsol-data-v1"
ERROR_MODELS_SCHEMA = "pharmsol-error-models-v1"
RESIDUAL_MODELS_SCHEMA = "pharmsol-residual-models-v1"


def _expect_schema(d: dict, expected: str) -> None:
    got = d.get("schema")
    if got != expected:
        raise PharmsolError(
            f"schema mismatch: expected `{expected}`, got `{got}` "
            f"(is this the right artifact?)"
        )


# -- events -----------------------------------------------------------------

def event_to_dict(event) -> dict:
    if isinstance(event, Bolus):
        return {
            "type": "bolus",
            "time": event.time,
            "amount": event.amount,
            "input": str(event.input),
            "occasion": event.occasion,
        }
    if isinstance(event, Infusion):
        return {
            "type": "infusion",
            "time": event.time,
            "amount": event.amount,
            "input": str(event.input),
            "duration": event.duration,
            "occasion": event.occasion,
        }
    if isinstance(event, Observation):
        return {
            "type": "observation",
            "time": event.time,
            "value": event.value,
            "outeq": str(event.outeq),
            "errorpoly": list(event.errorpoly) if event.errorpoly else None,
            "occasion": event.occasion,
            "censoring": event.censoring.value,
        }
    raise PharmsolError(f"not a serializable event: {event!r}")


def event_from_dict(d: dict):
    t = d.get("type")
    if t == "bolus":
        return Bolus(d["time"], d["amount"], d["input"], d.get("occasion", 0))
    if t == "infusion":
        return Infusion(
            d["time"], d["amount"], d["input"], d["duration"], d.get("occasion", 0)
        )
    if t == "observation":
        ep = d.get("errorpoly")
        return Observation(
            d["time"],
            d.get("value"),
            d["outeq"],
            tuple(ep) if ep else None,
            d.get("occasion", 0),
            Censor(d.get("censoring", "none")),
        )
    raise PharmsolError(f"unknown event type `{t}`")


# -- covariates ---------------------------------------------------------------

def covariate_to_dict(cov: Covariate) -> dict:
    return {
        "fixed": cov.fixed,
        "observations": [[t, v] for t, v in cov.observations()],
    }


def covariate_from_dict(name: str, d: dict) -> Covariate:
    return Covariate(
        name, fixed=bool(d.get("fixed", False)),
        observations=[(t, v) for t, v in d.get("observations", [])],
    )


def covariates_to_dict(covs: Covariates) -> dict:
    return {name: covariate_to_dict(cov) for name, cov in covs.items()}


def covariates_from_dict(d: dict) -> Covariates:
    covs = Covariates()
    for name, cd in d.items():
        covs.add_covariate(name, covariate_from_dict(name, cd))
    return covs


# -- occasions / subjects / data ----------------------------------------------

def occasion_to_dict(occ: Occasion) -> dict:
    return {
        "index": occ.index,
        "events": [event_to_dict(e) for e in occ.events],
        "covariates": covariates_to_dict(occ.covariates),
    }


def occasion_from_dict(d: dict) -> Occasion:
    occ = Occasion(int(d.get("index", 0)))
    occ.events = [event_from_dict(ed) for ed in d.get("events", [])]
    occ.covariates = covariates_from_dict(d.get("covariates", {}))
    occ.sort()
    return occ


def subject_to_dict(subject: Subject) -> dict:
    return {
        "id": subject.id,
        "occasions": [occasion_to_dict(o) for o in subject.occasions()],
    }


def subject_from_dict(d: dict) -> Subject:
    return Subject(d["id"], [occasion_from_dict(od) for od in d.get("occasions", [])])


def data_to_dict(data: Data) -> dict:
    return {
        "schema": DATA_SCHEMA,
        "subjects": [subject_to_dict(s) for s in data.subjects()],
    }


def data_from_dict(d: dict) -> Data:
    _expect_schema(d, DATA_SCHEMA)
    return Data([subject_from_dict(sd) for sd in d.get("subjects", [])])


# -- error models ---------------------------------------------------------------

def assay_error_model_to_dict(m: AssayErrorModel) -> dict:
    out: Dict[str, Any] = {"kind": m.kind}
    if m.poly is not None:
        out["poly"] = list(m.poly.coefficients())
    if m.factor_param is not None:
        out["factor"] = {"value": m.factor_param.value, "fixed": m.factor_param.fixed}
    return out


def assay_error_model_from_dict(d: dict) -> AssayErrorModel:
    poly = ErrorPoly(*d["poly"]) if d.get("poly") is not None else None
    f = d.get("factor")
    factor = Factor(float(f["value"]), bool(f.get("fixed", False))) if f else None
    return AssayErrorModel(int(d["kind"]), factor, poly)


def assay_error_models_to_dict(ems: AssayErrorModels) -> dict:
    return {
        "schema": ERROR_MODELS_SCHEMA,
        "models": {label: assay_error_model_to_dict(m) for label, m in ems.items()},
    }


def assay_error_models_from_dict(d: dict) -> AssayErrorModels:
    _expect_schema(d, ERROR_MODELS_SCHEMA)
    ems = AssayErrorModels()
    for label, md in d.get("models", {}).items():
        ems.add(label, assay_error_model_from_dict(md))
    return ems


def residual_error_models_to_dict(rems: ResidualErrorModels) -> dict:
    return {
        "schema": RESIDUAL_MODELS_SCHEMA,
        "models": {
            label: {"kind": m.kind.value, "a": m.a, "b": m.b}
            for label, m in ((l, rems.get(l)) for l in rems.labels())
        },
    }


def residual_error_models_from_dict(d: dict) -> ResidualErrorModels:
    _expect_schema(d, RESIDUAL_MODELS_SCHEMA)
    rems = ResidualErrorModels()
    for label, md in d.get("models", {}).items():
        rems.add(
            label,
            ResidualErrorModel(ResidualKind(md["kind"]), float(md["a"]), float(md["b"])),
        )
    return rems


# -- JSON string / file convenience ----------------------------------------------

def to_json(obj, indent: Optional[int] = None) -> str:
    """Serialize any supported object to a JSON string."""
    return json.dumps(_dispatch_to_dict(obj), indent=indent)


def _dispatch_to_dict(obj) -> dict:
    if isinstance(obj, Data):
        return data_to_dict(obj)
    if isinstance(obj, Subject):
        return {"schema": DATA_SCHEMA, "subjects": [subject_to_dict(obj)]}
    if isinstance(obj, AssayErrorModels):
        return assay_error_models_to_dict(obj)
    if isinstance(obj, ResidualErrorModels):
        return residual_error_models_to_dict(obj)
    raise PharmsolError(
        f"cannot serialize {type(obj).__name__}; supported roots: Data, "
        f"Subject, AssayErrorModels, ResidualErrorModels"
    )


def from_json(text: str):
    """Deserialize a JSON string produced by :func:`to_json` (schema-sniffing)."""
    d = json.loads(text)
    schema = d.get("schema")
    if schema == DATA_SCHEMA:
        data = data_from_dict(d)
        if len(data) == 1:
            return data  # caller can take .subjects()[0]
        return data
    if schema == ERROR_MODELS_SCHEMA:
        return assay_error_models_from_dict(d)
    if schema == RESIDUAL_MODELS_SCHEMA:
        return residual_error_models_from_dict(d)
    raise PharmsolError(f"unknown schema `{schema}`")


def save_json(obj, path: str, indent: int = 2) -> None:
    with open(path, "w") as f:
        f.write(to_json(obj, indent=indent))


def load_json(path: str):
    with open(path) as f:
        return from_json(f.read())
