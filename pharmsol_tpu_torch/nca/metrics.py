"""Observation-level PK metrics on Subject/Occasion/Data.

Parity with the reference's ``ObservationMetrics`` trait
(nca/traits.rs:330-470): per-occasion AUC / AUC-interval / Cmax / Tmax /
Clast / Tlast / AUMC, each with an explicit-BLQ variant (``_blq``) and a
first-occasion shortcut (``_first``). Methods default BLQ handling to
Exclude. Results come back as a list (one per occasion), each either a
float or a raised-and-captured MetricsError.
"""

from __future__ import annotations

from typing import List, Union

from ..data.event import AUCMethod, BLQRule
from ..data.structs import Data, Occasion, Subject
from ..errors import PharmsolError
from .observation import NCAError, ObservationProfile


class MetricsError(PharmsolError):
    pass


def _occasions(target) -> List[Occasion]:
    if isinstance(target, Occasion):
        return [target]
    if isinstance(target, Subject):
        return list(target.occasions())
    if isinstance(target, Data):
        return [occ for s in target.subjects() for occ in s.occasions()]
    raise TypeError(f"cannot compute metrics on {type(target)}")


def _per_occasion(target, outeq: int, blq_rule, fn) -> List[Union[float, Exception]]:
    out: List[Union[float, Exception]] = []
    for occ in _occasions(target):
        try:
            profile = ObservationProfile.from_occasion(occ, outeq, blq_rule)
            out.append(float(fn(profile)))
        except Exception as e:
            out.append(MetricsError(str(e)))
    return out


def _first(results):
    if not results:
        raise MetricsError("no occasions")
    r = results[0]
    if isinstance(r, Exception):
        raise r
    return r


def _install(cls):
    def auc_blq(self, outeq, method, blq_rule):
        return _per_occasion(self, outeq, blq_rule, lambda p: p.auc_last(method))

    def auc_interval_blq(self, outeq, start, end, method, blq_rule):
        return _per_occasion(
            self, outeq, blq_rule, lambda p: p.auc_interval(start, end, method)
        )

    def cmax_blq(self, outeq, blq_rule):
        return _per_occasion(self, outeq, blq_rule, lambda p: p.cmax())

    def tmax_blq(self, outeq, blq_rule):
        return _per_occasion(self, outeq, blq_rule, lambda p: p.tmax())

    def clast_blq(self, outeq, blq_rule):
        return _per_occasion(self, outeq, blq_rule, lambda p: p.clast())

    def tlast_blq(self, outeq, blq_rule):
        return _per_occasion(self, outeq, blq_rule, lambda p: p.tlast())

    def aumc_blq(self, outeq, method, blq_rule):
        return _per_occasion(self, outeq, blq_rule, lambda p: p.aumc_last(method))

    cls.auc_blq = auc_blq
    cls.auc_interval_blq = auc_interval_blq
    cls.cmax_blq = cmax_blq
    cls.tmax_blq = tmax_blq
    cls.clast_blq = clast_blq
    cls.tlast_blq = tlast_blq
    cls.aumc_blq = aumc_blq

    cls.auc_metric = lambda self, outeq=0, method=AUCMethod.LINEAR: auc_blq(
        self, outeq, method, BLQRule.EXCLUDE
    )
    cls.auc_interval_metric = lambda self, outeq, start, end, method=AUCMethod.LINEAR: (
        auc_interval_blq(self, outeq, start, end, method, BLQRule.EXCLUDE)
    )
    cls.cmax = lambda self, outeq=0: cmax_blq(self, outeq, BLQRule.EXCLUDE)
    cls.tmax = lambda self, outeq=0: tmax_blq(self, outeq, BLQRule.EXCLUDE)
    cls.clast = lambda self, outeq=0: clast_blq(self, outeq, BLQRule.EXCLUDE)
    cls.tlast = lambda self, outeq=0: tlast_blq(self, outeq, BLQRule.EXCLUDE)
    cls.aumc = lambda self, outeq=0, method=AUCMethod.LINEAR: aumc_blq(
        self, outeq, method, BLQRule.EXCLUDE
    )

    cls.auc_first = lambda self, outeq=0, method=AUCMethod.LINEAR: _first(
        cls.auc_metric(self, outeq, method)
    )
    cls.cmax_first = lambda self, outeq=0: _first(cls.cmax(self, outeq))
    cls.tmax_first = lambda self, outeq=0: _first(cls.tmax(self, outeq))
    cls.clast_first = lambda self, outeq=0: _first(cls.clast(self, outeq))
    cls.tlast_first = lambda self, outeq=0: _first(cls.tlast(self, outeq))
    cls.aumc_first = lambda self, outeq=0, method=AUCMethod.LINEAR: _first(
        cls.aumc(self, outeq, method)
    )


for _cls in (Occasion, Subject, Data):
    _install(_cls)
