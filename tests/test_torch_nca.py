"""The port's NCA layer (``pharmsol_tpu_torch/nca/``, copies of the JAX
package's framework-free modules over the port's data layer) against the
JAX package's (mirrors ``tests/test_nca.py`` and
``tests/test_dsl_extras.py::test_superposition_attached_to_subject``).

- Every test of ``tests/test_nca.py`` runs on the port: its source with the
  imports pointed at the port (:func:`port_module`), its PKNCA
  goldens at its own tolerance (0.1% relative / 1e-10 absolute).
- Parity: the NCA results of the same subjects in both packages, through
  the NCA result's JSON schema (``data/serde.py``), equal as texts: the
  same float64 arithmetic.
- The NCA result's serde round trip, and the methods that ``nca/__init__``
  attaches to ``Subject`` and ``Data``.
"""

import math
import types
from pathlib import Path

import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu.nca import NCAOptions as JaxOptions
from pharmsol_tpu.nca import nca as jax_nca

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.data import serde
from pharmsol_tpu_torch.nca import NCAOptions, NCAResult, nca

HERE = Path(__file__).resolve().parent


# -- a JAX-package test module run against the port ----------------------------


def port_module(filename: str) -> types.ModuleType:
    """The JAX-package test module ``filename`` with its ``pharmsol_tpu``
    imports pointed at ``pharmsol_tpu_torch`` (nothing else of it changes),
    executed as a module of its own."""
    src = (HERE / filename).read_text()
    src = src.replace("from pharmsol_tpu import", "from pharmsol_tpu_torch import")
    src = src.replace("from pharmsol_tpu.", "from pharmsol_tpu_torch.")
    src = src.replace("import pharmsol_tpu as pst", "import pharmsol_tpu_torch as pst")
    mod = types.ModuleType("port_" + filename[:-3])
    mod.__file__ = str(HERE / filename)
    exec(compile(src, f"<port of {filename}>", "exec"), mod.__dict__)
    return mod


def suite_tests(mod, exclude=()) -> list:
    """The module's test functions and test-class methods as names
    (``Class.method`` for the latter)."""
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and callable(obj) and name not in exclude:
            out.append(name)
        elif name.startswith("Test") and isinstance(obj, type):
            out += [f"{name}.{m}" for m in vars(obj) if m.startswith("test_")
                    and f"{name}.{m}" not in exclude]
    return out


def run(mod, name: str) -> None:
    if "." in name:
        cls, meth = name.split(".")
        getattr(getattr(mod, cls)(), meth)()
    else:
        getattr(mod, name)()


SUITE = port_module("test_nca.py")


@pytest.mark.parametrize("name", suite_tests(SUITE))
def test_nca_suite_on_the_port(name):
    run(SUITE, name)


def _subjects(lib):
    """Oral with a lag, IV bolus, a short infusion, BLQ in the middle, a
    steady state and two doses: each through ``nca``."""
    out = []
    b = lib.Subject.builder("oral").bolus(0.0, 100.0, 0)
    for t, c in [(0, 0), (0.5, 0), (1, 4.2), (2, 8.1), (4, 6.0), (8, 3.1), (12, 1.4), (24, 0.3)]:
        b = b.observation(float(t), float(c), 0)
    out.append((b.build(), dict()))
    b = lib.Subject.builder("iv").bolus(0.0, 100.0, 1)
    for t in (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 12.0):
        b = b.observation(t, 12.0 * math.exp(-0.27 * t), 0)
    out.append((b.build(), dict(tau=12.0)))
    b = lib.Subject.builder("inf").infusion(0.0, 100.0, 0, 0.75)
    for t in (0.5, 1.0, 2.0, 4.0, 8.0, 12.0):
        b = b.observation(t, 9.0 * math.exp(-0.2 * t), 0)
    out.append((b.build(), dict()))
    b = lib.Subject.builder("blq").bolus(0.0, 100.0, 0)
    for t, c in [(0.5, 2.0), (1, 6.0), (2, 5.0), (4, 2.5), (8, 1.1), (12, 0.4)]:
        b = b.observation(float(t), float(c), 0)
    b = b.censored_observation(6.0, 0.5, 0, lib.Censor.BLOQ)
    out.append((b.build(), dict()))
    b = lib.Subject.builder("md").bolus(0.0, 100.0, 0).bolus(12.0, 100.0, 0)
    for t, c in [(1, 8), (4, 5), (8, 2.5), (13, 9), (16, 6), (20, 3), (24, 1.5)]:
        b = b.observation(float(t), float(c), 0)
    out.append((b.build(), dict(dose_times=[0.0, 12.0])))
    return out


def _options(lib_options, kw):
    o = lib_options()
    if "tau" in kw:
        o = o.with_tau(kw["tau"])
    if "dose_times" in kw:
        o = o.with_dose_times(kw["dose_times"])
    return o


def test_results_equal_the_jax_package_through_the_schema():
    for (s, kw), (js, _) in zip(_subjects(pt), _subjects(pst)):
        got = nca(s, _options(NCAOptions, kw))
        want = jax_nca(js, _options(JaxOptions, kw))
        assert pt.to_json(got) == pst.to_json(want), s.id


def test_nca_result_serde_round_trip(tmp_path):
    for s, kw in _subjects(pt):
        r = nca(s, _options(NCAOptions, kw))
        text = pt.to_json(r)
        back = pt.from_json(text)
        assert isinstance(back, NCAResult)
        assert pt.to_json(back) == text
        assert pst.to_json(pst.from_json(text)) == text  # the JAX package reads it
        assert serde.nca_result_from_dict(serde.nca_result_to_dict(r)).exposure == r.exposure
    p = tmp_path / "r.json"
    pt.save_json(r, str(p))
    assert pt.to_json(pt.load_json(str(p))) == pt.to_json(r)


def test_methods_attached_to_subject_and_data():
    s, _ = _subjects(pt)[0]
    d = pt.Data([x for x, _ in _subjects(pt)[:3]])
    assert s.nca().exposure.cmax == nca(s).exposure.cmax
    assert len(s.nca_all()) == 1 and len(d.nca_all()) == 3
    assert [g.subject_id for g in d.nca_grouped()] == ["oral", "iv", "inf"]
    js, _ = _subjects(pst)[0]
    for name in ("auc_metric", "aumc", "cmax", "tmax", "clast", "tlast", "cmax_first",
                 "auc_first"):
        assert getattr(s, name)() == getattr(js, name)(), name


def test_superposition_attached_to_subject():
    """``test_dsl_extras.py::test_superposition_attached_to_subject`` on the
    port, and the result equal to the JAX package's."""
    results = []
    for lib in (pt, pst):
        b = lib.Subject.builder("sp").bolus(0.0, 100.0, 1)
        for t in np.linspace(0.0, 48.0, 25):
            b = b.observation(float(t), 10.0 * math.exp(-0.2 * t), 0)
        results.append(b.build().superposition(tau=12.0, n_eval_points=13))
    want = 1.0 / (1.0 - math.exp(-0.2 * 12.0))
    assert abs(results[0].accumulation_ratio - want) / want < 0.05
    assert results[0].accumulation_ratio == results[1].accumulation_ratio
    np.testing.assert_array_equal(results[0].concentrations, results[1].concentrations)
