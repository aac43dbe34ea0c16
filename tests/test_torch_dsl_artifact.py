""".pkm artifacts across the two packages, their validation, and the
stdlib-only evaluator of the port (``dsl/pure.py``).

An artifact written by the JAX package's ``save_artifact`` loads in the port
and predicts what the JAX model predicts (1e-10 relative), and one written
by the port loads in the JAX package the same way; the two packages write
the same payload for the same source. ``validate_artifact`` takes the
shared ``schemas/pkm-v1.json`` (DSL4004 on a corrupted payload), and the
loader raises DSL4002 on another format and DSL4003 on a newer version. The
port's ``pure.py`` imports nothing beyond the standard library, and its
fixed-step simulation matches the port's runtime at its RK4 accuracy (ODE
1e-4), exactly for a closed form (1e-9), and up to the Euler-Maruyama step
for an SDE at zero diffusion (6e-3, as the JAX package's test).
"""

import ast as pyast
import json

import numpy as np
import pytest

import pharmsol_tpu as pst
import pharmsol_tpu.dsl as jdsl
import pharmsol_tpu_torch as pt
import pharmsol_tpu_torch.dsl as tdsl
from pharmsol_tpu_torch.dsl.pure import PureCovariate, PureModel

from test_dsl import ANALYTICAL_SRC, ODE_SRC
from test_dsl_arrays import TRANSIT_CANONICAL
from test_pure_artifact import ANALYTICAL_SRC as PURE_ANALYTICAL_SRC
from test_pure_artifact import SDE_ZERO_DIFF_SRC
from test_pure_artifact import SRC as PURE_ODE_SRC


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _subject(lib, route, out, covariate=False, infusion=False):
    b = lib.Subject.builder("s").bolus(0.0, 100.0, route)
    if infusion:
        b = b.infusion(12.0, 50.0, "iv", 2.0)
    if covariate:
        b = b.covariate("wt", 0.0, 80.0)
    for t in (1.0, 4.0, 13.0, 24.0):
        b = b.observation(t, 0.0, out)
    return b.build()


# name: (source, route, output, covariate, infusion, parameters)
CASES = {
    "ode": (ODE_SRC, "oral", "cp", True, True, [1.2, 5.0, 40.0, 0.5, 0.8]),
    "analytical": (ANALYTICAL_SRC, "oral", "cp", False, False, [1.0, 0.15, 25.0, 0.5, 0.8]),
    "transit": (TRANSIT_CANONICAL, "oral", "y", False, False, [1.8, 0.3, 25.0]),
}


def _predict(runtime, lib, case):
    _, route, out, cov, inf, p = CASES[case]
    s = _subject(lib, route, out, cov, inf)
    return np.asarray(runtime.estimate_predictions(s, p).flat_predictions())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_artifacts_cross_the_packages(case, direction, tmp_path):
    src = CASES[case][0]
    jax_rt = jdsl.compile_module_source_to_runtime(src)
    port_rt = tdsl.compile_module_source_to_runtime(src)
    path = str(tmp_path / f"{case}.pkm")
    # the schema's name pattern refuses array states' element names in both
    # packages (test_validation_and_loader_diagnostics)
    validate = case != "transit"
    if direction == "jax_to_port":
        jdsl.save_artifact(jax_rt, path)
        loaded = tdsl.load_runtime_artifact(path, validate=validate)
        got, want = _predict(loaded, pt, case), _predict(jax_rt, pst, case)
    else:
        tdsl.save_artifact(port_rt, path)
        loaded = jdsl.load_runtime_artifact(path, validate=validate)
        got, want = _predict(loaded, pst, case), _predict(port_rt, pt, case)
    assert loaded.analyzed.name == jax_rt.analyzed.name
    assert loaded.info() == jax_rt.info()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
    # both packages write the same payload for the same source
    other = str(tmp_path / "other.pkm")
    (jdsl if direction == "port_to_jax" else tdsl).save_artifact(
        jax_rt if direction == "port_to_jax" else port_rt, other)
    assert json.load(open(path)) == json.load(open(other))


def test_validation_and_loader_diagnostics(tmp_path):
    schema = tdsl.artifact_schema()
    assert schema == jdsl.artifact_schema()
    assert schema["properties"]["format"]["const"] == tdsl.ARTIFACT_FORMAT == "pharmsol-tpu-pkm"
    runtime = tdsl.compile_model(ODE_SRC)
    path = str(tmp_path / "model.pkm")
    runtime.save_artifact(path)
    tdsl.validate_artifact(path)  # must not raise
    payload = json.loads(open(path).read())
    payload["model"]["kind"] = "quantum"
    with pytest.raises(tdsl.DslError) as err:
        tdsl.validate_artifact(payload)
    assert "DSL4004" in str(err.value)
    with pytest.raises(jdsl.DslError) as jerr:
        jdsl.validate_artifact(payload)
    assert [d.to_dict() for d in err.value.diagnostics] == \
        [d.to_dict() for d in jerr.value.diagnostics]
    # an array state's element names (`a[0]`) fall outside the schema's name
    # pattern: both packages refuse such an artifact alike
    arrays = str(tmp_path / "transit.pkm")
    tdsl.compile_model(TRANSIT_CANONICAL).save_artifact(arrays)
    with pytest.raises(tdsl.DslError) as err:
        tdsl.validate_artifact(arrays)
    with pytest.raises(jdsl.DslError) as jerr:
        jdsl.validate_artifact(arrays)
    assert str(err.value) == str(jerr.value) and "DSL4004" in str(err.value)

    bad = str(tmp_path / "not_a_model.pkm")
    with open(bad, "w") as f:
        json.dump({"format": "something-else"}, f)
    with pytest.raises(tdsl.DslError) as err:
        tdsl.load_runtime_artifact(bad)
    assert err.value.diagnostics[0].code == "DSL4002"

    newer = json.loads(open(path).read())
    newer["version"] = tdsl.ARTIFACT_VERSION + 1
    with open(bad, "w") as f:
        json.dump(newer, f)
    with pytest.raises(tdsl.DslError) as err:
        tdsl.load_runtime_artifact(bad)
    assert err.value.diagnostics[0].code == "DSL4003"
    with pytest.raises(jdsl.DslError) as jerr:
        jdsl.load_runtime_artifact(bad)
    assert str(err.value) == str(jerr.value)


def test_pure_module_imports_the_standard_library_only():
    """The evaluator must be vendorable: no torch, no jax, no numpy."""
    import pharmsol_tpu_torch.dsl.pure as pure

    tree = pyast.parse(open(pure.__file__).read())
    imported = set()
    for node in pyast.walk(tree):
        if isinstance(node, pyast.Import):
            imported.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, pyast.ImportFrom) and node.level == 0:
            imported.add((node.module or "").split(".")[0])
    assert not imported & {"torch", "jax", "numpy"}, imported


def _pure(src, tmp_path):
    runtime = tdsl.compile_model(src)
    path = str(tmp_path / "pure.pkm")
    runtime.save_artifact(path)
    return runtime, PureModel.load(path)


@pytest.mark.parametrize("kind", ["ode", "analytical", "sde"])
def test_pure_tier_matches_the_port_runtime(kind, tmp_path):
    src, times, tol = {
        "ode": (PURE_ODE_SRC, [1.0, 4.0, 12.0], 1e-4),
        "analytical": (PURE_ANALYTICAL_SRC, [1.0, 4.0, 12.0, 24.0], 1e-9),
        "sde": (SDE_ZERO_DIFF_SRC, [0.5, 1.0, 2.0], 6e-3),
    }[kind]
    runtime, pure = _pure(src, tmp_path)
    assert pure.kind == kind
    if kind == "sde":
        params, boluses, route, cov = [0.3, 10.0], [(0.0, 100.0, 0)], "iv", None
        kw = dict(dt=0.002, nparticles=4)
    else:
        params, route = [1.2, 4.0, 35.0], "oral"
        boluses = [(0.0, 100.0, 0)] + ([(12.0, 50.0, 0)] if kind == "analytical" else [])
        cov = {"wt": PureCovariate([(0.0, 80.0)])}
        kw = dict(cov=cov) if kind == "analytical" else dict(cov=cov, dt=0.005)
    b = pt.Subject.builder("s")
    for t, amount, _ in boluses:
        b = b.bolus(t, amount, route)
    if cov is not None:
        b = b.covariate("wt", 0.0, 80.0)
    for t in times:
        b = b.observation(t, 0.0, "cp")
    want = np.asarray(runtime.model.estimate_predictions(b.build(), params).flat_predictions())
    got = pure.simulate(params, boluses=boluses, obs_times=times, **kw)
    np.testing.assert_allclose([g[0] for g in got], want, rtol=tol)
