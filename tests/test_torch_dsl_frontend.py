"""The port's DSL frontend (lexer, parser, analyzer, diagnostics) against the
JAX package's.

The cases are the JAX package's own: every test of
``tests/test_dsl_diagnostics.py``, the diagnostic tests of
``tests/test_dsl_arrays.py`` and ``tests/test_dsl.py`` (:293-330) and the
analyzer cases of ``tests/test_reference_literals_3.py`` (:764-815). Each
JAX test runs as it is, with its module's ``compile_model`` /
``compile_module`` recording every source it compiles; each recorded
source then goes through both packages, and the diagnostics (severity,
code, message, span, notes, help, suggestion) are equal, or, where the
source compiles, the analyzed models serialize to the same JSON.
"""

import dataclasses

import pytest

import pharmsol_tpu.dsl as jdsl
import pharmsol_tpu.dsl.runtime as jruntime
import pharmsol_tpu_torch.dsl as tdsl
import pharmsol_tpu_torch.dsl.runtime as truntime

import test_dsl
import test_dsl_arrays
import test_dsl_diagnostics
import test_reference_literals_3

# (module, test name, the compile entry point it calls)
_SOURCES = (
    [(test_dsl_diagnostics, name, "compile_model") for name in sorted(dir(test_dsl_diagnostics))
     if name.startswith("test_") and name != "test_covariate_sourced_kernel_binding"]
    + [(test_dsl_arrays, name, "compile_module") for name in (
        "test_index_out_of_bounds_diagnosed", "test_dx_sugar_ambiguous_with_two_arrays",
        "test_indexing_scalar_state_diagnosed", "test_uncovered_array_element_diagnosed",
        "test_indexed_dx_in_loop_covers_array", "test_partial_loop_coverage_diagnosed")]
    + [(test_dsl, name, "compile_model") for name in (
        "test_diagnostics_unknown_name_with_suggestion", "test_diagnostics_missing_structure",
        "test_diagnostics_lag_on_infusion_rejected", "test_diagnostics_missing_dx")]
    + [(test_reference_literals_3, name, "compile_model") for name in (
        "test_analytical_structure_requirement_satisfied_by_derive",
        "test_analytical_structure_missing_name_suggests",
        "test_analytical_params_derive_overlap_rejected")]
)


def _outcome(pkg, runtime, entry: str, src: str):
    """("error", diagnostics as dicts) or ("ok", the analyzed models' JSON)."""
    try:
        out = getattr(pkg, entry)(src)
    except pkg.DslError as e:
        return "error", [dataclasses.asdict(d) for d in e.diagnostics]
    models = out if isinstance(out, list) else [out]
    return "ok", [runtime._am_to_json(m.analyzed) for m in models]


@pytest.mark.parametrize("module, name, entry", _SOURCES,
                         ids=[f"{m.__name__}::{n}" for m, n, _ in _SOURCES])
def test_frontend_matches_the_jax_package(module, name, entry, monkeypatch):
    sources = []
    real = getattr(jdsl, entry)

    def recording(src, *args, **kwargs):
        sources.append(src)
        return real(src, *args, **kwargs)

    monkeypatch.setattr(module, entry, recording)
    getattr(module, name)()  # the JAX test, as it is (it asserts on the JAX side)
    assert sources, f"{name} compiled no source"
    for src in sources:
        want = _outcome(jdsl, jruntime, entry, src)
        got = _outcome(tdsl, truntime, entry, src)
        assert got == want, src
