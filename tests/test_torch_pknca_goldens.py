"""The PKNCA cross-validation goldens on the port (mirrors
``tests/test_pknca_goldens.py``): every case of that file runs on the
port's ``nca`` (its source with the imports pointed at the port,
``test_torch_nca.py::port_module``) at its own tolerance, 0.1% relative / 1e-10
absolute; and each case's full NCA result equals the JAX package's through
the NCA result's JSON schema (the same float64 arithmetic: equal texts).
"""

import pytest

import pharmsol_tpu as pst
import pharmsol_tpu_torch as pt

from test_torch_nca import port_module, run, suite_tests

SUITE = port_module("test_pknca_goldens.py")
import test_pknca_goldens as jax_goldens  # noqa: E402


@pytest.mark.parametrize("name", [n for n in suite_tests(SUITE) if n != "test_pknca_golden"])
def test_pknca_suite_on_the_port(name):
    run(SUITE, name)


@pytest.mark.parametrize("case", SUITE.CASES, ids=[c[0] for c in SUITE.CASES])
def test_pknca_golden_on_the_port(case):
    name, doses, obs, make_options, expected = case
    SUITE.check(SUITE.nca(SUITE.build(name, doses, obs), make_options()), expected)


@pytest.mark.parametrize("i", range(len(SUITE.CASES)), ids=[c[0] for c in SUITE.CASES])
def test_pknca_result_equals_the_jax_package(i):
    name, doses, obs, make_options, _ = SUITE.CASES[i]
    jname, jdoses, jobs, jmake_options, _ = jax_goldens.CASES[i]
    got = SUITE.nca(SUITE.build(name, doses, obs), make_options())
    want = jax_goldens.nca(jax_goldens.build(jname, jdoses, jobs), jmake_options())
    assert pt.to_json(got) == pst.to_json(want)
