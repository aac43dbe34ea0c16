"""The port's optimize layer against the JAX package's: Nelder-Mead,
support-point refinement, ``get_e2``, and beside them the ``Parameters``
ingress and the stage timers the population fit uses. The cases of
``tests/test_optimize.py`` on the port's functions, with the JAX package's
values beside them (float64 on the CPU).
"""

import math

import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu import optimize as jax_optimize

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.errors import ParameterError
from pharmsol_tpu_torch.optimize import (
    ParameterOptimizer, find_m0, get_e2, initial_simplex, nelder_mead,
)
from pharmsol_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _rosen(p):
    x, y = p
    return (1 - x) ** 2 + 100 * (y - x * x) ** 2


def test_nelder_mead_rosenbrock():
    res = nelder_mead(_rosen, initial_simplex([-1.2, 1.0], 0.1), sd_tolerance=1e-14,
                      max_iters=2000)
    np.testing.assert_allclose(res.best_param, [1.0, 1.0], atol=1e-3)
    want = jax_optimize.nelder_mead(_rosen, jax_optimize.initial_simplex([-1.2, 1.0], 0.1),
                                    sd_tolerance=1e-14, max_iters=2000)
    np.testing.assert_array_equal(res.best_param, want.best_param)
    assert (res.best_cost, res.iterations, res.converged) == (
        want.best_cost, want.iterations, want.converged)
    np.testing.assert_array_equal(initial_simplex([0.0, 2.0, -3.0]),
                                  jax_optimize.initial_simplex([0.0, 2.0, -3.0]))


def test_get_e2_single_site():
    # reference doc example: a=1, b=0 -> xm=1 -> E2=0.5
    assert abs(get_e2(1.0, 0.0, 0.0, 1.0, 1.0, 0.5) - 0.5) < 1e-6
    # b-only: xm = b^(1/h2)
    e2 = get_e2(0.0, 4.0, 0.0, 1.0, 2.0, 0.5)
    assert abs(e2 - 2.0 / 3.0) < 1e-9
    assert e2 == jax_optimize.get_e2(0.0, 4.0, 0.0, 1.0, 2.0, 0.5)


def test_get_e2_dual_site():
    e2 = get_e2(1.0, 1.0, 0.0, 1.0, 2.0, 0.5)
    assert 0.0 < e2 < 1.0
    # the root property: a/xm^h1 + b/xm^h2 == 1 at the solution
    xm = e2 / (1.0 - e2)
    assert abs(1.0 / xm + 1.0 / xm**2 - 1.0) < 1e-4
    rng = np.random.RandomState(0)
    for _ in range(10):
        a, b, w = rng.uniform(0.1, 3.0, 3)
        h1, h2 = rng.uniform(0.5, 3.0, 2)
        assert get_e2(a, b, w, h1, h2, 0.5) == jax_optimize.get_e2(a, b, w, h1, h2, 0.5)
        assert find_m0(a, b, w, h1, h2) == jax_optimize.find_m0(a, b, w, h1, h2)


def test_get_e2_trivial():
    assert get_e2(0.0, 0.0, 0.0, 1.0, 1.0, 0.5) == 0.0


def _one_cmt_case(lib):
    ke_true, v_true = 0.2, 10.0
    model = lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[:1] / p[1],
                           nstates=1, ndrugs=1, nout=1)
    subjects = []
    for i in range(4):
        b = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
        for t in (0.5, 1.0, 2.0, 4.0, 8.0):
            b = b.observation(t, 100.0 / v_true * math.exp(-ke_true * t), 0)
        subjects.append(b.build())
    ems = lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.3, 0.05), 0.5))
    return model, lib.Data(subjects), ems


@pytest.mark.parametrize("engine", ["general", "fused"])
def test_parameter_optimizer_improves_point(engine):
    pyl = np.full(4, 1e-3)
    opt = ParameterOptimizer(*_one_cmt_case(pt), pyl, engine=engine)
    start = np.array([0.25, 11.0])
    refined = opt.optimize_point(start)
    assert opt.cost(refined) <= opt.cost(start) + 1e-12
    want = jax_optimize.ParameterOptimizer(*_one_cmt_case(pst), pyl)
    assert abs(opt.cost(start) - want.cost(start)) <= 1e-10 * abs(want.cost(start))
    np.testing.assert_allclose(refined, want.optimize_point(start), rtol=1e-9)
    with pytest.raises(ValueError, match="rows"):
        ParameterOptimizer(*_one_cmt_case(pt), np.ones(3), engine=engine).cost(start)


def _with_metadata(lib):
    md = (lib.metadata.new("m").parameters(["ka", "ke", "v"]).states(["depot", "central"])
          .outputs(["cp"]).routes([lib.Route.bolus("oral").to_state("depot")]))
    return lib.Analytical(lib.one_compartment_with_absorption,
                          out=lambda x, p, t, cov: x[1:2] / p[2],
                          nstates=2, ndrugs=1, nout=1).with_metadata(md)


def test_parameters_ingress_matches_the_jax_package():
    named = [("v", 10.0), ("ka", 1.0), ("ke", 0.1)]
    got = pt.Parameters.with_model(_with_metadata(pt), named)
    want = pst.Parameters.with_model(_with_metadata(pst), named)
    np.testing.assert_array_equal(got.as_array(), want.as_array())
    assert got.into_inner() == [1.0, 0.1, 10.0] and len(got) == 3
    np.testing.assert_array_equal(np.asarray(pt.dense([3.0, 4.0])), [3.0, 4.0])
    order = pt.ParameterOrder.with_model(_with_metadata(pt), ["v", "ka", "ke"])
    ref = pst.ParameterOrder.with_model(_with_metadata(pst), ["v", "ka", "ke"])
    assert order.permutation() == ref.permutation() and not order.is_identity()
    table = np.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(order.matrix(table), ref.matrix(table))
    np.testing.assert_array_equal(order.values([10.0, 1.0, 0.1]), [1.0, 0.1, 10.0])
    for bad in ([("v", 10.0), ("ka", 1.0)], named + [("ka", 2.0)]):
        with pytest.raises(ParameterError):
            pt.Parameters.with_model(_with_metadata(pt), bad)
    with pytest.raises(ParameterError, match="metadata"):
        pt.Parameters.with_model(_one_cmt_case(pt)[0], named)


def test_stage_timers_record_and_report():
    profiling.reset_stages()
    for _ in range(3):
        with profiling.stage("unit/a"):
            pass
    with profiling.stage("unit/b", "cpu"):  # a CPU device asks for no synchronisation
        pass
    counts = profiling.stage_counts()
    assert counts["unit/a"][0] == 3 and counts["unit/b"][0] == 1
    report = profiling.stage_report().splitlines()
    assert report[0].split() == ["stage", "calls", "total_s", "mean_ms"]
    assert {ln.split()[0] for ln in report[1:]} == {"unit/a", "unit/b"}
    with pytest.raises(RuntimeError):
        with profiling.stage("unit/raises"):
            raise RuntimeError("inside")
    assert profiling.stage_counts()["unit/raises"][0] == 1  # recorded on the way out
    profiling.reset_stages()
    assert profiling.stage_counts() == {}
