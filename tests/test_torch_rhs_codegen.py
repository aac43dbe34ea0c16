"""The CUDA RHS generator: what it accepts, what it rejects, and what it emits.

Acceptance is the plan-time check that a model's RHS can run in the CUDA ODE
kernel (the port's counterpart of the JAX plan's probe kernel). Where ``g++``
is present, the emitted header is compiled as host C++ (``__device__`` defined
away) and held against the torch closure on random inputs within 1e-14.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood import matrix
from pharmsol_tpu_torch.ops.rhs_codegen import generate_rhs, generate_sde


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _short(x, p, t, b, rateiv, cov):  # bench.py:210-214, the 2-cmt oral ODE
    return torch.stack([
        -p[1] * x[0] + b[0],
        p[1] * x[0] - (p[0] + p[2]) * x[1] + p[3] * x[2] + rateiv[0],
        p[2] * x[1] - p[3] * x[2],
    ])


def _two_state(x, p, t, b, rateiv, cov):
    return torch.stack([-p[0] * x[0] + b[0],
                        p[0] * x[0] - p[1] * x[1] + rateiv[0]])


def _michaelis_menten(x, p, t, b, rateiv, cov):
    return torch.stack([-p[0] * x[0] / (p[1] + x[0]) + b[0] + rateiv[0]])


def _multi_input(x, p, t, b, rateiv, cov):
    return torch.stack([
        -p[0] * x[0] + b[0] + rateiv[1],
        -p[1] * x[1] + b[1],
        p[0] * x[0] + p[1] * x[1] - p[2] * x[2] + rateiv[0],
    ])


def _exotic(x, p, t, b, rateiv, cov):
    # exp, **, where, min/max/clamp, sqrt, log, abs, unary minus, constants
    k = p[0] * torch.exp(-0.05 * t) + p[1] ** 2 / (1.0 + x[1] ** 0.5)
    sat = torch.where(x[0] > 2.0, x[0] ** 1.5, 2.0 * x[0])
    return [
        -k * sat + b[0],
        k * sat - torch.clamp(p[1] * x[1], min=0.0, max=50.0)
        + torch.maximum(rateiv[0], torch.minimum(x[0], x[2])),
        torch.sqrt(abs(x[1]) + 1.0) - torch.log(1.0 + x[2]) - (-x[2]) ** 2,
    ]


def _dsl_intrinsics(x, p, t, b, rateiv, cov):
    # the DSL's intrinsics beyond exp/log/sqrt/abs/pow/min/max: floor, ceil,
    # round (half to even), sin, cos, tan, log10, log2
    k = p[0] * (1.0 + 0.1 * torch.sin(x[0]) + 0.1 * torch.cos(t) + 0.05 * torch.tan(0.2 * x[1]))
    step = torch.floor(p[1]) + torch.ceil(0.5 * x[1]) - torch.round(2.0 * x[0])
    return [-k * x[0] + b[0],
            k * x[0] - 0.01 * step - torch.log10(1.0 + x[1]) * torch.log2(2.0 + x[0])
            + rateiv[0]]


def _covariates(x, p, t, b, rateiv, cov):
    # the reference's covariate example: ke * (crcl(t)/75)**0.75 * (age/25)**0.5
    ke = p[1] * (cov("crcl", t) / 75.0) ** 0.75 * (cov("age", t) / 25.0) ** 0.5
    return torch.stack([-p[0] * x[0] + b[0], p[0] * x[0] - ke * x[1]])


def _shifted_read(x, p, t, b, rateiv, cov):
    # reads at a shifted time and through value()
    return torch.stack([-p[0] * cov("wt", t - 1.5) / 70.0 * x[0] + b[0]
                        + 0.01 * cov.value("wt", t)])


# name: (closure, states, parameters, inputs, (covariate names, modes))
ACCEPTED = {
    "short": (_short, 3, 5, 1, ((), ())),
    "two_state": (_two_state, 2, 3, 1, ((), ())),
    "michaelis_menten": (_michaelis_menten, 1, 3, 1, ((), ())),
    "multi_input": (_multi_input, 3, 4, 2, ((), ())),
    "exotic": (_exotic, 3, 2, 1, ((), ())),
    "dsl_intrinsics": (_dsl_intrinsics, 2, 2, 1, ((), ())),
    "covariates": (_covariates, 2, 4, 1, (("age", "crcl"), ("const", "affine"))),
    "covariates_const": (_covariates, 2, 4, 1, (("age", "crcl"), ("const", "const"))),
    "shifted_read": (_shifted_read, 1, 2, 1, (("wt",), ("affine",))),
}


@pytest.mark.parametrize("name", list(ACCEPTED))
def test_generator_accepts(name):
    fn, n, n_params, ninput, covs = ACCEPTED[name]
    rhs = generate_rhs(fn, n, n_params, ninput, *covs)
    assert rhs.n_states == n and rhs.n_params == n_params
    assert (rhs.cov_names, rhs.cov_modes) == covs
    assert "template <typename T>" in rhs.source
    assert f"#define PHARMSOL_RHS_NSTATES {n}" in rhs.source
    assert f"#define PHARMSOL_RHS_NCOV {len(covs[0])}" in rhs.source
    for i in range(n):
        assert f"dx[{i}] = " in rhs.source
    # the same formula written again gives the same source (one library)
    assert generate_rhs(fn, n, n_params, ninput, *covs).key == rhs.key


def test_covariate_reads_trace_by_mode():
    """A constant covariate is the leaf cov_a[i]; an affine one cov_a[i] +
    cov_b[i] * t at the time the closure passed, and the evaluated graph
    equals the closure given the same coefficients."""
    from pharmsol_tpu_torch.ops.rhs_codegen import _ODE_ARGS, _sizes, _trace, evaluate

    for modes in (("const", "affine"), ("affine", "affine")):
        rhs = generate_rhs(_covariates, 2, 4, 1, ("age", "crcl"), modes)
        src = rhs.source
        assert "cov_a[0]" in src and "cov_a[1]" in src
        assert ("cov_b[0]" in src) == (modes[0] == "affine")
        assert "cov_b[1] * t" in src
        outputs = _trace(_covariates, _sizes(_ODE_ARGS, 2, 4, 1), 2, covs=(("age", "crcl"), modes))
        rng = np.random.RandomState(3)
        x, p = torch.as_tensor(rng.uniform(0.5, 2, 2)), torch.as_tensor(rng.uniform(0.5, 2, 4))
        a, b = torch.tensor([40.0, 90.0], dtype=torch.float64), torch.tensor([0.3, -2.0], dtype=torch.float64)
        t = torch.tensor(1.7, dtype=torch.float64)
        z = torch.zeros(1, dtype=torch.float64)

        def cov(name, tt):
            i = ("age", "crcl").index(name)
            return a[i] if modes[i] == "const" else a[i] + b[i] * tt

        got = evaluate(outputs, x=x, p=p, t=t, b=z, rateiv=z, cov_a=a, cov_b=b)
        torch.testing.assert_close(got, _covariates(x, p, t, z, z, cov), rtol=1e-15, atol=0)


def test_shifted_covariate_read_is_exact():
    """cov("wt", t - 1.5) reads a + b (t - 1.5): the generated line."""
    src = generate_rhs(_shifted_read, 1, 2, 1, ("wt",), ("affine",)).source
    assert "t - T(1.5)" in src and "cov_b[0] * t;" in src


def test_unknown_covariate_and_bad_modes_are_refused():
    with pytest.raises(PharmsolError, match="unknown covariate `crcl`"):
        generate_rhs(_covariates, 2, 4, 1, ("age", "creatinine"), ("const", "affine"))
    with pytest.raises(ValueError, match="cov_modes"):
        generate_rhs(_covariates, 2, 4, 1, ("age", "crcl"), ("const", "linear"))


def _if_on_state(x, p, t, b, rateiv, cov):
    if x[0] > 1.0:
        return torch.stack([-p[0] * x[0] + b[0]])
    return torch.stack([-p[1] * x[0] + b[0]])


def _in_place(x, p, t, b, rateiv, cov):
    dx = torch.zeros(1)
    dx[0] = -p[0] * x[0] + b[0]
    return dx


def _unknown_op(x, p, t, b, rateiv, cov):
    return torch.stack([-p[0] * torch.tanh(x[0]) + b[0]])


def _covariate(x, p, t, b, rateiv, cov):
    return torch.stack([-p[0] * cov("wt", t) * x[0] + b[0]])


REJECTED = {
    "python_if": (_if_on_state, "branches on a traced value"),
    "in_place": (_in_place, "in place"),
    "unknown_op": (_unknown_op, "`tanh`"),
    # a covariate the data does not carry (here: none)
    "covariate": (_covariate, "unknown covariate `wt`"),
}


@pytest.mark.parametrize("name", list(REJECTED))
def test_generator_rejects_with_a_reason(name):
    fn, reason = REJECTED[name]
    with pytest.raises(PharmsolError, match=reason):
        generate_rhs(fn, 1, 3, 1)


def test_out_of_range_index_is_rejected():
    with pytest.raises(PharmsolError, match=r"p\[3\], out of range"):
        generate_rhs(lambda x, p, t, b, r, cov: [-p[3] * x[0]], 1, 3, 1)


def _zeros_like_style(x, p, t, b, rateiv, cov):
    dx = torch.zeros_like(x)
    dx[0] = -p[0] * x[0] + b[0]
    return dx


@pytest.mark.parametrize("name, reason, general_runs", [
    ("python_if", "branches on a traced value", False),
    ("unknown_op", "`tanh`", True),
    ("zeros_like_style", "`zeros_like`", True),
])
def test_auto_records_the_rejection(name, reason, general_runs, monkeypatch):
    """engine='auto' with the fused route (forced, as on a CUDA device) takes
    the general engine and keeps the generator's reason; the decision is kept
    even where the general engine cannot run the closure either."""
    fn = {"python_if": _if_on_state, "unknown_op": _unknown_op,
          "zeros_like_style": _zeros_like_style}[name]
    monkeypatch.setattr(matrix, "_auto_engine",
                        lambda device: ("fused", "forced for the test"))
    model = pt.ODE(fn, out=lambda x, p, t, cov: x[0:1] / p[2],
                   nstates=1, ndrugs=1, nout=1)
    data = pt.Data([pt.Subject.builder("a").bolus(0.0, 100.0, 0)
                    .observation(1.0, 5.0, 0).observation(4.0, 2.0, 0).build()])
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    sp = np.array([[0.2, 0.3, 10.0], [0.4, 0.1, 20.0]])
    if general_runs:
        psi = pt.log_likelihood_matrix(model, data, sp, ems)
        assert torch.isfinite(psi).all()
    else:  # vmap refuses data-dependent control flow
        with pytest.raises(RuntimeError):
            pt.log_likelihood_matrix(model, data, sp, ems)
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general"
    assert "fused plan rejected the model" in decision["reason"]
    assert reason in decision["reason"]
    with pytest.raises(PharmsolError, match="cannot run in the CUDA kernel"):
        pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")


_WRAPPER = """
#define __device__
#define __forceinline__ inline
#include "rhs.h"
extern "C" void rhs_f64(const double* x, const double* p, double t,
                        const double* b, const double* r, const double* ca,
                        const double* cb, double* dx) {
  rhs<double>(x, p, t, b, r, ca, cb, dx);
}
"""


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("g++ not found: the host compile of the generated header is skipped")
    return path


@pytest.mark.parametrize("name", list(ACCEPTED))
def test_generated_header_matches_the_closure(name, gxx, tmp_path):
    fn, n, n_params, ninput, (names, modes) = ACCEPTED[name]
    rhs = generate_rhs(fn, n, n_params, ninput, names, modes)
    (tmp_path / "rhs.h").write_text(rhs.source)
    (tmp_path / "wrap.cpp").write_text(_WRAPPER)
    lib_path = tmp_path / "librhs.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(lib_path), str(tmp_path / "wrap.cpp")], check=True,
                   cwd=tmp_path)
    lib = ctypes.CDLL(str(lib_path))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rhs_f64.argtypes = [dp, dp, ctypes.c_double, dp, dp, dp, dp, dp]
    rng = np.random.RandomState(11)
    for _ in range(50):
        x = rng.uniform(0.0, 5.0, n)
        p = rng.uniform(0.1, 3.0, n_params)
        b = rng.uniform(0.0, 2.0, ninput)
        r = rng.uniform(0.0, 2.0, ninput)
        t = float(rng.uniform(0.0, 24.0))
        ca = rng.uniform(20.0, 120.0, max(len(names), 1))
        cb = rng.uniform(-2.0, 2.0, max(len(names), 1))
        tt = torch.tensor(t, dtype=torch.float64)

        def cov(name, at):
            i = names.index(name)
            return (torch.tensor(ca[i]) if modes[i] == "const"
                    else torch.tensor(ca[i]) + torch.tensor(cb[i]) * at)

        cov.value = cov
        want = fn(torch.as_tensor(x), torch.as_tensor(p), tt,
                  torch.as_tensor(b), torch.as_tensor(r), cov)
        if not isinstance(want, torch.Tensor):
            want = torch.stack(list(want))
        want = want.numpy()
        got = np.zeros(n)
        lib.rhs_f64(*(np.ascontiguousarray(a).ctypes.data_as(dp) for a in (x, p)),
                    t, *(np.ascontiguousarray(a).ctypes.data_as(dp) for a in (b, r, ca, cb)),
                    got.ctypes.data_as(dp))
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14 * scale)


# ---------------------------------------------------------------------------
# The covariate-only terms: rhs_pre and rhs_body
# ---------------------------------------------------------------------------


def _param_terms(x, p, t, b, rateiv, cov):
    # no covariate: an allometric clearance of the parameters alone
    cl = p[0] * (p[2] / 70.0) ** 0.75
    return torch.stack([-p[1] * x[0] + b[0], p[1] * x[0] - cl / p[3] * x[1] + rateiv[0]])


# name: (closure, states, parameters, inputs, covariates, covariate-only terms)
SPLIT = {
    "covariates": ACCEPTED["covariates"][:4] + (ACCEPTED["covariates"][4], 1),
    "covariates_const": ACCEPTED["covariates_const"][:4] + (ACCEPTED["covariates_const"][4], 1),
    "shifted_read": ACCEPTED["shifted_read"][:4] + (ACCEPTED["shifted_read"][4], 2),
    "param_terms": (_param_terms, 2, 4, 1, ((), ()), 1),
    "exotic": ACCEPTED["exotic"][:4] + (ACCEPTED["exotic"][4], 1),
    "short": ACCEPTED["short"][:4] + (ACCEPTED["short"][4], 0),
    "michaelis_menten": ACCEPTED["michaelis_menten"][:4] + (ACCEPTED["michaelis_menten"][4], 0),
}


@pytest.mark.parametrize("name", list(SPLIT))
def test_covariate_only_terms_split_the_explicit_header(name):
    """A header without rhs_jvp splits rhs where a subexpression of
    parameters, constants and covariate values costs more than one
    operation; one that saves nothing (the 2-cmt oral RHS, whose only such
    term is p[0] + p[2]) keeps rhs alone, and so does every header with
    rhs_jvp."""
    fn, n, n_params, ninput, covs, n_pre = SPLIT[name]
    rhs = generate_rhs(fn, n, n_params, ninput, *covs)
    assert rhs.n_pre == n_pre
    assert ("void rhs_pre(" in rhs.source) == (n_pre > 0)
    assert ("void rhs_body(" in rhs.source) == (n_pre > 0)
    assert (f"#define PHARMSOL_RHS_NPRE {n_pre}" in rhs.source) == (n_pre > 0)
    with_jvp = generate_rhs(fn, n, n_params, ninput, *covs, jacobian=True)
    assert with_jvp.n_pre == 0 and "rhs_pre" not in with_jvp.source


_SPLIT_WRAPPER = _WRAPPER + """
extern "C" void split_f64(const double* x, const double* p, double t,
                          const double* b, const double* r, const double* ca,
                          const double* cb, double* dx) {
  double pre[PHARMSOL_RHS_NPRE];
  rhs_pre<double>(p, t, ca, cb, pre);
  rhs_body<double>(x, p, t, b, r, ca, cb, pre, dx);
}
"""


@pytest.mark.parametrize("name", [n for n, row in SPLIT.items() if row[5]])
def test_rhs_pre_and_rhs_body_equal_rhs_bit_for_bit(name, gxx, tmp_path):
    """rhs_pre then rhs_body give rhs's bits on random lanes, with every
    covariate's slope zero (the runs where the kernel computes rhs_pre once)
    and with slopes (where it computes them at each stage's time): the
    covariate model and models without covariates. Built without
    contraction, as the kernel's host build is."""
    fn, n, n_params, ninput, (names, modes), _ = SPLIT[name]
    rhs = generate_rhs(fn, n, n_params, ninput, names, modes)
    (tmp_path / "rhs.h").write_text(rhs.source)
    (tmp_path / "wrap.cpp").write_text(_SPLIT_WRAPPER)
    lib_path = tmp_path / "librhs.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(lib_path), str(tmp_path / "wrap.cpp")], check=True, cwd=tmp_path)
    lib = ctypes.CDLL(str(lib_path))
    dp = ctypes.POINTER(ctypes.c_double)
    for f in (lib.rhs_f64, lib.split_f64):
        f.argtypes = [dp, dp, ctypes.c_double, dp, dp, dp, dp, dp]

    def ptr(a):
        return np.ascontiguousarray(a).ctypes.data_as(dp)

    rng = np.random.RandomState(17)
    ncov = max(len(names), 1)
    for lane in range(200):
        x, p = rng.uniform(0.0, 5.0, n), rng.uniform(0.1, 3.0, n_params)
        b, r = rng.uniform(0.0, 2.0, ninput), rng.uniform(0.0, 2.0, ninput)
        t = float(rng.uniform(0.0, 24.0))
        ca = rng.uniform(20.0, 120.0, ncov)
        cb = np.zeros(ncov) if lane % 2 == 0 else rng.uniform(-2.0, 2.0, ncov)
        want, got = np.zeros(n), np.zeros(n)
        lib.rhs_f64(ptr(x), ptr(p), t, ptr(b), ptr(r), ptr(ca), ptr(cb), want.ctypes.data_as(dp))
        lib.split_f64(ptr(x), ptr(p), t, ptr(b), ptr(r), ptr(ca), ptr(cb),
                      got.ctypes.data_as(dp))
        assert np.array_equal(got.view(np.int64), want.view(np.int64))


# ---------------------------------------------------------------------------
# Jacobian columns: rhs_jvp by symbolic forward mode
# ---------------------------------------------------------------------------


def _jvp_inputs(name, rng):
    """Random inputs of one accepted closure and ``torch.func.jvp`` of it
    with respect to the state: (x, p, t, b, r, ca, cb, v, f, jv)."""
    fn, n, n_params, ninput, (names, modes) = ACCEPTED[name]
    x, v = rng.uniform(0.2, 5.0, n), rng.uniform(-1.0, 1.0, n)
    p = rng.uniform(0.1, 3.0, n_params)
    b, r = rng.uniform(0.0, 2.0, ninput), rng.uniform(0.0, 2.0, ninput)
    t = float(rng.uniform(0.0, 24.0))
    ca = rng.uniform(20.0, 120.0, max(len(names), 1))
    cb = rng.uniform(-2.0, 2.0, max(len(names), 1))

    def cov(cname, at):
        i = names.index(cname)
        return (torch.tensor(ca[i]) if modes[i] == "const"
                else torch.tensor(ca[i]) + torch.tensor(cb[i]) * at)

    cov.value = cov

    def closure(xs):
        out = fn(xs, torch.as_tensor(p), torch.tensor(t, dtype=torch.float64),
                 torch.as_tensor(b), torch.as_tensor(r), cov)
        return out if isinstance(out, torch.Tensor) else torch.stack(list(out))

    f, jv = torch.func.jvp(closure, (torch.as_tensor(x),), (torch.as_tensor(v),))
    return x, p, t, b, r, ca, cb, v, f.numpy(), jv.numpy()


@pytest.mark.parametrize("name", list(ACCEPTED))
def test_tangents_of_the_trace_match_torch_func_jvp(name):
    """The symbolic tangents evaluated in torch (no compiler needed)."""
    from pharmsol_tpu_torch.ops.rhs_codegen import _ODE_ARGS, _sizes, _trace, evaluate, tangents

    fn, n, n_params, ninput, covs = ACCEPTED[name]
    outputs = _trace(fn, _sizes(_ODE_ARGS, n, n_params, ninput), n, covs=covs)
    jv_syms = tangents(outputs)
    rng = np.random.RandomState(5)
    for _ in range(20):
        x, p, t, b, r, ca, cb, v, f, jv = _jvp_inputs(name, rng)
        leaves = dict(x=torch.as_tensor(x), p=torch.as_tensor(p),
                      t=torch.tensor(t, dtype=torch.float64), b=torch.as_tensor(b),
                      rateiv=torch.as_tensor(r), cov_a=torch.as_tensor(ca),
                      cov_b=torch.as_tensor(cb), v=torch.as_tensor(v))
        got = evaluate(jv_syms, **leaves).numpy()
        np.testing.assert_allclose(got, jv, rtol=1e-13, atol=1e-13 * max(np.abs(jv).max(), 1.0))


def test_jacobian_flag_is_part_of_the_key_and_leaves_the_plain_header_alone():
    plain = generate_rhs(_short, 3, 5, 1)
    with_jvp = generate_rhs(_short, 3, 5, 1, jacobian=True)
    assert not plain.jacobian and with_jvp.jacobian and plain.key != with_jvp.key
    assert "rhs_jvp" not in plain.source and "PHARMSOL_RHS_HAS_JVP" not in plain.source
    assert "#define PHARMSOL_RHS_HAS_JVP 1" in with_jvp.source
    assert "void rhs_jvp(" in with_jvp.source and "const T* v, T* jv" in with_jvp.source
    # an affine RHS differentiates to a handful of operations: no state read
    body = with_jvp.source[with_jvp.source.index("void rhs_jvp("):]
    assert "x[" not in body
    for i in range(3):
        assert f"jv[{i}] = " in body
    # the plain header's rhs is the same text in both
    rhs_text = plain.source[plain.source.index("template <typename T>"):]
    assert rhs_text.strip() in with_jvp.source


@pytest.mark.parametrize("fn, reason", [
    (lambda x, p, t, b, r, cov: [-(p[0] ** x[0]) + b[0]], "exponent that depends on the state"),
    (lambda x, p, t, b, r, cov: [-(x[0] ** x[0]) + b[0]], "exponent that depends on the state"),
])
def test_an_operation_without_a_derivative_rule_raises(fn, reason):
    assert generate_rhs(fn, 1, 3, 1).source  # it traces without the Jacobian
    with pytest.raises(PharmsolError, match="no Jacobian in the CUDA kernel") as err:
        generate_rhs(fn, 1, 3, 1, jacobian=True)
    assert reason in str(err.value)


def test_every_traced_operation_has_a_rule_or_is_boolean():
    from pharmsol_tpu_torch.ops import rhs_codegen as rc

    numeric = (set(rc._ARITH) | {"pow", "min", "max", "neg", "exp", "log", "sqrt", "abs",
                                 "where", "cast", "floor", "ceil", "round", "sin", "cos",
                                 "tan", "log10", "log2"})
    assert numeric <= set(rc._JVP_RULES)
    with pytest.raises(PharmsolError, match="`sinh` has no derivative rule"):
        rc.tangents([rc.Sym("sinh", (rc.Sym("x", value=0),))])


_JVP_WRAPPER = _WRAPPER + """
extern "C" void rhs_jvp_f64(const double* x, const double* p, double t,
                            const double* b, const double* r, const double* ca,
                            const double* cb, const double* v, double* jv) {
  rhs_jvp<double>(x, p, t, b, r, ca, cb, v, jv);
}
"""


@pytest.mark.parametrize("name", list(ACCEPTED))
def test_generated_jvp_header_matches_torch_func_jvp(name, gxx, tmp_path):
    """The header with ``rhs_jvp`` compiled with g++: ``rhs`` against the
    closure and ``rhs_jvp`` against ``torch.func.jvp`` of it, 1e-14."""
    fn, n, n_params, ninput, (names, modes) = ACCEPTED[name]
    rhs = generate_rhs(fn, n, n_params, ninput, names, modes, jacobian=True)
    (tmp_path / "rhs.h").write_text(rhs.source)
    (tmp_path / "wrap.cpp").write_text(_JVP_WRAPPER)
    lib_path = tmp_path / "librhs.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(lib_path), str(tmp_path / "wrap.cpp")], check=True, cwd=tmp_path)
    lib = ctypes.CDLL(str(lib_path))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rhs_f64.argtypes = [dp, dp, ctypes.c_double, dp, dp, dp, dp, dp]
    lib.rhs_jvp_f64.argtypes = [dp, dp, ctypes.c_double, dp, dp, dp, dp, dp, dp]
    rng = np.random.RandomState(13)

    def ptr(a):
        return np.ascontiguousarray(a).ctypes.data_as(dp)

    for _ in range(50):
        x, p, t, b, r, ca, cb, v, f, jv = _jvp_inputs(name, rng)
        got_f, got_jv = np.zeros(n), np.zeros(n)
        lib.rhs_f64(ptr(x), ptr(p), t, ptr(b), ptr(r), ptr(ca), ptr(cb), got_f.ctypes.data_as(dp))
        lib.rhs_jvp_f64(ptr(x), ptr(p), t, ptr(b), ptr(r), ptr(ca), ptr(cb), ptr(v),
                        got_jv.ctypes.data_as(dp))
        np.testing.assert_allclose(got_f, f, rtol=1e-14, atol=1e-14 * max(np.abs(f).max(), 1.0))
        np.testing.assert_allclose(got_jv, jv, rtol=1e-14,
                                   atol=1e-14 * max(np.abs(jv).max(), 1.0))


# ---------------------------------------------------------------------------
# SDE drift and diffusion: one header, the same tracer and acceptance rules
# ---------------------------------------------------------------------------


def _readme_drift(x, p, t, rateiv, cov):  # examples/sde_readme.py
    return torch.stack([-x[1] * x[0], -(x[1] - p[0])])


def _two_input_drift(x, p, t, rateiv, cov):
    return [-p[0] * x[0] + rateiv[1], -p[1] * x[1],
            p[0] * x[0] + p[1] * x[1] - 0.2 * x[2] + rateiv[0]]


SDE_ACCEPTED = {
    "readme": (_readme_drift, lambda p, t, cov: [0.0, p[2]], 2, 3, 1),
    "constant_diffusion": (
        lambda x, p, t, rateiv, cov: torch.stack([-x[0] * x[1], -x[1] + p[0]]),
        lambda p, t, cov: torch.tensor([1.0, 0.01], dtype=torch.float64), 2, 1, 1),
    "two_inputs_time_diffusion": (
        _two_input_drift,
        lambda p, t, cov: [0.0, p[3] * torch.exp(-0.1 * t), torch.sqrt(p[3])], 3, 4, 2),
}


@pytest.mark.parametrize("name", list(SDE_ACCEPTED))
def test_sde_generator_accepts(name):
    drift, diffusion, n, n_params, ninput = SDE_ACCEPTED[name]
    gen = generate_sde(drift, diffusion, n, n_params, ninput)
    assert (gen.n_states, gen.n_params, gen.ninput) == (n, n_params, ninput)
    assert ("void drift(const T* x, const T* p, T t, const T* rateiv, const T* cov_a, "
            "const T* cov_b, T* dx)" in gen.source)
    assert "void diffusion(const T* p, T t, const T* cov_a, const T* cov_b, T* g)" in gen.source
    for i in range(n):
        assert f"dx[{i}] = " in gen.source and f"g[{i}] = " in gen.source
    assert generate_sde(drift, diffusion, n, n_params, ninput).key == gen.key


def test_constant_diffusion_traces_to_literals():
    drift, diffusion, n, n_params, ninput = SDE_ACCEPTED["constant_diffusion"]
    src = generate_sde(drift, diffusion, n, n_params, ninput).source
    assert "g[0] = T(1.0);" in src and "g[1] = T(0.01);" in src


def test_sde_generator_reads_covariates():
    """The drift and the diffusion read covariates as the ODE RHS does:
    ``cov_a[i]`` for a constant one, ``cov_a[i] + cov_b[i] * t`` for an
    affine one (kernel K3b); a read of a covariate not given is refused."""
    drift = (lambda x, p, t, r, cov: torch.stack(
        [-p[0] * x[0], p[0] * x[0] - p[1] * (cov("crcl", t) / 75.0) ** 0.75
         * (cov("age", t) / 25.0) ** 0.5 * x[1]]))
    diffusion = (lambda p, t, cov: [0.0, p[2] * cov("age", t) / 25.0])
    gen = generate_sde(drift, diffusion, 2, 3, 1, ("crcl", "age"), ("affine", "const"))
    assert (gen.cov_names, gen.cov_modes) == (("crcl", "age"), ("affine", "const"))
    assert "cov_b[0]" in gen.source and "cov_a[1]" in gen.source
    assert "cov_b[1]" not in gen.source
    assert "#define PHARMSOL_RHS_NCOV 2" in gen.source
    with pytest.raises(PharmsolError, match="unknown covariate `age`"):
        generate_sde(drift, diffusion, 2, 3, 1, ("crcl",), ("affine",))


@pytest.mark.parametrize("which, fn, reason", [
    ("drift", lambda x, p, t, r, cov: torch.stack([-p[0] * torch.tanh(x[0]), -x[1]]), "`tanh`"),
    ("drift", lambda x, p, t, r, cov: [-p[0] * x[0]], "returns 1 components, expected 2"),
    ("diffusion", lambda p, t, cov: [0.0, p[0] if p[0] > 0 else 0.0],
     "branches on a traced value"),
    ("diffusion", lambda p, t, cov: [0.0, p[0] * cov("wt", t)],
     "reads unknown covariate `wt`"),
])
def test_sde_generator_rejects_with_a_reason(which, fn, reason):
    drift = fn if which == "drift" else _readme_drift
    diffusion = fn if which == "diffusion" else (lambda p, t, cov: [0.0, p[2]])
    with pytest.raises(PharmsolError, match=f"SDE {which} cannot run in the CUDA kernel"):
        generate_sde(drift, diffusion, 2, 3, 1)
    with pytest.raises(PharmsolError, match=reason):
        generate_sde(drift, diffusion, 2, 3, 1)


# diffusion -> (states, parameters, inputs, covariates, the components that
# trace to a literal zero): only a literal 0 is quiet; a component that reads
# a parameter or a covariate may be zero only at run time and stays noisy
_NOISE_MASKS = {
    "readme": (lambda p, t, cov: [0.0, p[2]], 2, 3, 1, (), {0}),
    "two_inputs": (lambda p, t, cov: [0.0, p[3], 0.5 * p[3]], 3, 4, 2, (), {0}),
    "every_component": (lambda p, t, cov: [p[1], p[2]], 2, 3, 1, (), set()),
    "parameter_times_zero": (lambda p, t, cov: [0.0 * p[2], p[2]], 2, 3, 1, (), set()),
    "covariate": (lambda p, t, cov: [cov("flag", t), p[2]], 2, 3, 1, ("flag",), set()),
    "constants": (lambda p, t, cov: [1.0, 0.01], 2, 3, 1, (), set()),
    "all_zero": (lambda p, t, cov: torch.zeros(2, dtype=torch.float64), 2, 3, 1, (), {0, 1}),
}


def _noise_mask_case(name):
    diffusion, n, n_params, ninput, covs, quiet = _NOISE_MASKS[name]
    drift = _two_input_drift if n == 3 else _readme_drift
    return generate_sde(drift, diffusion, n, n_params, ninput, covs), n, quiet


@pytest.mark.parametrize("name", list(_NOISE_MASKS))
def test_generate_sde_marks_literal_zero_diffusion(name):
    gen, _, quiet = _noise_mask_case(name)
    assert gen.zero_diffusion == frozenset(quiet)


@pytest.mark.parametrize("name", list(_NOISE_MASKS))
def test_generated_header_carries_the_noise_mask(name):
    gen, n, quiet = _noise_mask_case(name)
    flags = ", ".join("false" if i in quiet else "true" for i in range(n))
    assert f"#define PHARMSOL_SDE_NOISY {{{flags}}}\n" in gen.source


_SDE_WRAPPER = """
#define __device__
#define __forceinline__ inline
#include "sde.h"
extern "C" void drift_f64(const double* x, const double* p, double t,
                          const double* r, double* dx) {
  drift<double>(x, p, t, r, nullptr, nullptr, dx);
}
extern "C" void diffusion_f64(const double* p, double t, double* g) {
  diffusion<double>(p, t, nullptr, nullptr, g);
}
"""


@pytest.mark.parametrize("name", list(SDE_ACCEPTED))
def test_generated_sde_header_matches_the_closures(name, gxx, tmp_path):
    drift, diffusion, n, n_params, ninput = SDE_ACCEPTED[name]
    gen = generate_sde(drift, diffusion, n, n_params, ninput)
    (tmp_path / "sde.h").write_text(gen.source)
    (tmp_path / "wrap.cpp").write_text(_SDE_WRAPPER)
    lib_path = tmp_path / "libsde.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(lib_path), str(tmp_path / "wrap.cpp")], check=True,
                   cwd=tmp_path)
    lib = ctypes.CDLL(str(lib_path))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.drift_f64.argtypes = [dp, dp, ctypes.c_double, dp, dp]
    lib.diffusion_f64.argtypes = [dp, ctypes.c_double, dp]
    rng = np.random.RandomState(13)

    def ptr(a):
        return np.ascontiguousarray(a).ctypes.data_as(dp)

    def as_np(v):
        if not isinstance(v, torch.Tensor):
            v = torch.stack([torch.as_tensor(c, dtype=torch.float64) for c in v])
        return v.double().numpy()

    for _ in range(50):
        x = rng.uniform(0.0, 5.0, n)
        p = rng.uniform(0.1, 3.0, n_params)
        r = rng.uniform(0.0, 2.0, ninput)
        t = float(rng.uniform(0.0, 24.0))
        tt = torch.tensor(t, dtype=torch.float64)
        want_d = as_np(drift(torch.as_tensor(x), torch.as_tensor(p), tt, torch.as_tensor(r), None))
        want_g = as_np(diffusion(torch.as_tensor(p), tt, None))
        got_d, got_g = np.zeros(n), np.zeros(n)
        lib.drift_f64(ptr(x), ptr(p), t, ptr(r), got_d.ctypes.data_as(dp))
        lib.diffusion_f64(ptr(p), t, got_g.ctypes.data_as(dp))
        for got, want in ((got_d, want_d), (got_g, want_g)):
            scale = max(np.abs(want).max(), 1.0)
            np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14 * scale)
