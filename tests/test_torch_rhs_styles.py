"""The closure styles and the elementwise set of the CUDA RHS generator.

On the CPU, float64, no card:

- vector-style spellings (``torch.zeros_like``, writes with static indices,
  whole-vector arithmetic) of the ODE Short, TMDD and transit right-hand
  sides trace to headers byte-equal to their list-style spellings', with and
  without ``rhs_jvp``, and record the ``"stacked"`` style; the list-style
  ones keep ``"lanes"``;
- every operation of the elementwise set and ``**`` with a state-dependent
  exponent: the emitted C++, compiled with g++ as
  ``test_torch_rhs_codegen.py``'s headers are, equals the closure within
  1e-14 and its ``rhs_jvp`` equals ``torch.func.jvp`` of the closure within
  1e-12; the symbolic tangents evaluated in torch too;
- the value vectors' operations (``torch.cat``, ``sum``, ``ones_like``,
  ``full_like``, ``torch.zeros(n)`` out of place, constant tensors, slice
  assignment, the twin's ``vmap`` call) and what stays refused: a Python
  ``if`` on a traced value, data-dependent indexing, vectors of different
  lengths, writes into the closure's arguments or into ``torch.zeros(n)``,
  an unknown operation, and a vector-style SDE drift;
- the sensitivity tower (``engine/sens.py``) takes the symbolic route for
  the math model and a vector-style model, equal to the ``torch.func.jvp``
  route within ``test_torch_sens.py``'s 1e-8.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.ops.fused_ode import call_rhs
from pharmsol_tpu_torch.ops.rhs_codegen import (
    _ODE_ARGS, _sizes, _trace, evaluate, generate_rhs, generate_sde, tangents,
)
from pharmsol_tpu_torch.utils import style_cases as sc


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


# name -> (states, parameters)
SIZES = {"short": (3, 5), "tmdd": (3, 7), "transit": (5, 7)}


@pytest.mark.parametrize("jacobian", [False, True])
@pytest.mark.parametrize("name", list(sc.VECTOR_SPELLINGS))
def test_vector_style_spelling_has_the_list_style_header(name, jacobian):
    vector, listed = sc.VECTOR_SPELLINGS[name]
    n, n_params = SIZES[name]
    want = generate_rhs(listed(torch.stack), n, n_params, 1, jacobian=jacobian)
    got = generate_rhs(vector, n, n_params, 1, jacobian=jacobian)
    assert (want.style, got.style) == ("lanes", "stacked")
    assert got.source.encode() == want.source.encode() and got.key == want.key


# ---------------------------------------------------------------------------
# The elementwise set: one closure, one operation per state
# ---------------------------------------------------------------------------

# op -> (closure of a = x[i], b = x[i + 1] and p, range of the inputs it reads)
OPS = {
    "tanh": (lambda a, b, p: torch.tanh(a), (-3.0, 3.0)),
    "sinh": (lambda a, b, p: torch.sinh(a), (-3.0, 3.0)),
    "cosh": (lambda a, b, p: torch.cosh(a), (-3.0, 3.0)),
    "asin": (lambda a, b, p: torch.asin(a), (-0.95, 0.95)),
    "acos": (lambda a, b, p: torch.arccos(a), (-0.95, 0.95)),
    "atan": (lambda a, b, p: torch.atan(a), (-5.0, 5.0)),
    "sigmoid": (lambda a, b, p: torch.sigmoid(a), (-6.0, 6.0)),
    "log1p": (lambda a, b, p: torch.log1p(a), (-0.9, 5.0)),
    "expm1": (lambda a, b, p: torch.special.expm1(a), (-3.0, 3.0)),
    "erf": (lambda a, b, p: torch.erf(a), (-3.0, 3.0)),
    "erfc": (lambda a, b, p: torch.special.erfc(a), (-3.0, 3.0)),
    "square": (lambda a, b, p: torch.square(a), (-3.0, 3.0)),
    "rsqrt": (lambda a, b, p: torch.rsqrt(a), (0.1, 5.0)),
    "reciprocal": (lambda a, b, p: torch.reciprocal(a), (0.2, 5.0)),
    "sign": (lambda a, b, p: torch.sign(a), (-2.0, 2.0)),
    "atan2": (lambda a, b, p: torch.atan2(a, b), (-2.0, 2.0)),
    # ** with an exponent that depends on the state: a parameter's power, and
    # a state's power of a state
    "pow_state_exponent": (lambda a, b, p: p[0] ** a, (-2.0, 2.0)),
    "pow_state_both": (lambda a, b, p: a ** b, (0.2, 3.0)),
}
BINARY = ("atan2", "pow_state_both")


def _layout():
    """State index of each op's first input, and the states' ranges."""
    at, ranges = {}, []
    for name, (_, rng) in OPS.items():
        at[name] = len(ranges)
        ranges += [rng] * (2 if name in BINARY else 1)
    return at, ranges


AT, RANGES = _layout()
N = len(RANGES)
F64 = torch.float64


def _elementwise(x, p, t, b, rateiv, cov):
    out = [fn(x[AT[name]], x[AT[name] + 1] if name in BINARY else None, p)
           for name, (fn, _) in OPS.items()]
    # the binaries' second inputs: states of their own
    return out + [x[i] for i in range(len(out), N)]


def _inputs(rng):
    x = np.array([rng.uniform(lo, hi) for lo, hi in RANGES])
    return x, rng.uniform(0.5, 3.0, 1)


def _closure_jvp(x, p, v):
    def closure(xs):
        return torch.stack(list(_elementwise(xs, torch.as_tensor(p), torch.tensor(0.0, dtype=F64),
                                             None, None, None)))
    f, jv = torch.func.jvp(closure, (torch.as_tensor(x),), (torch.as_tensor(v),))
    return f.numpy(), jv.numpy()


def test_every_operation_traces_with_a_rule_and_records_lanes():
    rhs = generate_rhs(_elementwise, N, 1, 1, jacobian=True)
    assert rhs.style == "lanes" and rhs.jacobian
    for op in OPS:
        if op.startswith("pow"):
            continue
        assert f"pm_{op}(" in rhs.source, op
    assert "pm_pow(" in rhs.source


def test_symbolic_tangents_match_torch_func_jvp():
    outputs = _trace(_elementwise, _sizes(_ODE_ARGS, N, 1, 1), N)
    jv_syms = tangents(outputs)
    rng = np.random.RandomState(3)
    for _ in range(20):
        x, p = _inputs(rng)
        v = rng.uniform(-1.0, 1.0, N)
        f, jv = _closure_jvp(x, p, v)
        leaves = dict(x=torch.as_tensor(x), p=torch.as_tensor(p), t=torch.tensor(0.0, dtype=F64),
                      b=torch.zeros(1, dtype=F64), rateiv=torch.zeros(1, dtype=F64),
                      v=torch.as_tensor(v))
        np.testing.assert_allclose(evaluate(outputs, **leaves).numpy(), f, rtol=1e-14,
                                   atol=1e-14)
        np.testing.assert_allclose(evaluate(jv_syms, **leaves).numpy(), jv, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(jv).max(), 1.0))


_WRAPPER = """
#define __device__
#define __forceinline__ inline
#include "rhs.h"
extern "C" void rhs_f64(const double* x, const double* p, double t,
                        const double* b, const double* r, const double* ca,
                        const double* cb, double* dx) {
  rhs<double>(x, p, t, b, r, ca, cb, dx);
}
extern "C" void rhs_jvp_f64(const double* x, const double* p, double t,
                            const double* b, const double* r, const double* ca,
                            const double* cb, const double* v, double* jv) {
  rhs_jvp<double>(x, p, t, b, r, ca, cb, v, jv);
}
"""


def test_generated_header_matches_the_closure(tmp_path):
    """rhs within 1e-14 of the closure, rhs_jvp within 1e-12 of
    ``torch.func.jvp`` of it, on 200 random lanes and at sign's zeros."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host compile of the generated header is skipped")
    rhs = generate_rhs(_elementwise, N, 1, 1, jacobian=True)
    (tmp_path / "rhs.h").write_text(rhs.source)
    (tmp_path / "wrap.cpp").write_text(_WRAPPER)
    lib_path = tmp_path / "librhs.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(lib_path),
                    str(tmp_path / "wrap.cpp")], check=True, cwd=tmp_path)
    lib = ctypes.CDLL(str(lib_path))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rhs_f64.argtypes = [dp, dp, ctypes.c_double, dp, dp, dp, dp, dp]
    lib.rhs_jvp_f64.argtypes = [dp, dp, ctypes.c_double, dp, dp, dp, dp, dp, dp]
    rng = np.random.RandomState(11)
    zeros = np.zeros(1)
    samples = [_inputs(rng) for _ in range(200)]
    for signed_zero in (0.0, -0.0):
        x, p = _inputs(rng)
        x[AT["sign"]] = signed_zero
        samples.append((x, p))
    for x, p in samples:
        v = rng.uniform(-1.0, 1.0, N)
        want_f, want_jv = _closure_jvp(x, p, v)
        got_f, got_jv = np.zeros(N), np.zeros(N)
        args = [np.ascontiguousarray(a).ctypes.data_as(dp) for a in (x, p)]
        rest = [zeros.ctypes.data_as(dp)] * 4
        lib.rhs_f64(*args, 0.0, *rest, got_f.ctypes.data_as(dp))
        lib.rhs_jvp_f64(*args, 0.0, *rest, np.ascontiguousarray(v).ctypes.data_as(dp),
                        got_jv.ctypes.data_as(dp))
        np.testing.assert_allclose(got_f, want_f, rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(got_jv, want_jv, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(want_jv).max(), 1.0))


def test_state_exponent_jacobian_is_nan_where_the_log_of_the_base_is():
    """``d(a^u)/du = a^u ln a``, ln taken at 1 where the base is 0 (JAX's
    rule: 0 there), NaN for a negative base (JAX's too)."""
    rhs_fn = lambda x, p, t, b, r, cov: [x[1] ** x[0], -x[1]]  # noqa: E731
    outputs = _trace(rhs_fn, _sizes(_ODE_ARGS, 2, 1, 1), 2)
    jv = tangents(outputs)
    for base, want in ((0.0, 0.0), (-2.0, float("nan"))):
        leaves = dict(x=torch.tensor([1.5, base], dtype=F64), p=torch.ones(1, dtype=F64),
                      t=torch.tensor(0.0, dtype=F64), b=torch.zeros(1, dtype=F64),
                      rateiv=torch.zeros(1, dtype=F64), v=torch.tensor([1.0, 0.0], dtype=F64))
        got = float(evaluate(jv, **leaves)[0])
        assert (np.isnan(got) and np.isnan(want)) or got == want


# ---------------------------------------------------------------------------
# Value vectors
# ---------------------------------------------------------------------------


def _vector_ops(x, p, t, b, rateiv, cov):
    k = torch.cat([p[0:1], torch.ones(1, dtype=x.dtype), torch.tensor([0.5])])
    dx = torch.full_like(x, 2.0) * 0.0
    dx[0:2] = -k[0:2] * x[0:2]
    dx[2] -= torch.sum(x) * 0.01 + torch.zeros(3)[1]
    dx = dx + torch.tensor([0.0, 1.0, 0.0], dtype=F64) * p[0] * x[0] + torch.ones_like(x) * 0.0
    dx[0] += b[0]
    dx[1] = dx[1] + rateiv[0] + x[1:].sum(dim=0) * k[2] * 0.0
    return dx


def test_value_vectors_trace_and_match_the_closure_under_vmap():
    rhs = generate_rhs(_vector_ops, 3, 2, 1)
    assert rhs.style == "stacked"
    # the twin's call (vmap over lanes) against the closure lane by lane
    g = torch.Generator().manual_seed(0)
    shape = (4, 5)
    xs = [torch.rand(shape, generator=g, dtype=torch.float64) for _ in range(3)]
    ps = [torch.rand((1, 5), generator=g, dtype=torch.float64) for _ in range(2)]
    t = torch.rand(shape, generator=g, dtype=torch.float64)
    b = [torch.rand(shape, generator=g, dtype=torch.float64)]
    r = [torch.rand(shape, generator=g, dtype=torch.float64)]
    got = torch.stack(call_rhs(rhs, xs, ps, t, b, r, None, shape, torch.float64, "cpu"))
    for i in range(4):
        for j in range(5):
            want = _vector_ops(torch.stack([v[i, j] for v in xs]),
                               torch.stack([v[0, j] for v in ps]), t[i, j],
                               b[0][i, j].reshape(1), r[0][i, j].reshape(1), None)
            torch.testing.assert_close(got[:, i, j], want, rtol=1e-15, atol=1e-15)


def _if_on_state(x, p, t, b, rateiv, cov):
    dx = torch.zeros_like(x)
    if x[0] > 1.0:
        dx[0] = -p[0] * x[0]
    return dx


def _masked(x, p, t, b, rateiv, cov):
    dx = torch.zeros_like(x)
    dx[x > 1.0] = -p[0]
    return dx


def _length_mismatch(x, p, t, b, rateiv, cov):
    return -p[0] * x + torch.stack([b[0], b[0], b[0]])


def _slice_mismatch(x, p, t, b, rateiv, cov):
    dx = torch.zeros_like(x)
    dx[0:2] = torch.stack([-p[0] * x[0]] * 3)
    return dx


def _writes_its_argument(x, p, t, b, rateiv, cov):
    x[0] = x[0] + b[0]
    return -p[0] * x


def _writes_into_zeros(x, p, t, b, rateiv, cov):
    dx = torch.zeros(2)
    dx[0] = -p[0] * x[0] + b[0]
    return dx


def _unknown(x, p, t, b, rateiv, cov):
    return [-p[0] * torch.lgamma(x[0] + 2.0) + b[0], -x[1]]


@pytest.mark.parametrize("fn, reason", [
    (_if_on_state, "branches on a traced value"),
    (_masked, "no data-dependent indexing"),
    (_length_mismatch, r"combines vectors of lengths \[2, 3\]"),
    (_slice_mismatch, "vectors of different lengths"),
    (_writes_its_argument, "writes in place into its argument x"),
    (_writes_into_zeros, "in place into a tensor that no argument"),
    (_unknown, "`lgamma`, which the CUDA generator does not support"),
])
def test_refusals_stay(fn, reason):
    with pytest.raises(PharmsolError, match=reason):
        generate_rhs(fn, 2, 2, 1)


@pytest.mark.parametrize("drift", [
    lambda x, p, t, r, cov: -p[0] * x,
    lambda x, p, t, r, cov: torch.zeros_like(x) + torch.stack([-x[0], -x[1]]),
])
def test_vector_style_sde_drift_is_refused_and_the_elementwise_set_taken(drift):
    diffusion = lambda p, t, cov: [0.0, p[1]]  # noqa: E731
    with pytest.raises(PharmsolError, match="SDE drift cannot run in the CUDA kernel.*"
                                            "vector-style code"):
        generate_sde(drift, diffusion, 2, 2, 1)
    gen = generate_sde(lambda x, p, t, r, cov: [-p[0] * torch.tanh(x[0]),
                                                -torch.log1p(x[1])], diffusion, 2, 2, 1)
    assert "pm_tanh(" in gen.source and "pm_log1p(" in gen.source


# ---------------------------------------------------------------------------
# The sensitivity tower takes the symbolic route
# ---------------------------------------------------------------------------


def _tower_jacobian(model, data, P, symbolic, monkeypatch):
    """The prediction Jacobian (forward mode), the gradient of the first
    observation and its gradient again (reverse mode) through the tower:
    on the traced graph (``symbolic``) or by ``torch.func.jvp`` of the
    closure."""
    from pharmsol_tpu_torch.engine import sens
    from pharmsol_tpu_torch.likelihood.matrix import _device_rows

    model.__dict__.pop("_sens_aug_eq", None)
    with monkeypatch.context() as m:
        if not symbolic:
            m.setattr(sens, "_traced_rhs", lambda eq, n_params: None)
        grid = model.lower(data.subjects())
        rows = _device_rows(grid, torch.device("cpu"), F64)
        pred = sens.make_sens_pred(model, rows, grid.cov_names)
        aug = sens.augmented_equation(model, P.shape[1])
        assert bool(getattr(aug._diffeq, "lanes", False)) == symbolic
        J = torch.func.jacfwd(pred)(torch.tensor(P))
        xg = torch.tensor(P, requires_grad=True)
        (g,) = torch.autograd.grad(pred(xg)[:, 0].sum(), xg, create_graph=True)
        (h,) = torch.autograd.grad(g[:, 0].sum(), xg)
    return J.numpy(), g.detach().numpy(), h.numpy()


@pytest.mark.parametrize("which", ["math", "vector"])
def test_sensitivity_tower_takes_the_symbolic_route(which, monkeypatch):
    if which == "math":
        model, data, sp, _ = sc.math_case(1, 1, seed=4, features=False, times=(0.5, 1.5))
        P = sp
    else:
        model = pt.ODE(sc.short_vector, out=lambda x, p, t, cov: x[1:2] / p[4],
                       nstates=3, ndrugs=1, nout=1)
        data = pt.Data([pt.Subject.builder(f"v{i}").bolus(0.0, 100.0, 0)
                        .infusion(1.0, 30.0, 0, 2.0).observation(0.5, 3.0, 0)
                        .observation(4.0, 2.0, 0).build() for i in range(2)])
        P = np.array([[0.15, 1.2, 0.3, 0.2, 10.0], [0.2, 0.9, 0.25, 0.3, 12.0]])
    sym = _tower_jacobian(model, data, P, True, monkeypatch)
    ref = _tower_jacobian(model, data, P, False, monkeypatch)
    for got, want in zip(sym, ref):
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-14 * np.abs(want).max())
