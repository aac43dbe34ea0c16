"""The explicit tier of ``csrc/fused_ode.cu`` (K2a, K2e) built as host C++
and held against the plain twin on the CPU (float64).

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``), but its
source is plain C++ around the generated right-hand side: with the CUDA
qualifiers defined away by the shim ``cuda_runtime.h`` of
``tests/test_torch_implicit_host.py`` and the persistent grid's launch
replaced by a loop over its blocks and threads, g++ builds the same lane
loop (march calls, lag passes, merged captures, the covariate-only terms of
``rhs_pre``, cell refill) into a library that ``ops/fused_ode.py::_launch``
calls with CPU tensors. The host build's blocks are one warp wide, so that a
grid of one block (32 lanes) is smaller than every case's cells and each
lane marches several cells one after the other. Built with
``-ffp-contract=off``: every multiply and add rounds on its own, as in the
twin. Skipped where there is no g++.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
from pharmsol_tpu_torch.ops import _build, fused_ode
from pharmsol_tpu_torch.utils.f32_budget import (
    ODE_CASES, ODE_FEATURE_CASES, covariate_model_case, ode_case, ode_feature_case,
)

from test_torch_implicit_host import SHIM

_LAUNCH = re.compile(r"(fused_ode_explicit_kernel<T, SOLVER, FEAT>)"
                     r"<<<blocks, EXPLICIT_THREADS, 0, stream>>>\(a\);")
_LOOP = (r"{ gridDim = dim3(blocks); blockDim = dim3(EXPLICIT_THREADS);"
         r" for (unsigned b_ = 0; b_ < (unsigned)blocks; ++b_)"
         r" for (unsigned t_ = 0; t_ < (unsigned)EXPLICIT_THREADS; ++t_)"
         r" { blockIdx = dim3(b_); threadIdx = dim3(t_); \1(a); } }")
_FEATURES = ("cov_streams", "cov_names", "init_rows", "init_planes", "init_mask", "lag_plane",
             "fa_plane", "lag_slots", "fa_slots")
# the explicit tier's cases of the budget table (the others are K2d's and K2c's)
_BUDGET_CASES = [n for n in ODE_CASES if n not in ("ode_expm", "ode_bdf")]


@pytest.fixture(scope="module")
def host_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("explicit_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    src = (_build.CSRC_DIR / "fused_ode.cu").read_text()
    host, n = _LAUNCH.subn(_LOOP, src)
    assert n == 1, "the explicit tier's launch was not found"
    host, n = re.subn(r"constexpr int EXPLICIT_THREADS = \d+;",
                      "constexpr int EXPLICIT_THREADS = 32;", host)
    assert n == 1, "the explicit tier's block was not found"
    (d / "fused_ode_host.cpp").write_text(host)
    return d


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_LIBS = {}


def _host_library(d, gen):
    header = d / f"rhs_{gen.key}.cuh"
    header.write_text(gen.source)
    out = d / f"lib_{gen.key}.so"
    if str(out) not in _LIBS:
        subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off", "-w",
                        f"-I{d}", f'-DPHARMSOL_ODE_RHS="{header.name}"', "-o", str(out),
                        str(d / "fused_ode_host.cpp")], check=True)
        lib = ctypes.CDLL(str(out))
        for name, (argtypes, restype) in _build.ODE.functions.items():
            if name == "jvp_probe":
                continue
            fn = getattr(lib, f"fused_ode_{name}")
            fn.argtypes, fn.restype = argtypes, restype
        _LIBS[str(out)] = lib
    return _LIBS[str(out)]


def _plan(model, data, sp, ems):
    return _FusedOdePsiPlan(model, model.lower(data.subjects()), sp,
                            ems.lower(model.resolve_output_label, model.nouteqs()),
                            torch.device("cpu"), torch.float64)


def _host_psi(d, plan, merge, blocks=1, **over):
    """The host build's psi through the wrapper's own packing (``_launch``);
    ``blocks`` of one warp each (0: the shim's card, 3 SMs x 2 blocks);
    ``over``: kernel arguments that replace the plan's."""
    kw = dict(plan.kernel_kwargs(merge), **over)
    feat = {k: kw.pop(k) for k in _FEATURES if k in kw}
    feat["cov_names"] = tuple(feat.get("cov_names", ()))
    kw["bolus_inputs"] = tuple(kw.get("bolus_inputs", (0,)))
    kw["rate_inputs"] = tuple(kw.get("rate_inputs", (0,)))
    args = (*plan.streams, plan.support, plan.rhs)
    n_out, runs, ft = fused_ode._check_inputs(
        *args, kw.get("obs_outeq"), kw.get("out_coef"), kw.get("out_bias"), kw["bolus_inputs"],
        kw["rate_inputs"], kw.get("merge_runs"), kw["solver"], **feat)
    lib = _host_library(d, plan.rhs)
    out, err = fused_ode._launch(lib, 0, args, kw, n_out, runs, ft, blocks)
    assert err == 0
    return out


def _case(name):
    if name in _BUDGET_CASES:
        return ode_case(name)
    if name == "covariate_model":
        return covariate_model_case(9, 20, seed=4)
    return ode_feature_case(name, 7, 20, seed=3)


@pytest.mark.parametrize("name", _BUDGET_CASES + list(ODE_FEATURE_CASES) + ["covariate_model"])
def test_host_build_matches_the_twin(host_dir, name):
    """The kernel's source, built for the host, against the unchanged twin,
    merged and segment by segment where the plan merges: every cell within
    1e-8 relative (the captures interpolate the state, the twin the output:
    they round apart). One block of 32 lanes: every lane marches several
    cells, captures and lag passes."""
    plan = _plan(*_case(name))
    R, S = plan.streams[0].shape[0], plan.support.shape[0]
    assert R * S > 2 * 32
    for merge in ((True, False) if plan.merge_runs is not None else (False,)):
        got = _host_psi(host_dir, plan, merge)
        want = fused_ode.psi_ode_plain(*plan.streams, plan.support, plan.rhs,
                                       **plan.kernel_kwargs(merge))
        assert torch.isfinite(want).all()
        assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) <= 1e-8


@pytest.mark.parametrize("name", ["ode_dopri5", "lag_fa", "two_inputs_lag", "covariate_model"])
def test_host_build_psi_does_not_depend_on_the_grid(host_dir, name):
    """One block (32 lanes, each marching several cells), three blocks, and
    the shim's full grid: the same psi bit for bit."""
    plan = _plan(*_case(name))
    merge = plan.merge_runs is not None
    runs = [_host_psi(host_dir, plan, merge, b) for b in (1, 3, 0)]
    bits = [r.view(torch.int64) for r in runs]
    assert torch.equal(bits[0], bits[1]) and torch.equal(bits[0], bits[2])


def test_host_build_takes_the_covariate_only_terms(host_dir):
    """The reference's covariate model: its header splits rhs (one
    covariate-only term, the creatinine and age factor), and the host build,
    which computes it once per run where creatinine has no slope, matches the
    twin, lost cells and all: with a budget of 20 trials a march call, a
    support whose absorption rate is 200 runs out of trials in its first call
    and its cells are -inf in both."""
    model, data, sp, ems = covariate_model_case(6, 40, seed=8)
    sp[3, 0] = 200.0
    plan = _plan(model, data, sp, ems)
    assert plan.rhs.n_pre == 1 and "#define PHARMSOL_RHS_NPRE 1" in plan.rhs.source
    got = _host_psi(host_dir, plan, False, max_steps=20)
    want = fused_ode.psi_ode_plain(*plan.streams, plan.support, plan.rhs,
                                   **dict(plan.kernel_kwargs(False), max_steps=20))
    lost = ~torch.isfinite(want)
    assert bool(lost[:, 3].all()) and not bool(lost.all())
    assert torch.equal(~torch.isfinite(got), lost)
    rel = ((got - want).abs() / want.abs().clamp(min=1.0))[~lost]
    assert float(rel.max()) <= 1e-8
