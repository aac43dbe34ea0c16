"""The implicit tiers of ``csrc/fused_ode.cu`` (K2b, K2c) built as host C++
and held against the plain twin on the CPU (float64).

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``), but its
source is plain C++ around the generated right-hand side: with the CUDA
qualifiers defined away by a small ``cuda_runtime.h`` and the persistent
grid's launch replaced by a loop over its blocks and threads, g++ builds the
same lane loop (march calls, lag passes, merged captures, cell refill) into a
library that ``ops/fused_ode.py::_launch`` calls with CPU tensors. Built with
``-ffp-contract=off``, as the card's library is with ``-fmad=false``. Skipped
where there is no g++.
"""

import ctypes
import hashlib
import re
import shutil
import subprocess

import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
from pharmsol_tpu_torch.ops import _build, fused_ode
from pharmsol_tpu_torch.utils.f32_budget import STIFF_CASES, stiff_case

SHIM = """#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <math.h>
using std::isfinite;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__ static const
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
       cudaErrorNotSupported = 801 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host build"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// a card of 3 SMs holding 2 blocks each: 768 lanes
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 3; return 0; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, F, int, size_t) {
  *b = 2;
  return 0;
}
// one thread at a time: a warp vote is the thread's own
inline bool __all_sync(unsigned, bool p) { return p; }
inline float erfcxf(float x) { return std::exp(x * x) * std::erfc(x); }
inline double erfcx(double x) { return std::exp(x * x) * std::erfc(x); }
"""
_LAUNCH = re.compile(r"(fused_ode_implicit_kernel<T, SOLVER, FEAT, CAP>)"
                     r"<<<blocks, IMPLICIT_THREADS, 0, stream>>>\(a\);")
_LOOP = (r"{ gridDim = dim3(blocks); blockDim = dim3(IMPLICIT_THREADS);"
         r" for (unsigned b_ = 0; b_ < (unsigned)blocks; ++b_)"
         r" for (unsigned t_ = 0; t_ < (unsigned)IMPLICIT_THREADS; ++t_)"
         r" { blockIdx = dim3(b_); threadIdx = dim3(t_); \1(a); } }")
_FEATURES = ("cov_streams", "cov_names", "init_rows", "init_planes", "init_mask", "lag_plane",
             "fa_plane", "lag_slots", "fa_slots")


@pytest.fixture(scope="module")
def host_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("implicit_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    src = (_build.CSRC_DIR / "fused_ode.cu").read_text()
    host, n = _LAUNCH.subn(_LOOP, src)
    assert n == 1, "the persistent grid's launch was not found"
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


def _host_library(d, gen, solver):
    code = _build._ODE_STIFF_CODES[solver]
    header = d / f"rhs_{gen.key}.cuh"
    header.write_text(gen.source)
    out = d / f"lib_{gen.key}_{code}.so"
    if str(out) not in _LIBS:
        subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off", "-w",
                        f"-I{d}", f"-DPHARMSOL_ODE_SOLVER={code}",
                        f'-DPHARMSOL_ODE_RHS="{header.name}"', "-o", str(out),
                        str(d / "fused_ode_host.cpp")], check=True)
        lib = ctypes.CDLL(str(out))
        for name, (argtypes, restype) in _build.ODE.functions.items():
            if name == "jvp_probe":
                continue
            fn = getattr(lib, f"fused_ode_{name}")
            fn.argtypes, fn.restype = argtypes, restype
        _LIBS[str(out)] = lib
    return _LIBS[str(out)]


def _plan(name, solver, R, S, seed):
    model, data, sp, ems = stiff_case(name, R, S, seed=seed, solver=solver)
    return _FusedOdePsiPlan(model, model.lower(data.subjects()), sp,
                            ems.lower(model.resolve_output_label, model.nouteqs()),
                            torch.device("cpu"), torch.float64)


def _host_psi(d, plan, merge, blocks=0):
    """The host build's psi through the wrapper's own packing (``_launch``)."""
    kw = plan.kernel_kwargs(merge)
    feat = {k: kw.pop(k) for k in _FEATURES if k in kw}
    feat["cov_names"] = tuple(feat.get("cov_names", ()))
    kw["bolus_inputs"] = tuple(kw.get("bolus_inputs", (0,)))
    kw["rate_inputs"] = tuple(kw.get("rate_inputs", (0,)))
    args = (*plan.streams, plan.support, plan.rhs)
    n_out, runs, ft = fused_ode._check_inputs(
        *args, kw.get("obs_outeq"), kw.get("out_coef"), kw.get("out_bias"), kw["bolus_inputs"],
        kw["rate_inputs"], kw.get("merge_runs"), kw["solver"], **feat)
    lib = _host_library(d, plan.rhs, kw["solver"])
    out, err = fused_ode._launch(lib, 0, args, kw, n_out, runs, ft, blocks)
    assert err == 0
    return out


# the TMDD under bdf and trbdf2 (merged and per segment), every other case of
# STIFF_CASES under one implicit solver in turn
_CASES = [("tmdd", "bdf"), ("tmdd", "trbdf2")] + [
    (name, ("kvaerno5", "kvaerno3", "bdf", "trbdf2")[i % 4])
    for i, name in enumerate(n for n in STIFF_CASES if n != "tmdd")]


@pytest.mark.parametrize("name, solver", _CASES)
def test_host_build_matches_the_twin(host_dir, name, solver):
    """The kernel's source, built for the host, against the unchanged twin by
    the kernel-twin rule: the same lost cells; every other cell within 1e-8
    relative, on the TMDD and the poison case within 1e-6 and 99% within
    1e-8 (the twin's Jacobian is ``torch.func.jvp`` of the closure, the
    kernel's the generated ``rhs_jvp``: a step decision at a rounding tie may
    flip). 5 subjects x 64 supports: the 768 lanes of the shim's grid march
    one cell each."""
    plan = _plan(name, solver, 5, 64, seed=40 + list(STIFF_CASES).index(name))
    for merge in ((True, False) if plan.merge_runs is not None else (False,)):
        got = _host_psi(host_dir, plan, merge)
        want = fused_ode.psi_ode_plain(*plan.streams, plan.support, plan.rhs,
                                       **plan.kernel_kwargs(merge))
        lost = ~torch.isfinite(want)
        assert torch.equal(~torch.isfinite(got), lost)
        assert bool(lost.any()) == (name == "poison")
        rel = ((got - want).abs() / want.abs().clamp(min=1.0))[~lost]
        if name in ("tmdd", "poison"):
            assert float(rel.max()) <= 1e-6
            assert float((rel <= 1e-8).double().mean()) >= 0.99
        else:
            assert float(rel.max()) <= 1e-8


@pytest.mark.parametrize("name, solver", [("lag_infusion", "bdf"), ("two_outputs_cens", "trbdf2"),
                                          ("poison", "kvaerno5"), ("cov_affine", "kvaerno3")])
def test_host_build_psi_does_not_depend_on_the_grid(host_dir, name, solver):
    """One block (128 lanes, each marching several cells one after the
    other), three blocks, and the full grid (one cell a lane): the same
    psi bit for bit."""
    plan = _plan(name, solver, 6, 50, seed=7)
    merge = plan.merge_runs is not None
    runs = [_host_psi(host_dir, plan, merge, b) for b in (1, 3, 0)]
    bits = [r.view(torch.int64) for r in runs]
    assert torch.equal(bits[0], bits[1]) and torch.equal(bits[0], bits[2])


def test_host_build_keeps_the_bdf_order_cap(host_dir):
    """Caps 1-3 run the instantiation with D of 6 rows, 4-5 the one with 8:
    a cap of each equals the twin at that cap."""
    for cap in (2, 5):
        model, data, sp, ems = stiff_case("two_cmt", 3, 20, seed=9, solver="bdf")
        plan = _FusedOdePsiPlan(model, model.lower(data.subjects()), sp,
                                ems.lower(model.resolve_output_label, model.nouteqs()),
                                torch.device("cpu"), torch.float64, bdf_max_order=cap)
        got = _host_psi(host_dir, plan, False)
        want = fused_ode.psi_ode_plain(*plan.streams, plan.support, plan.rhs,
                                       **plan.kernel_kwargs(False))
        assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) <= 1e-8
