"""The closed-form kernels of ``csrc/fused_psi.cu`` (K1a, K1b, K1c) built as
host C++ and held against the plain twin on the CPU (float64).

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``), but
their source is plain C++: with the CUDA qualifiers defined away by a shim
``cuda_runtime.h`` and every ``<<<grid, block, smem, stream>>>`` launch
replaced by loops over its blocks and threads, g++ builds the same
persistent grid of K1a, K1b and K1c (a block a tile of supports walking
rows, the support's prepared model, output rows and lag/fa row kept across
rows, the level models in a table prepared once per level and support) into a
library that ``ops/fused_psi.py::_launch`` (``psi_analytical``'s launch)
runs on CPU tensors. The shim's card holds 3 SMs x 2 blocks,
so a grid is smaller than every case's rows and each block walks several.
Built with ``-ffp-contract=off``. Skipped where there is no g++.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.likelihood.plans.analytical import _FusedPsiPlan
from pharmsol_tpu_torch.ops import _build
from pharmsol_tpu_torch.ops.fused_psi import STRUCTURES, _launch, psi_analytical_plain
from pharmsol_tpu_torch.utils.f32_budget import (
    FEATURE_CASES, K1C_CASES, NOMINAL, feature_case, k1c_case, kernel_case,
)

from test_torch_implicit_host import SHIM



def _split_top(text: str) -> list:
    """``text`` split at the commas outside parentheses."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(<" and 1 or 0
        depth -= ch in ")>" and 1 or 0
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def host_source(src: str) -> str:
    """``src`` with every kernel launch a loop over the grid's blocks and the
    block's threads, one thread at a time."""
    out, i = [], 0
    while True:
        j = src.find("<<<", i)
        if j < 0:
            out.append(src[i:])
            break
        k = src.rfind("\n", 0, j) + 1
        name = src[k:j].strip()
        e = src.find(">>>", j)
        grid, block = _split_top(src[j + 3:e])[:2]
        a0 = e + 3
        depth, c = 0, a0
        while True:
            depth += src[c] == "("
            depth -= src[c] == ")"
            if depth == 0:
                break
            c += 1
        args = src[a0 + 1:c]
        indent = src[k:k + len(src[k:]) - len(src[k:].lstrip())]
        out.append(src[i:k])
        out.append(
            f"{indent}{{ const dim3 g_({grid}); const dim3 b_({block}); gridDim = g_;"
            " blockDim = b_; for (unsigned by_ = 0; by_ < g_.y; ++by_)"
            " for (unsigned bx_ = 0; bx_ < g_.x; ++bx_) for (unsigned ty_ = 0; ty_ < b_.y; ++ty_)"
            " for (unsigned tx_ = 0; tx_ < b_.x; ++tx_) { blockIdx = dim3(bx_, by_);"
            f" threadIdx = dim3(tx_, ty_); {name}({args}); }} }}")
        i = src.find(";", c) + 1
    return "".join(out)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("psi_host")
    (d / "cuda_runtime.h").write_text(SHIM + "struct float4 { float x, y, z, w; };\n")
    src = host_source((_build.CSRC_DIR / "fused_psi.cu").read_text())
    assert "<<<" not in src
    (d / "fused_psi_host.cpp").write_text(src)
    out = d / "libfused_psi_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off", "-w",
                    f"-I{d}", "-o", str(out), str(d / "fused_psi_host.cpp")], check=True)
    return _build.bind_psi_library(ctypes.CDLL(str(out)))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _plan(model, data, sp, ems, dtype=torch.float64):
    return _FusedPsiPlan(model, model.lower(data.subjects()), sp,
                         ems.lower(model.resolve_output_label, model.nouteqs()),
                         torch.device("cpu"), dtype)


def _rel(got, want):
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def _both(plan, lib, blocks=None, **over):
    kw = dict(plan.kernel_kwargs(), **over)
    got, _ = _launch(lib, *plan.streams, plan.support, **kw, blocks=blocks)
    want = psi_analytical_plain(*plan.streams, plan.support, **kw)
    return got, want


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_k1a_host_build_matches_the_twin(host_lib, name):
    """K1a (its own inputs, sigma per observation) against the twin (the
    hoisted observation terms): 1e-10."""
    model, data, sp, ems = kernel_case(name)
    plan = _plan(model, data, sp, ems)
    assert all(v is None for v in plan.features.values())
    got, want = _both(plan, host_lib)
    assert torch.isfinite(want).all() and _rel(got, want) <= 1e-10


def k1a_case(structure, n_subjects, n_support, seed, n_out=1, one_segment=False,
             dose_only_row=False):
    """A K1a case (model, data, support, ems): ``n_subjects`` rows of two
    boluses, a 2 h infusion, five observations and a BLOQ and an ALOQ one
    (the observations cycling through ``n_out`` outputs; three outputs for
    a structure of two states or more, the third with a bias);
    ``one_segment``: one observation each and no dose (M = 1);
    ``dose_only_row``: the first subject has its doses and no observation
    (its row's observation constant is 0). ``n_support`` supports jittered
    15% around ``NOMINAL`` with the volume (last column) around 11."""
    from pharmsol_tpu_torch.engine.analytical import KERNELS

    rng = np.random.RandomState(seed)
    fn, nstates, nparams = KERNELS[structure]
    c = 1 if structure.endswith("_with_absorption") else 0
    subjects = []
    for i in range(n_subjects):
        b = pt.Subject.builder(f"k{i}")
        if one_segment:
            subjects.append(b.observation(2.0, float(abs(3 + rng.randn())), 0).build())
            continue
        b = b.bolus(0.0, 100.0, 0).bolus(12.0, 80.0, 0).infusion(4.0, 120.0, 0, 2.0)
        if not (dose_only_row and i == 0):
            for j, t in enumerate((1.0, 2.5, 6.0, 9.0, 24.0)):
                b = b.observation(t, float(abs(3 + rng.randn())), j % n_out)
            b = b.censored_observation(30.0, 0.1, 0, pt.Censor.BLOQ)
            b = b.censored_observation(0.25, 8.0, n_out - 1, pt.Censor.ALOQ)
        subjects.append(b.build())
    if n_out == 1:
        out = lambda x, p, t, cov: x[c:c + 1] / p[nparams]  # noqa: E731
    else:
        out = lambda x, p, t, cov: torch.stack(  # noqa: E731
            [x[c] / p[nparams], x[c + 1] / (2.0 * p[nparams]),
             0.5 * x[c] / p[nparams] + 0.01 * x[0] + 0.1 * p[nparams]])
    model = pt.Analytical(fn, out=out, nstates=nstates, ndrugs=1, nout=n_out)
    support = np.abs(np.array(NOMINAL[structure] + [11.0])[None, :]
                     * (1.0 + 0.15 * rng.randn(n_support, nparams + 1)))
    ems = pt.AssayErrorModels()
    for k in range(n_out):
        ems = ems.add(k, pt.AssayErrorModel.additive(pt.ErrorPoly(0.4, 0.1), 1.0))
    return model, pt.Data(subjects), support, ems


# K1a's persistent-grid cases: (structure, rows, supports, k1a_case options)
_ORAL2 = "two_compartments_with_absorption"
K1A_GRID_CASES = {
    **{name: (name, 13, 150, {}) for name in STRUCTURES},
    "one_row": (_ORAL2, 1, 150, {}),
    "one_support": (_ORAL2, 13, 1, {}),
    "support_257": (_ORAL2, 9, 257, {}),
    "one_segment": (_ORAL2, 7, 140, {"one_segment": True}),
    "row_without_observations": (_ORAL2, 9, 140, {"dose_only_row": True}),
    "three_outputs": (_ORAL2, 9, 140, {"n_out": 3}),
    "three_outputs_3cmt": ("three_compartments_cl_with_absorption", 9, 140, {"n_out": 3}),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(K1A_GRID_CASES))
def test_k1a_persistent_grid_matches_the_twin(host_lib, case, dtype):
    """K1a's launch on its persistent grid (the observation terms, in
    float32 the segment records, computed first; a block a tile of supports
    walking rows) at grids of 1 and 2 blocks, the shim's full card (6) and
    more blocks than the grid has rows: every cell within 1e-10 of the twin
    in float64, and in float32 within 1e-4 of the float32 twin (the same
    float32 arithmetic in another order, with the host's and torch's exp and
    log; 3.3e-6 at most on these cases), psi the same bit for bit whatever
    the grid. The cases: the 12 structures (boluses, an infusion, BLOQ and
    ALOQ), one row, one support, 257 supports (a ragged third tile), one
    segment a row (M = 1), a row with no observation, three outputs (the
    output rows read per observation)."""
    structure, R, S, opts = K1A_GRID_CASES[case]
    model, data, sp, ems = k1a_case(structure, R, S, seed=11, **opts)
    plan = _plan(model, data, sp, ems, dtype)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    kw = plan.kernel_kwargs()
    assert all(kw[name] is None for name in plan.features)
    streams = plan.streams
    assert streams[0].shape[0] == R
    if opts.get("one_segment"):
        assert streams[0].shape[1] == 1
    if opts.get("dose_only_row"):
        assert not bool((streams[3][0] > 0).any())
    if opts.get("n_out", 1) == 3:
        assert tuple(kw["out_coef"].shape)[0] == 3 and kw["obs_outeq"] is not None
    runs = []
    for blocks in (1, 2, None, 2 * R * ((S + 127) // 128) + 1):
        got, want = _both(plan, host_lib, blocks=blocks)
        assert torch.isfinite(want).all() and _rel(got, want) <= tol, blocks
        runs.append(got.view(torch.int64 if dtype == torch.float64 else torch.int32))
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    if opts.get("dose_only_row"):
        assert bool((got[0] == 0).all())


@pytest.mark.parametrize("name", list(FEATURE_CASES))
def test_k1b_host_build_matches_the_twin(host_lib, name):
    """K1b in every mode on the persistent grid: a grid of 1 and 3 blocks and
    the shim's full card (6), each block walking several rows; every cell
    within 1e-10 and psi the same bit for bit whatever the grid."""
    model, data, sp, ems, mode = feature_case(name, n_subjects=13, n_support=150, seed=7)
    plan = _plan(model, data, sp, ems)
    assert plan.mode == mode
    runs = []
    for blocks in (1, 3, None):
        got, want = _both(plan, host_lib, blocks=blocks)
        assert torch.isfinite(want).all() and _rel(got, want) <= 1e-10
        runs.append(got.view(torch.int64))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("name", list(K1C_CASES))
def test_k1c_host_build_matches_the_twin(host_lib, name):
    """K1c on every ``K1C_CASES`` case (lag_depth, lag_post, slot tables, a
    3-compartment case): 1e-10 on two grids."""
    model, data, sp, ems = k1c_case(name, 11, 140, seed=5)
    plan = _plan(model, data, sp, ems)
    for blocks in (2, None):
        got, want = _both(plan, host_lib, blocks=blocks)
        assert torch.isfinite(want).all() and _rel(got, want) <= 1e-10


@pytest.mark.parametrize("name", ["dynamic_lag_fa", "fa_only"])
def test_k1c_slot_tables_on_a_single_row(host_lib, name):
    """One subject with one occasion (R = 1) and a lag or fa that changes
    with time or a covariate: its per-dose slot planes are [1, S] each and
    reach the kernel with a row stride of S, not as one row per support;
    against the twin at 1e-10."""
    model, data, sp, ems = k1c_case(name, 1, 140, seed=6)
    plan = _plan(model, data, sp, ems)
    assert plan.streams[0].shape[0] == 1
    assert plan.lag_slots is not None or plan.fa_slots is not None
    got, want = _both(plan, host_lib)
    assert torch.isfinite(want).all() and _rel(got, want) <= 1e-10


@pytest.mark.parametrize("case", ["levels", "levels_3cmt", "depth_levels", "depth_3cmt"])
def test_level_models_from_the_table(host_lib, case):
    """Levels mode reads each support's level models from the table that the
    prologue kernel prepared once per (level, support): within 1e-10 of the
    twin, which prepares them per cell, on two grids bit for bit alike."""
    if case.startswith("levels"):
        model, data, sp, ems = feature_case(case, 9, 140, seed=2)[:4]
    else:
        model, data, sp, ems = k1c_case(case, 9, 140, seed=2)
    plan = _plan(model, data, sp, ems)
    assert plan.mode == "levels"
    got, want = _both(plan, host_lib, blocks=2)
    full, _ = _both(plan, host_lib)
    assert _rel(got, want) <= 1e-10
    assert torch.equal(got.view(torch.int64), full.view(torch.int64))


def test_lag_and_fa_rows_equal_their_planes(host_lib):
    """A lag and an fa given as one row per support (row stride 0) and as
    the same values broadcast to [R, S] planes: the same psi bit for bit."""
    model, data, sp, ems, _ = feature_case("row_lag_fa", 9, 140, seed=4)
    plan = _plan(model, data, sp, ems)
    kw = plan.kernel_kwargs()
    assert tuple(kw["lag_plane"].shape) == (1, 140) and tuple(kw["fa_plane"].shape) == (1, 140)
    R = plan.streams[0].shape[0]
    planes = {k: kw[k].expand(R, 140).contiguous() for k in ("lag_plane", "fa_plane")}
    rows, _ = _both(plan, host_lib)
    full, _ = _both(plan, host_lib, **planes)
    assert torch.equal(rows.view(torch.int64), full.view(torch.int64))


def test_prepared_fields_per_structure(host_lib):
    """The level table's width per structure (``Model::NPREP``, which the
    wrapper asks the library for): the fields that propagate reads, 2 / 4
    (1-compartment IV / oral), 8 / 11 (2-compartment), 33 / 37
    (3-compartment, with the spectral projectors); -1 for no structure."""
    want = {1: (2, 4), 2: (8, 11), 3: (33, 37)}
    for code, name in enumerate(STRUCTURES):
        assert host_lib.fused_psi_prep_fields(code) == want[code // 4 + 1][code % 2], name
    assert host_lib.fused_psi_prep_fields(12) == -1


def test_three_outputs_read_their_rows_per_observation(host_lib):
    """More than two outputs: the kernel reads the output rows per
    observation instead of keeping them; against the twin at 1e-10."""
    model, data, sp, ems, _ = feature_case("row_lag_fa", 6, 40, seed=9)
    plan = _plan(model, data, sp, ems)
    kw = plan.kernel_kwargs()
    rng = np.random.RandomState(3)
    S, NS = plan.support.shape[0], kw["out_coef"].shape[1]
    coef = torch.as_tensor(rng.uniform(0.05, 0.2, (3, NS, S)))
    bias = torch.as_tensor(rng.uniform(0.0, 0.1, (3, S)))
    outeq = torch.as_tensor(rng.randint(0, 3, plan.streams[0].shape).astype(np.float64))
    got, want = _both(plan, host_lib, out_coef=coef, out_bias=bias, obs_outeq=outeq)
    assert _rel(got, want) <= 1e-10
