"""Per-lane trial counts of the fused ODE twin and the lane-slot measure of
the implicit tiers' layout (float64 on the CPU).

``ops/fused_ode.py::psi_ode_plain(counts=...)`` records each march call's
trials per (row, support) lane (``counts["trials_by_call"]``).
``chip_smoke.py`` turns them into lane-slots per trial: a warp of 32 lanes
takes 32 x its slowest lane's trials, so the measure is 1 when no lane waits.
The parent layout of the CUDA kernel (K2b, K2c) synced a warp of 32 supports
of one row at every march call; the persistent grid lets each lane march its
cells one after the other (``ops/fused_ode.py::implicit_lane_cell``). The
kernel itself is held to the twin on the card (``tests/test_torch_cuda.py``).
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
from pharmsol_tpu_torch.ops.fused_ode import (
    IMPLICIT_THREADS, implicit_lane_cell, implicit_lanes, psi_ode_plain,
)
from pharmsol_tpu_torch.utils.f32_budget import ode_case, stiff_case


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


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


def _counts(model, data, sp, ems, merge=True):
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    plan = _FusedOdePsiPlan(model, grid, sp, lowered, torch.device("cpu"), torch.float64)
    counts = {}
    psi_ode_plain(*plan.streams, plan.support, plan.rhs, counts=counts,
                  **plan.kernel_kwargs(merge))
    return plan, counts


@functools.lru_cache(maxsize=None)
def _tmdd_bdf():
    """One TMDD subject x 64 supports under bdf (its twin's march is the
    longest here: one run for two tests)."""
    return _counts(*stiff_case("tmdd", 1, 64, seed=3, solver="bdf"))


@pytest.mark.parametrize("name, solver, merge", [
    ("tmdd", "bdf", True),
    ("two_cmt", "trbdf2", True),
    ("two_cmt", "trbdf2", False),
    ("lag_infusion", "kvaerno5", False),
    ("cov_affine", "kvaerno3", True),
])
def test_per_call_counts_sum_to_the_rows(name, solver, merge):
    """Every march call's [R, S] trials: they sum to ``steps_by_row`` and to
    ``steps``, a call per run (with lag one per pass and bolus plane, and
    one more, per segment), and no lane makes a trial in a call it cannot
    march."""
    plan, counts = (_tmdd_bdf() if name == "tmdd" else
                    _counts(*stiff_case(name, 3, 40, seed=5, solver=solver), merge=merge))
    calls = counts["trials_by_call"]
    R, S = plan.streams[0].shape[0], plan.support.shape[0]
    assert all(c.shape == (R, S) and c.dtype == torch.int64 for c in calls)
    total = torch.stack(calls)
    assert torch.equal(total.sum(dim=(0, 2)), counts["steps_by_row"])
    assert int(total.sum()) == counts["steps"]
    runs = plan.kernel_kwargs(merge)["merge_runs"]
    n_runs = len(runs) if runs is not None else plan.streams[0].shape[1]
    nb = len(plan.kernel_kwargs(merge)["bolus_inputs"])
    lagged = plan.kernel_kwargs(merge).get("lag_plane") is not None or \
        plan.kernel_kwargs(merge).get("lag_slots") is not None
    assert len(calls) == n_runs * (nb + 1 if lagged else 1)
    assert int(total.min()) >= 0 and int(total.max()) > 0


def test_explicit_tier_counts_per_call_too():
    model, data, sp, ems = ode_case("ode_dopri5")
    plan, counts = _counts(model, data, sp, ems)
    total = torch.stack(counts["trials_by_call"])
    assert torch.equal(total.sum(dim=(0, 2)), counts["steps_by_row"])
    assert len(counts["trials_by_call"]) == len(plan.kernel_kwargs()["merge_runs"] or
                                                range(plan.streams[0].shape[1]))


def test_lane_slots_of_hand_made_counts():
    """Two calls of one row of 40 supports (a ragged second warp of 8):
    synced, a warp takes 32 x its slowest lane in each call; on its own, 32
    x its slowest lane's sum over the calls."""
    tb = np.zeros((2, 1, 40), dtype=np.int64)
    tb[0, 0, :32] = 3
    tb[0, 0, 5] = 7       # call 0, first warp: slowest lane 7
    tb[0, 0, 32:] = 2     # call 0, second warp: 2
    tb[1, 0, :32] = 1
    tb[1, 0, 9] = 4       # call 1, first warp: 4
    tb[1, 0, 35] = 6      # call 1, second warp: 6
    rows = cs.lane_slots_by_row(tb)
    trials = int(tb.sum())
    assert trials == 31 * 3 + 7 + 8 * 2 + 31 * 1 + 4 + 7 * 0 + 6
    assert int(rows["trials"][0]) == trials
    assert int(rows["synced"][0]) == 32 * (7 + 2) + 32 * (4 + 6)
    # on its own: lane 5 takes 7 + 1, lane 9 3 + 4, lane 35 2 + 6
    assert int(rows["own"][0]) == 32 * 8 + 32 * 8
    assert int(cs.warp_slots(np.array([[1, 2, 3]]))[0]) == 32 * 3
    # passes: lane 5 takes 1 + 7 + 1, lane 6 1 + 3 + 1, lane 36 1 + 2 + 1
    # (its second call makes no trial), lane 35 1 + 2 + 6
    assert rows["passes"][0, 5] == 9 and rows["passes"][0, 6] == 5
    assert rows["passes"][0, 36] == 4 and rows["passes"][0, 35] == 9


def test_lane_slots_refilled_of_hand_made_counts():
    """96 cells over 64 lanes: pass 0 gives lane g cell g; pass 1 covers
    cells 64-95, rotated by one warp: lane g takes cell 64 + (g + 32) % 64,
    so lanes 32-63 take cells 64-95 and lanes 0-31 none. A cell's passes:
    one a trial, one for a call without a trial, one to end it."""
    trials = np.arange(96) % 7 + 1
    per_lane = trials[:64].copy()
    per_lane[32:] += trials[64:96]
    want = 32 * per_lane[:32].max() + 32 * per_lane[32:].max()
    got = cs.lane_slots_refilled(lambda c: trials[c], 96, 64)
    assert got == float(want)


@pytest.mark.parametrize("n_cells, lanes", [(96, 64), (1000, 128), (4096, 4096),
                                            (8191, 512), (64 * 48, 768), (5, 128)])
def test_each_cell_goes_to_one_lane(n_cells, lanes):
    g = np.arange(lanes)
    seen = np.concatenate([implicit_lane_cell(g, k, lanes) for k in range(-(-n_cells // lanes))])
    seen = seen[seen < n_cells]
    assert np.array_equal(np.sort(seen), np.arange(n_cells))
    assert implicit_lanes(n_cells, 10 ** 6) == -(-n_cells // IMPLICIT_THREADS) * IMPLICIT_THREADS


def test_the_walk_is_the_kernels():
    """The grid's block and the walk's step are the kernel's own: the
    kernel's source declares the same block and rotates by one warp."""
    from pharmsol_tpu_torch.ops import _build
    from pharmsol_tpu_torch.ops.fused_ode import implicit_cell

    src = (_build.CSRC_DIR / "fused_ode.cu").read_text()
    assert f"constexpr int IMPLICIT_THREADS = {IMPLICIT_THREADS};" in src
    assert "o = wrap ? o + 32 - lanes : o + 32;" in src
    # support-major: neighbouring cells are neighbouring rows of one support
    rows, supports = implicit_cell(np.arange(6), 3)
    assert rows.tolist() == [0, 1, 2, 0, 1, 2] and supports.tolist() == [0, 0, 0, 1, 1, 1]


def test_bdf_lanes_wait_for_their_warp_at_every_march_call():
    """On one TMDD subject x 64 supports under bdf, the parent's layout (a
    warp synced at every march call) takes more lane-slots than one cell a
    lane marching its calls on its own, and the persistent grid's refill
    takes no more than that."""
    _, counts = _tmdd_bdf()
    tb = torch.stack(counts["trials_by_call"]).numpy()
    rows = cs.lane_slots_by_row(tb)
    synced = float(rows["synced"][0]) / float(rows["trials"][0])
    own = float(rows["own"][0]) / float(rows["trials"][0])
    per_cell = rows["per_cell"].reshape(-1)
    passes = rows["passes"].reshape(-1)
    refilled = cs.lane_slots_refilled(lambda c: passes[c], 64, 32) / float(rows["trials"][0])
    assert np.array_equal(per_cell, torch.stack(counts["trials_by_call"]).sum(0).reshape(-1))
    assert synced > own >= 1.0
    # two cells a lane marched one after the other, a pass more per call
    # without a trial and per cell
    assert 1.0 <= refilled < synced
