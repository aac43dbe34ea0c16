"""The layout model of the explicit ODE tier (K2a, K2e) and the SASS reading
of its trial, on the CPU (float64).

``chip_smoke.py::explicit_layout_costs`` prices the explicit march from the
twin's trials of each lane in each march call
(``psi_ode_plain(counts=...)["trials_by_call"]``) under the layouts the
redesign weighed: a warp on 32 supports of one row or on 32 rows of one
support, synced at every march call or each lane marching its calls on its
own. ``ode_trial_mix`` finds one trial's instructions in a kernel's SASS.
The kernel itself is held to the twin on the card (``tests/test_torch_cuda.py``)
and as a host build (``tests/test_torch_explicit_host.py``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.likelihood.plans.ode import _FusedOdePsiPlan
from pharmsol_tpu_torch.ops.fused_ode import psi_ode_plain
from pharmsol_tpu_torch.utils.f32_budget import COVARIATE_MODEL_CENTRE, covariate_model_case


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_explicit", path)
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


@pytest.mark.parametrize("chain", [1, 3])
def test_identical_lanes_cost_the_same_in_every_layout(chain):
    """Every lane makes 5, 0 and 5 trials in its three calls: no lane waits
    in any layout. A cell takes 5 + 1 + 5 passes and one to end it, for 10
    trials; two of its passes hold no trial, four a boundary."""
    tb = np.full((3, 64, 64), 5)
    tb[1] = 0
    out = cs.explicit_layout_costs(tb, chain=chain)
    assert set(out) == {"synced", "support_synced", "row_lanes", "support_lanes"}
    for layout in out.values():
        assert layout["slots"] == 1.0
        assert layout["passes"] == pytest.approx(12 / 10)
        for beta, cost in layout["cost"].items():
            assert cost == pytest.approx(1.0 + beta * 4 / 10)


def test_hand_made_counts():
    """One row of 32 supports, two calls: lane 0 makes 4 then 1 trials, the
    others 1 then 4. Synced, each call costs its slowest lane: 32 x (4 + 4)
    slots. On their own the lanes take 1 + 4 + 1 + 1 passes... lane 0 its
    trials 4 and 1, then its end; the others 1, 4 and the end: every lane 6
    passes and the warp runs six, all with a trial but the last; a boundary
    in pass 0 (every lane's first call), pass 1 (the others' second call),
    pass 4 (lane 0's second call) and pass 5 (every lane's end)."""
    tb = np.ones((2, 1, 32), dtype=np.int64)
    tb[1] = 4
    tb[0, 0, 0], tb[1, 0, 0] = 4, 1
    trials = float(tb.sum())
    out = cs.explicit_layout_costs(tb, betas=(0.5,))
    assert out["synced"]["slots"] == pytest.approx(32 * 8 / trials)
    assert out["synced"]["cost"][0.5] == pytest.approx((32 * 8 + 0.5 * 32 * 3) / trials)
    lanes = out["row_lanes"]
    assert lanes["passes"] == pytest.approx(32 * 6 / trials)
    assert lanes["slots"] == pytest.approx(32 * 5 / trials)
    assert lanes["cost"][0.5] == pytest.approx(32 * (5 + 0.5 * 4) / trials)
    # one row: the support-major walk puts the 32 supports in one warp too
    assert out["support_lanes"] == lanes
    assert out["support_synced"] == out["synced"]


def test_support_major_layouts_are_the_row_major_ones_transposed():
    rng = np.random.RandomState(4)
    tb = rng.randint(0, 7, (5, 40, 64))
    out = cs.explicit_layout_costs(tb)
    flipped = cs.explicit_layout_costs(tb.transpose(0, 2, 1))
    assert out["support_synced"] == flipped["synced"]
    assert out["support_lanes"] == flipped["row_lanes"]


def test_lanes_on_their_own_even_out_over_several_cells():
    """With independent random counts, lanes that march their calls on their
    own take fewer slots than a warp synced at every call, and fewer still
    as each marches several cells (a lane's sum over its cells evens out);
    the synced layouts do not depend on the chain."""
    rng = np.random.RandomState(5)
    tb = rng.randint(0, 6, (8, 64, 64))
    one = cs.explicit_layout_costs(tb, chain=1)
    eight = cs.explicit_layout_costs(tb, chain=8)
    assert one["support_lanes"]["slots"] < one["support_synced"]["slots"]
    assert eight["support_lanes"]["slots"] < one["support_lanes"]["slots"]
    assert eight["synced"] == one["synced"]
    assert eight["support_synced"] == one["support_synced"]


def test_the_covariate_cell_favours_a_synced_warp_on_one_support():
    """The reference's covariate model (16 march calls a cell, 7 of them
    empty in every lane) on 64 subjects x 64 supports of the twin: a warp on
    32 rows of one support synced at every march call takes fewer lane-slots
    per trial than the per-row kernel's warp, and costs less than lanes that
    march on their own over several cells at every boundary share."""
    model, data, _, ems = covariate_model_case(64, 1, seed=3)
    sp = np.abs(np.asarray(COVARIATE_MODEL_CENTRE)[None, :]
                * (1.0 + 0.15 * np.random.RandomState(6).randn(64, 4)))
    plan = _FusedOdePsiPlan(model, model.lower(data.subjects()), sp,
                            ems.lower(model.resolve_output_label, model.nouteqs()),
                            torch.device("cpu"), torch.float64)
    counts = {}
    psi_ode_plain(*plan.streams, plan.support, plan.rhs, counts=counts, **plan.kernel_kwargs())
    tb = torch.stack(counts["trials_by_call"]).numpy()
    rep = cs.explicit_lane_report(tb)
    assert rep["calls"] == 16 and rep["zero_calls"] == 7
    one, eight = rep["layouts"][1], rep["layouts"][8]
    assert one["support_synced"]["slots"] < one["synced"]["slots"]
    assert rep["synced"] == pytest.approx(one["synced"]["slots"])
    for beta in cs.LAYOUT_BETAS:
        assert eight["support_synced"]["cost"][beta] < eight["support_lanes"]["cost"][beta]
        assert eight["support_synced"]["cost"][beta] < eight["synced"]["cost"][beta]


def test_trial_mix_of_a_lane_loop_and_of_a_per_row_kernel():
    """A lane loop: one pass, the smallest loop that holds the last warp
    vote. A per-row kernel: of the innermost loops with a square root, the
    one with the most (a dose loop holds two, the trial three)."""
    per_row = [(0x00, "MOV", ""), (0x10, "DFMA", ""), (0x20, "MUFU.RSQ64H", ""),
               (0x28, "MUFU.RSQ64H", ""), (0x30, "BRA", " 0x10"),
               (0x40, "DFMA", ""), (0x50, "MUFU.RSQ64H", ""), (0x58, "MUFU.RSQ64H", ""),
               (0x5c, "MUFU.RSQ64H", ""), (0x60, "CALL.REL.NOINC", " 0x100"),
               (0x68, "BRA", " 0x40"), (0x70, "BRA", " 0x00"), (0x80, "EXIT", "")]
    mix = cs.ode_trial_mix(per_row)
    assert not mix["lane_pass"] and mix["calls"] == 1
    assert mix["mufu"] == {"MUFU.RSQ64H": 3}
    assert mix["trial"]["total"] == 6
    lane = [(0x00, "MOV", ""), (0x10, "DFMA", ""), (0x20, "BRA", " 0x50"),
            (0x30, "MUFU.RSQ64H", ""), (0x40, "STG.E.64", ""), (0x50, "BRA", " 0x90"),
            (0x60, "DFMA", ""), (0x70, "MUFU.RSQ64H", ""), (0x80, "CALL.REL.NOINC", " 0x200"),
            (0x90, "VOTE.ALL", ""), (0xa0, "BRA", " 0x10"), (0xb0, "EXIT", "")]
    mix = cs.ode_trial_mix(lane)
    assert mix["lane_pass"] and mix["trial"]["total"] == 10
    assert mix["calls"] == 1 and mix["mufu"] == {"MUFU.RSQ64H": 2}
    assert cs.ode_trial_mix([(0x00, "DFMA", ""), (0x10, "EXIT", "")]) is None
