"""Data layer, lowering and segment streams: the port equals the JAX package.

Each scenario is built once with the JAX package's builder and carried into
the port with ``convert.data_from_reference``; both packages then lower it.
The lowered rows and the fused kernel's segment streams must be equal, not
merely close: both are host numpy on the same inputs.
"""

import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.ops.pallas_psi import segment_schedule as jax_schedule
from pharmsol_tpu.ops.pallas_psi import streams_from_grid as jax_streams

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.engine.grid import OccasionArrays, build_segments, to_tensors
from pharmsol_tpu_torch.ops.fused_psi import streams_from_grid


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _subjects(scenario, rng):
    out = []
    for i in range(3):
        b = pst.Subject.builder(f"{scenario}{i}").bolus(0.0, 100.0, 0)
        if scenario == "multi_dose":
            b = b.bolus(12.0, 80.0, 0).bolus(24.0, 60.0, 0)
        elif scenario == "infusion":
            b = b.infusion(2.0, 120.0, 0, 1.5).infusion(10.0, 60.0, 0, 0.5)
        for t in (0.5, 1.0, 2.0, 4.0, 6.0 + i, 12.0, 25.0):
            b = b.observation(t, float(abs(4.0 + rng.randn())), 0)
        if scenario == "missing":
            b = b.missing_observation(3.0, 0).missing_observation(12.0, 0)
        elif scenario == "censored":
            b = b.censored_observation(30.0, 0.1, 0, pst.Censor.BLOQ)
            b = b.censored_observation(0.25, 8.0, 0, pst.Censor.ALOQ)
        elif scenario == "errorpoly":
            b = b.observation_with_error(8.0, 3.0, 0, (0.1, 0.2, 0.0, 0.01))
        elif scenario == "two_outputs":
            b = b.observation(1.5, 2.0, 1).observation(9.0, 1.0 + i, 1)
        elif scenario == "two_occasions":
            b = b.reset().bolus(0.0, 50.0, 0).observation(1.0, 2.0, 0)
            if i:
                b = b.observation(4.0, 1.5, 0)
        out.append(b.build())
    return out


SCENARIOS = ["multi_dose", "infusion", "missing", "censored", "errorpoly",
             "two_outputs", "two_occasions"]


def _both(scenario):
    rng = np.random.RandomState(SCENARIOS.index(scenario))
    data_j = pst.Data(_subjects(scenario, rng))
    nout = 2 if scenario == "two_outputs" else 1
    ems_j = pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1), 1.0))
    if nout == 2:
        ems_j = ems_j.add(1, pst.AssayErrorModel.proportional(
            pst.ErrorPoly(0.1, 0.2), 2.0))
    mj = pst.Analytical(pst.one_compartment_with_absorption,
                        nstates=2, ndrugs=1, nout=nout)
    mt = pt.Analytical(pt.one_compartment_with_absorption,
                       nstates=2, ndrugs=1, nout=nout)
    data_t = convert.data_from_reference(data_j)
    ems_t = convert.error_models_from_reference(ems_j)
    gj, gt = mj.lower(data_j.subjects()), mt.lower(data_t.subjects())
    lj = ems_j.lower(mj.resolve_output_label, nout)
    lt = ems_t.lower(mt.resolve_output_label, nout)
    return (data_j, gj, lj), (data_t, gt, lt)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_lowered_rows_equal(scenario):
    (data_j, gj, lj), (data_t, gt, lt) = _both(scenario)
    assert [s.hash() for s in data_t.subjects()] == \
        [s.hash() for s in data_j.subjects()]
    for field in OccasionArrays._fields:
        a = np.asarray(getattr(gj.rows, field))
        b = np.asarray(getattr(gt.rows, field))
        assert a.shape == b.shape, field
        assert np.array_equal(a, b), field
    assert np.array_equal(np.asarray(gj.row_subject), gt.row_subject)
    assert gj.subject_ids == gt.subject_ids
    for field in ("kind", "factor", "poly"):
        assert np.array_equal(getattr(lj, field), getattr(lt, field))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_streams_and_segments_equal(scenario):
    (_, gj, lj), (_, gt, lt) = _both(scenario)
    want = jax_streams(gj.rows, lj)
    got = streams_from_grid(gt.rows, lt)
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b)
    # the device sort of the port reproduces the JAX lexsort
    _, t_sorted, seg_dt, is_event = jax_schedule(gj.rows)
    segs = build_segments(to_tensors(gt.rows, "cpu", torch.float64), ninput=1)
    assert np.array_equal(segs.t.numpy(), t_sorted)
    assert np.array_equal(segs.dt.numpy(), seg_dt)
    assert np.array_equal(segs.is_event.numpy(), is_event)
    # and every observation slot lands where the stream puts its value
    pos = segs.obs_pos.numpy()
    vals = np.take_along_axis(got[4], pos, axis=1)
    active = np.asarray(gt.rows.obs_valid) & np.asarray(gt.rows.obs_has_value)
    assert np.array_equal(vals[active], np.asarray(gt.rows.obs_value)[active])


def test_lower_occasion_matches_population_rows():
    """The per-occasion lowering (the slow oracle) equals the batch one."""
    from pharmsol_tpu_torch.engine.grid import lower_occasion

    (_, gj, _), (data_t, gt, _) = _both("two_occasions")
    model = pt.Analytical(pt.one_compartment_with_absorption,
                          nstates=2, ndrugs=1, nout=1)
    NB, NI, NO = (gt.rows.bolus_t.shape[1], gt.rows.inf_t.shape[1],
                  gt.rows.obs_t.shape[1])
    r = 0
    for subject in data_t.subjects():
        for occ in subject.occasions():
            low = lower_occasion(occ, subject.id, model.resolve_input_label,
                                 model.resolve_output_label, [], NB, NI, NO, 1)
            for field in OccasionArrays._fields:
                assert np.array_equal(np.asarray(getattr(low.arrays, field)),
                                      np.asarray(getattr(gt.rows, field))[r]), field
            r += 1
    assert r == gt.n_rows


def test_rows_from_reference_matches_port_lowering():
    (_, gj, _), (_, gt, _) = _both("infusion")
    a = convert.rows_from_reference(gj.rows, "cpu", torch.float64)
    b = to_tensors(gt.rows, "cpu", torch.float64)
    for field in OccasionArrays._fields:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and torch.equal(x, y), field
