"""The reference's own literals over the port.

Cases of ``tests/test_reference_literals.py``, ``_2.py`` and ``_3.py`` that
use what the port has: every value asserted here is the same numeric literal
those files copied from the reference's unit tests (cited per test), at the
same tolerance, now held against ``pharmsol_tpu_torch`` on the CPU.

Taken: the engine literals through ``estimate_predictions``
(analytical/mod.rs: the seq chain across an infusion sub-split, a rateiv
forcing), the log-likelihood literals through ``estimate_log_likelihood``
(likelihood/mod.rs: no observation, a hand-computed normal value; the
normal log-density at its mean), the assay error models (error_model.rs),
the residual error models (residual_error.rs), ADDL/II expansion and
``build_data`` (row.rs), the AUC helpers (auc.rs and nca/calc.rs's two
segment literals), the Pmetrics CSV fixtures (pmetrics.rs, covariate.rs),
covariate interpolation (covariate.rs), the event constructors (event.rs)
the model accessors over metadata (metadata.rs:1084-1123) and the DSL
analyzer's expectations (analyze.rs:2953-3091, ``_3.py``:764-815).

Waiting for their slices: the NCA cases (nca/calc.rs, nca/tests.rs,
nca/sparse.rs, nca/summary.rs), the metadata builder's shape
and validation cases, and the data container, sorting, lag/fa
``process_events``, ``expand`` and builder cases of structs.rs and
builder.rs.
"""

import io
import math

import numpy as np
import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import metadata as md
from pharmsol_tpu_torch.data.auc import auc, auc_interval, auc_segment, aumc, interpolate_linear
from pharmsol_tpu_torch.data.covariate import Covariate, Covariates, CovariateSegment
from pharmsol_tpu_torch.data.pmetrics import read_pmetrics
from pharmsol_tpu_torch.data.row import DataRow, build_data
from pharmsol_tpu_torch.likelihood.distributions import lognormpdf

from test_reference_literals_2 import _ADDL_CSV, _COVARIATE_CSV


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


# -- analytical/mod.rs: engine literals ---------------------------------------


def test_secondary_equations_accumulate_within_single_solve():
    """analytical/mod.rs:493-527: seq accumulates across the infusion
    sub-split; expected prediction 2.5."""
    model = pt.Analytical(
        lambda x, p, t, rateiv, cov: torch.stack([x[0] + p[0] * t]),
        seq_eq=lambda p, t, cov: torch.stack([p[0] + 1.0]),
        out=lambda x, p, t, cov: x[0:1], nstates=1, ndrugs=1, nout=1)
    subject = (pt.Subject.builder("seq").bolus(0.0, 0.0, 0)
               .infusion(0.25, 1.0, 0, 0.25).observation(1.0, 0.0, 0).build())
    preds = model.estimate_predictions(subject, np.array([1.0]))
    assert abs(float(preds.flat_predictions()[0]) - 2.5) < 1e-9


def test_infusion_inputs_match_state_dimension():
    """analytical/mod.rs:529-560: rateiv[3] forcing gives prediction 4.0."""
    model = pt.Analytical(
        lambda x, p, t, rateiv, cov: torch.stack([x[0] + rateiv[3] * t, x[1], x[2], x[3]]),
        out=lambda x, p, t, cov: x[0:1], nstates=4, ndrugs=4, nout=1)
    subject = pt.Subject.builder("inf").infusion(0.0, 4.0, 3, 1.0).observation(1.0, 0.0, 0).build()
    preds = model.estimate_predictions(subject, np.array([0.0]))
    assert abs(float(preds.flat_predictions()[0]) - 4.0) < 1e-9


# -- likelihood/mod.rs ----------------------------------------------------------


def test_lognormpdf_at_mean():
    """likelihood/mod.rs:345-359: -0.5*ln(2*pi) at the mean."""
    got = float(lognormpdf(torch.tensor(0.0, dtype=torch.float64), 0.0,
                           torch.tensor(1.0, dtype=torch.float64)))
    assert abs(got - (-0.5 * math.log(2.0 * math.pi))) < 1e-12


def test_empty_predictions_have_neutral_log_likelihood():
    """likelihood/mod.rs:319-325: no observations -> log-lik 0 (log 1)."""
    model = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)
    s = pt.Subject.builder("none").bolus(0.0, 100.0, 0).build()
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(1.0, 0.0, 0.0, 0.0), 0.0))
    assert model.estimate_log_likelihood(s, np.array([0.2, 10.0]), ems) == 0.0


def test_log_likelihood_manual_normal_value():
    """likelihood/mod.rs:236-270: obs 10, pred 10.5, additive
    poly(0,1,0,0) factor 0 -> sigma 10; ll = -0.5 ln(2 pi) - ln 10 -
    0.5 (0.5/10)^2."""
    model = pt.Analytical(lambda x, p, t, rateiv, cov: torch.stack([x[0]]),
                          init=lambda p, t, cov: [10.5],
                          out=lambda x, p, t, cov: x[0:1], nstates=1, ndrugs=1, nout=1)
    s = pt.Subject.builder("m").observation(1.0, 10.0, 0).build()
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.0, 1.0, 0.0, 0.0), 0.0))
    ll = model.estimate_log_likelihood(s, np.array([0.0]), ems)
    z = (10.0 - 10.5) / 10.0
    assert abs(ll - (-0.5 * math.log(2 * math.pi) - math.log(10.0) - 0.5 * z * z)) < 1e-9


# -- error_model.rs -------------------------------------------------------------


def test_assay_error_model_literals():
    """error_model.rs:1185-1199 sigma sqrt(26) and 2.0; :1201-1223
    coefficients; :1225-1230 and :1380-1408 factor 5; :1242-1296 len 0, 1, 2."""
    m = pt.AssayErrorModel.additive(pt.ErrorPoly(1.0, 0.0, 0.0, 0.0), 5.0)
    assert m.sigma_from_value(20.0) == pytest.approx(math.sqrt(26.0))
    prop = pt.AssayErrorModel.proportional(pt.ErrorPoly(1.0, 0.0, 0.0, 0.0), 2.0)
    assert prop.sigma_from_value(20.0) == pytest.approx(2.0)
    m4 = pt.AssayErrorModel.additive(pt.ErrorPoly(1.0, 2.0, 3.0, 4.0), 5.0)
    assert tuple(m4.errorpoly().coefficients()) == (1.0, 2.0, 3.0, 4.0)
    assert m4.factor() == 5.0 and pt.AssayErrorModels().add(0, m4).factor(0) == 5.0
    assert len(pt.AssayErrorModels()) == 0
    one = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(1.0, 0.0, 0.0, 0.0), 0.0))
    assert len(one) == 1
    assert len(one.add(1, pt.AssayErrorModel.proportional(
        pt.ErrorPoly(1.0, 0.0, 0.0, 0.0), 2.0))) == 2


# -- residual_error.rs ------------------------------------------------------------


@pytest.mark.parametrize("form", ["float", "tensor"])
def test_residual_sigma_literals(form):
    """residual_error.rs: constant 0.5 at 0/100/-50; proportional b=0.1 ->
    10, 5, 10; combined sqrt(0.25) at 0, sqrt(100.25) at 100; the sqrt(eps)
    floor at f=0. With Python floats and with float64 tensors."""
    f = (lambda v: v) if form == "float" else (lambda v: torch.tensor(v, dtype=torch.float64))
    c = pt.ResidualErrorModel.constant(0.5)
    for v in (0.0, 100.0, -50.0):
        assert abs(float(c.sigma(f(v))) - 0.5) < 1e-10
    p = pt.ResidualErrorModel.proportional(0.1)
    for v, want in ((100.0, 10.0), (50.0, 5.0), (-100.0, 10.0)):
        assert abs(float(p.sigma(f(v))) - want) < 1e-10
    cb = pt.ResidualErrorModel.combined(0.5, 0.1)
    assert abs(float(cb.sigma(f(0.0))) - 0.5) < 1e-10
    assert abs(float(cb.sigma(f(100.0))) - math.sqrt(100.25)) < 1e-10
    s = float(p.sigma(f(0.0)))
    assert s > 0.0 and s >= math.sqrt(np.finfo(np.float64).eps)


def test_residual_weighted_squared_and_models():
    """residual_error.rs: weighted residual 4 (constant) and 0.04
    (proportional); the models map: len 2, sigma(0, 100) 0.5, sigma(1, 100)
    10."""
    assert abs(pt.ResidualErrorModel.constant(1.0).weighted_squared_residual(5.0, 3.0)
               - 4.0) < 1e-10
    assert abs(pt.ResidualErrorModel.proportional(0.1).weighted_squared_residual(12.0, 10.0)
               - 0.04) < 1e-10
    models = (pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.constant(0.5))
              .add(1, pt.ResidualErrorModel.proportional(0.1)))
    assert len(models) == 2
    assert abs(float(models.sigma(0, 100.0)) - 0.5) < 1e-10
    assert abs(float(models.sigma(1, 100.0)) - 10.0) < 1e-10


# -- row.rs: ADDL/II expansion and build_data ---------------------------------


@pytest.mark.parametrize("addl,times", [
    (3, [12.0, 24.0, 36.0, 0.0]),                                  # row.rs:680-695
    (-3, [-12.0, -24.0, -36.0, 0.0]),                              # row.rs:697-713
    (-10, [-12.0 * k for k in range(1, 11)] + [0.0]),              # row.rs:715-734
])
def test_addl_times(addl, times):
    row = DataRow.builder("pt1", 0.0).evid(1).dose(100.0).input(1).addl(addl).ii(12.0).build()
    events = row.into_events()
    assert len(events) == len(times)
    assert [e.time for e in events] == times


def test_infusion_with_addl():
    """row.rs:736-760: DUR=1 + ADDL=2 -> 3 infusions of 100 over 1."""
    row = DataRow.builder("pt1", 0.0).evid(1).dose(100.0).dur(1.0).input(1).addl(2).ii(24.0).build()
    events = row.into_events()
    assert len(events) == 3
    assert all(e.amount == 100.0 and e.duration == 1.0 for e in events)


@pytest.mark.parametrize("addl,ii,want", [(24, 120.0, None), (-1, 48.0, [-48.0, 0.0])])
def test_build_data_addl_sorted(addl, ii, want):
    """row.rs:779-801: ADDL=24, II=120 -> 25 sorted times 0..2880;
    row.rs:804-826: ADDL=-1, II=48 -> [-48, 0]."""
    rows = [DataRow.builder("pt1", 0.0).evid(1).dose(100.0).input(1).addl(addl).ii(ii).build()]
    occ = build_data(rows).subjects()[0].occasions()[0]
    times = [b.time for b in occ.events if hasattr(b, "amount") and not hasattr(b, "duration")]
    if want is None:
        assert len(times) == 25 and times == sorted(times)
        assert times[0] == 0.0 and times[-1] == 2880.0
    else:
        assert times == want


# -- auc.rs and nca/calc.rs's segment literals -----------------------------------


def test_auc_segment_literals():
    """auc.rs / nca/calc.rs:768-780: linear 9; log-down 5/ln 2;
    ascending lin-up/log-down is linear 7.5."""
    assert abs(auc_segment(0.0, 10.0, 1.0, 8.0, pt.AUCMethod.LINEAR) - 9.0) < 1e-10
    assert auc_segment(0.0, 10.0, 1.0, 5.0, pt.AUCMethod.LIN_UP_LOG_DOWN) == \
        pytest.approx(5.0 / math.log(10.0 / 5.0), abs=1e-10)
    assert abs(auc_segment(0.0, 5.0, 1.0, 10.0, pt.AUCMethod.LIN_UP_LOG_DOWN) - 7.5) < 1e-10


def test_auc_profile_literals():
    """auc.rs: full profile 44; aumc 18; auc_interval 21.0, 16.5, 0.0 outside
    the range, 0.0 at zero width."""
    assert abs(auc([0.0, 1.0, 2.0, 4.0, 8.0, 12.0], [0.0, 10.0, 8.0, 4.0, 2.0, 1.0],
                   pt.AUCMethod.LINEAR) - 44.0) < 1e-10
    assert abs(aumc([0.0, 1.0, 2.0], [0.0, 10.0, 8.0], pt.AUCMethod.LINEAR) - 18.0) < 1e-10
    assert abs(auc_interval([0.0, 1.0, 2.0, 4.0, 8.0], [0.0, 10.0, 8.0, 4.0, 2.0], 1.0, 4.0,
                            pt.AUCMethod.LINEAR) - 21.0) < 1e-10
    assert abs(auc_interval([0.0, 2.0, 4.0], [0.0, 10.0, 6.0], 1.0, 3.0,
                            pt.AUCMethod.LINEAR) - 16.5) < 1e-10
    t3, c3 = [1.0, 2.0, 4.0], [10.0, 8.0, 4.0]
    assert auc_interval(t3, c3, 0.0, 0.5, pt.AUCMethod.LINEAR) == 0.0
    assert auc_interval(t3, c3, 5.0, 10.0, pt.AUCMethod.LINEAR) == 0.0
    assert auc_interval([0.0, 1.0, 2.0], [0.0, 10.0, 8.0], 1.0, 1.0, pt.AUCMethod.LINEAR) == 0.0


def test_interpolate_linear_literals():
    """auc.rs: within 5.0, 8.0; at the boundaries 0.0, 6.0; clamped 5, 15."""
    t, v = [0.0, 2.0, 4.0], [0.0, 10.0, 6.0]
    for x, want in ((1.0, 5.0), (3.0, 8.0), (0.0, 0.0), (4.0, 6.0)):
        assert abs(interpolate_linear(t, v, x) - want) < 1e-10
    assert interpolate_linear([1.0, 3.0], [5.0, 15.0], 0.0) == 5.0
    assert interpolate_linear([1.0, 3.0], [5.0, 15.0], 5.0) == 15.0


# -- parser/pmetrics.rs and covariate.rs CSV fixtures ----------------------------


def test_pmetrics_addl_csv_event_times():
    """pmetrics.rs test_addl: subject 1 (ADDL=-10) -> [-120..-12, 0, 9];
    subject 2 (ADDL=+10) -> [0, 9, 12..120]."""
    subjects = read_pmetrics(io.StringIO(_ADDL_CSV)).subjects()
    assert [e.time for e in subjects[0].occasions()[0].events] == \
        [-12.0 * k for k in range(10, 0, -1)] + [0.0, 9.0]
    assert [e.time for e in subjects[1].occasions()[0].events] == \
        [0.0, 9.0] + [12.0 * k for k in range(1, 11)]


def test_pmetrics_covariate_csv_interpolation():
    """covariate.rs:685-772: WT 70/72/74 at knots, 70.4 at 12, 73 at 36,
    74 carried to 60; subject 2: 65 at 0, 66 at 18, 69 at 48."""
    subjects = read_pmetrics(io.StringIO(_COVARIATE_CSV)).subjects()
    wt = subjects[0].occasions()[0].covariates.get_covariate("wt")
    assert (wt.interpolate(0.0), wt.interpolate(24.0), wt.interpolate(48.0)) == (70.0, 72.0, 74.0)
    assert abs(wt.interpolate(12.0) - 70.4) < 1e-8
    assert (wt.interpolate(36.0), wt.interpolate(60.0)) == (73.0, 74.0)
    wt2 = subjects[1].occasions()[0].covariates.get_covariate("wt")
    assert (wt2.interpolate(0.0), wt2.interpolate(18.0), wt2.interpolate(48.0)) == \
        (65.0, 66.0, 69.0)


# -- covariate.rs ---------------------------------------------------------------


def test_covariate_segments():
    """covariate.rs:506-535: half-open [from, to) linear and carry-forward
    segments."""
    seg = CovariateSegment(0.0, 10.0, 1.0, 0.0, False)
    assert (seg.interpolate(0.0), seg.interpolate(5.0)) == (0.0, 5.0)
    assert seg.interpolate(10.0) is None and seg.interpolate(15.0) is None
    cf = CovariateSegment(0.0, 10.0, 0.0, 5.0, True)
    assert (cf.interpolate(0.0), cf.interpolate(5.0)) == (5.0, 5.0)
    assert cf.interpolate(10.0) is None and cf.interpolate(15.0) is None


def test_covariate_interpolation_table():
    """covariate.rs:537-610 (and :583-609 of the first tranche): linear
    between knots, carried past the last; a fixed covariate stays."""
    covs = Covariates()
    c1 = Covariate("covariate1", False)
    c1.add_observation(0.0, 0.0)
    c1.add_observation(10.0, 10.0)
    covs.add_covariate("covariate1", c1)
    got = covs.get_covariate("covariate1")
    assert [got.interpolate(t) for t in (0.0, 5.0, 10.0, 15.0)] == [0.0, 5.0, 10.0, 10.0]
    covs = Covariates()
    for t, v in ((0.0, 70.0), (12.0, 72.0), (24.0, 75.0)):
        covs.add_observation("weight", t, v)
    covs.add_observation("age", 0.0, 35.0)
    covs.set_covariate_fixed("age", True)
    w = covs.get_covariate("weight")
    assert [w.interpolate(t) for t in (0.0, 6.0, 12.0, 18.0, 24.0, 30.0)] == \
        [70.0, 71.0, 72.0, 73.5, 75.0, 75.0]
    a = covs.get_covariate("age")
    assert [a.interpolate(t) for t in (0.0, 12.0, 100.0)] == [35.0, 35.0, 35.0]


def test_covariates_update_and_hash():
    """covariate.rs:612-662: update_observation; :775-810: the hash is
    deterministic and differs on value and name."""
    covs = Covariates()
    covs.add_observation("bmi", 0.0, 25.0)
    covs.add_observation("bmi", 12.0, 26.0)
    assert covs.get_covariate("bmi").interpolate(6.0) == 25.5
    assert covs.update_observation("bmi", 12.0, 27.0)
    assert covs.get_covariate("bmi").interpolate(6.0) == 26.0
    assert covs.get_covariate("bmi").interpolate(12.0) == 27.0
    covs.add_observation("bmi", 24.0, 28.0)
    assert covs.get_covariate("bmi").interpolate(18.0) == 27.5

    def mk(name, v0):
        out = Covariates()
        c = Covariate(name, False)
        c.add_observation(0.0, v0)
        out.add_covariate(name, c)
        return out

    assert mk("wt", 70.0).content_hash() == mk("wt", 70.0).content_hash()
    assert mk("wt", 70.0).content_hash() != mk("wt", 80.0).content_hash()
    assert mk("wt", 70.0).content_hash() != mk("ht", 70.0).content_hash()


# -- event.rs -------------------------------------------------------------------


def test_event_constructor_literals():
    """event.rs test_bolus_creation / test_infusion_creation."""
    b = pt.Bolus(time=2.5, amount=100.0, input=1)
    assert (b.time, b.amount, str(b.input)) == (2.5, 100.0, "1")
    inf = pt.Infusion(time=1.0, amount=200.0, input=1, duration=2.5)
    assert (inf.time, inf.amount, inf.duration) == (1.0, 200.0, 2.5)


# -- metadata.rs: the model accessors -------------------------------------------


def test_model_accessors_over_metadata():
    """metadata.rs:1084-1123 through the model: parameter_index ke 0, v 1;
    covariate_index wt 0; state_index central 0; the route's destination."""
    meta = (md.new("bimodal_ke").kind(md.ModelKind.ODE).parameters(["ke", "v"])
            .covariates([md.CovariateDecl.continuous("wt")])
            .states(["central"]).outputs(["cp"])
            .route(md.Route.infusion("iv").to_state("central")))
    model = pt.ODE(lambda x, p, t, b, rateiv, cov: torch.stack([-p[0] * x[0] + rateiv[0]]),
                   out=lambda x, p, t, cov: x[0:1] / p[1],
                   nstates=1, ndrugs=1, nout=1).with_metadata(meta)
    assert (model.parameter_index("ke"), model.parameter_index("v")) == (0, 1)
    assert model.covariate_index("wt") == 0 and model.state_index("central") == 0
    assert model.metadata().route("iv").destination == "central"
    assert model.metadata().output_index("cp") == 0
    assert [label for label, _ in model.assay_error_models().items()] == ["cp"]


# -- pharmsol-dsl/src/analyze.rs: the analyzer's expectations (:2953-3180) ----------

_ANALYTICAL_OK = """
name = analytical_ok
kind = analytical
params = ka, ke0, v
derived = ke
states = depot, central
outputs = cp
bolus(oral) -> depot
ke = ke0
structure = one_compartment_with_absorption
out(cp) = central / v
"""


def test_analytical_structure_requirement_satisfied_by_derive():
    """analyze.rs:2953-2979: derived `ke` satisfies the kernel requirement
    and the plan binds one_compartment_with_absorption."""
    rt = pt.dsl.compile_model(_ANALYTICAL_OK)
    assert rt.analyzed.kernel_plan is not None
    assert rt.analyzed.kernel_plan.kernel == "one_compartment_with_absorption"


def test_analytical_structure_missing_name_suggests():
    """analyze.rs:3036-3061: `kel` instead of `ke` -> requires `ke` with a
    did-you-mean suggestion; `ka` and `kel` are both distance-1 from `ke`,
    ties break lexicographically -> `ka`."""
    src = _ANALYTICAL_OK.replace("params = ka, ke0, v", "params = ka, kel, v")
    src = src.replace("derived = ke\n", "").replace("ke = ke0\n", "")
    with pytest.raises(pt.dsl.DslError) as err:
        pt.dsl.compile_model(src)
    d = next(d for d in err.value.diagnostics if d.code == "DSL2030")
    assert "requires" in d.message and "ke" in d.message
    assert d.suggestion == "ka"


def test_analytical_params_derive_overlap_rejected():
    """analyze.rs:3063-3091 (+3227-3250): a name in both params and derived
    is rejected."""
    src = _ANALYTICAL_OK.replace("params = ka, ke0, v", "params = ka, ke, v")
    with pytest.raises(pt.dsl.DslError) as err:
        pt.dsl.compile_model(src)
    assert any(d.code in ("DSL2029", "DSL2005") for d in err.value.diagnostics)
