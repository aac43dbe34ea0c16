"""The port's data I/O layer against the JAX package's: Pmetrics CSV
(``data/pmetrics.py``), DataRow ingestion (``data/row.py``), JSON serde
(``data/serde.py``) and the AUC helpers (``data/auc.py``).

Mirrors ``tests/test_data_layer.py`` and ``tests/test_serde.py`` (the
NCA-result round trip is in ``tests/test_torch_nca.py``, beside the port's
NCA layer). Every input is made once (a CSV text, rows
drawn from a seed with numpy, a subject) and read by both packages; subjects
compare equal through ``convert.data_from_reference`` and their content
hashes, the AUC helpers exactly (the same float64 arithmetic), JSON and CSV
texts character for character.
"""

import io
import json
import math

import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu.data import auc as jax_auc
from pharmsol_tpu.data import pmetrics as jax_pmetrics
from pharmsol_tpu.data import row as jax_row
from pharmsol_tpu.data import serde as jax_serde

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.data import auc, serde
from pharmsol_tpu_torch.data.auc import ObservationError
from pharmsol_tpu_torch.data.event import AUCMethod, Infusion
from pharmsol_tpu_torch.data.pmetrics import read_pmetrics, write_pmetrics
from pharmsol_tpu_torch.data.row import DataRow, build_data
from pharmsol_tpu_torch.errors import DataError, PharmsolError

PMETRICS_CSV = """ID,EVID,TIME,DUR,DOSE,ADDL,II,INPUT,OUT,OUTEQ,C0,C1,C2,C3,WT,AGE!
1,1,0,0,600,.,.,1,.,.,.,.,.,.,70.0,35
1,0,9,.,.,.,.,.,100,1,0.1,0.05,0,0,70.0,35
1,0,24,.,.,.,.,.,-99,1,.,.,.,.,72.0,35
2,1,0,2.0,600,.,.,1,.,.,.,.,.,.,65.0,40
2,0,12,.,.,.,.,.,95,1,.,.,.,.,65.0,40
"""


def same_data(port_data, jax_data):
    want = convert.data_from_reference(jax_data)
    assert [s.id for s in port_data] == [s.id for s in want]
    assert [s.hash() for s in port_data] == [s.hash() for s in want]


def rich_subject(lib, sid="s1"):
    return (lib.Subject.builder(sid).bolus(0.0, 100.0, 0).infusion(1.0, 50.0, 0, 0.5)
            .observation(2.0, 1.5, 0)
            .observation_with_error(3.0, 1.2, 0, (0.1, 0.05, 0.0, 0.0))
            .censored_observation(4.0, 0.05, 0, lib.Censor.BLOQ)
            .missing_observation(5.0, 0)
            .covariate("wt", 0.0, 70.0).covariate("wt", 24.0, 72.0).covariate("sex!", 0.0, 1.0)
            .reset().bolus(0.0, 200.0, 0).observation(1.0, 2.5, 0).build())


def random_rows(lib, seed, n_subjects=4):
    """DataRows drawn from ``seed``: doses with ADDL forward and backward,
    infusions, EVID 4 occasion resets, observations with censoring and
    errorpoly, a linear and a carried-forward covariate."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in rng.permutation(n_subjects):
        sid = f"p{i}"
        t = 0.0
        for k in range(5):
            evid = 4 if (k == 3 and rng.rand() < 0.7) else int(rng.rand() < 0.4)
            b = lib.DataRow.builder(sid, t).evid(evid)
            if evid:
                b = b.dose(float(rng.randint(50, 500))).input(str(rng.randint(0, 2)))
                if rng.rand() < 0.5:
                    b = b.dur(float(rng.choice([0.5, 2.0])))
                if rng.rand() < 0.5:
                    b = b.addl(int(rng.choice([-3, -1, 2, 4]))).ii(12.0)
            else:
                b = b.out(float(rng.rand() * 10)).outeq(str(rng.randint(0, 2)))
                if rng.rand() < 0.3:
                    b = b.cens(lib.Censor.BLOQ)
                if rng.rand() < 0.3:
                    b = b.errorpoly(0.1, 0.05, 0.0, 0.0)
            b = b.covariate("wt", float(60 + 20 * rng.rand())).covariate("age!", 40.0)
            rows.append(b.build())
            t += float(rng.choice([0.5, 1.0, 6.0]))
    return rows


# -- DataRow and build_data --------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_data_matches_jax(seed):
    same_data(build_data(random_rows(pt.data.row, seed)),
              jax_row.build_data(random_rows(jax_row, seed)))


@pytest.mark.parametrize("addl,times", [(2, [24.0, 48.0, 0.0]), (-3, [-12.0, -24.0, -36.0, 0.0])])
def test_datarow_addl_both_directions(addl, times):
    row = DataRow.builder("pt1", 0.0).evid(1).dose(100.0).input("iv").addl(addl).ii(
        12.0 if addl < 0 else 24.0).build()
    assert [e.time for e in row.into_events()] == times
    jrow = jax_row.DataRow.builder("pt1", 0.0).evid(1).dose(100.0).input("iv").addl(addl).ii(
        12.0 if addl < 0 else 24.0).build()
    assert [e.time for e in jrow.into_events()] == times


def test_datarow_infusion_and_missing_fields():
    (ev,) = DataRow.builder("p", 1.0).evid(1).dose(50.0).dur(2.0).input("iv").build().into_events()
    assert isinstance(ev, Infusion) and ev.duration == 2.0
    for b in (DataRow.builder("p", 0.0).evid(0),                  # missing outeq
              DataRow.builder("p", 0.0).evid(1).dose(1.0),        # missing input
              DataRow.builder("p", 0.0).evid(1).input("0"),       # missing dose
              DataRow.builder("p", 0.0).evid(7)):                 # unknown evid
        with pytest.raises(DataError):
            b.build().into_events()


def test_build_data_occasion_split():
    rows = [DataRow.builder("s", 0.0).evid(1).dose(100.0).input("0").build(),
            DataRow.builder("s", 1.0).evid(0).out(5.0).outeq("0").build(),
            DataRow.builder("s", 24.0).evid(4).dose(50.0).input("0").build(),
            DataRow.builder("s", 25.0).evid(0).out(3.0).outeq("0").build()]
    subject = build_data(rows).get_subject("s")
    assert [o.index for o in subject.occasions()] == [0, 1]
    assert len(subject.occasions()[1].boluses()) == 1


# -- Pmetrics CSV -------------------------------------------------------------


def test_read_pmetrics_matches_jax():
    data = read_pmetrics(io.StringIO(PMETRICS_CSV))
    same_data(data, jax_pmetrics.read_pmetrics(io.StringIO(PMETRICS_CSV)))
    occ = data.get_subject("1").occasions()[0]
    obs = occ.observations()
    assert obs[0].value == 100.0 and obs[0].errorpoly == (0.1, 0.05, 0.0, 0.0)
    assert obs[1].value is None  # OUT=-99: missing
    wt, age = occ.covariates.get("wt"), occ.covariates.get("age")
    assert not wt.fixed and abs(wt.interpolate(16.5) - 71.0) < 1e-12
    assert age.fixed
    assert len(data.get_subject("2").occasions()[0].infusions()) == 1


def test_read_pmetrics_from_a_path(tmp_path):
    p = tmp_path / "pop.csv"
    p.write_text("#" + PMETRICS_CSV + "# a comment line\n")
    same_data(read_pmetrics(str(p)), jax_pmetrics.read_pmetrics(str(p)))


@pytest.mark.parametrize("seed", [0, 3])
def test_write_pmetrics_matches_jax_and_round_trips(seed):
    """Both writers give the same text; reading it back gives the same
    events."""
    data = build_data(random_rows(pt.data.row, seed))
    jdata = jax_row.build_data(random_rows(jax_row, seed))
    buf, jbuf = io.StringIO(), io.StringIO()
    write_pmetrics(data, buf)
    jax_pmetrics.write_pmetrics(jdata, jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    buf.seek(0)
    back = read_pmetrics(buf)
    assert len(back) == len(data)
    for s, s2 in zip(data, back):
        for o, o2 in zip(s.occasions(), s2.occasions()):
            assert [e.time for e in o.events] == [e.time for e in o2.events]


def test_pmetrics_malformed_cells_raise():
    with pytest.raises(DataError):
        read_pmetrics(io.StringIO("ID,TIME\n1,0\n"))
    with pytest.raises(DataError):
        read_pmetrics(io.StringIO("ID,EVID,TIME,OUT,OUTEQ,CENS\n1,0,1,5,0,maybe\n"))
    with pytest.raises(DataError):
        read_pmetrics(io.StringIO(""))


# -- JSON serde ---------------------------------------------------------------


def test_json_matches_jax_both_ways(tmp_path):
    data = pt.Data([rich_subject(pt, "a"), rich_subject(pt, "b")])
    jdata = pst.Data([rich_subject(pst, "a"), rich_subject(pst, "b")])
    text = pt.to_json(data)
    assert text == pst.to_json(jdata)
    same_data(pt.from_json(pst.to_json(jdata)), jdata)
    same_data(data, pst.from_json(text))
    p = tmp_path / "pop.json"
    serde.save_json(data, str(p))
    same_data(serde.load_json(str(p)), jax_serde.load_json(str(p)))
    one = pt.from_json(pt.to_json(data.subjects()[0]))
    assert isinstance(one, pt.Data) and one.subjects()[0].hash() == data.subjects()[0].hash()


def test_subject_fields_survive_the_round_trip():
    s = rich_subject(pt)
    s2 = serde.subject_from_dict(serde.subject_to_dict(s))
    assert s2.hash() == s.hash() and s2.id == s.id and len(s2) == len(s)
    assert [o.index for o in s2.occasions()] == [0, 1]
    occ = s2.occasions()[0]
    assert occ.covariates.get("wt").interpolate(12.0) == pytest.approx(71.0)
    assert occ.covariates.get("sex").fixed
    obs = occ.observations()
    assert obs[1].errorpoly == (0.1, 0.05, 0.0, 0.0)
    assert obs[2].censoring is pt.Censor.BLOQ and obs[3].value is None
    assert occ.infusions()[0].duration == 0.5


def test_error_models_round_trip_and_match_jax():
    ems = (pt.AssayErrorModels()
           .add("y0", pt.AssayErrorModel.additive(pt.ErrorPoly(0.1, 0.05, 0.0, 0.0), 1.2))
           .add("y1", pt.AssayErrorModel.proportional_fixed(pt.ErrorPoly(0.0, 0.1), 2.0))
           .add("y2", pt.AssayErrorModel.none()))
    ems2 = pt.from_json(pt.to_json(ems))
    assert ems2.content_hash() == ems.content_hash()
    assert ems2.get("y1").factor_param.fixed and ems2.get("y2").is_none()
    jems = pst.from_json(pt.to_json(ems))
    assert convert.error_models_from_reference(jems).content_hash() == ems.content_hash()
    rems = (pt.ResidualErrorModels().add("y0", pt.ResidualErrorModel.combined(0.1, 0.2))
            .add("y1", pt.ResidualErrorModel.exponential(0.3)))
    text = pt.to_json(rems)
    jrems = pst.from_json(text)
    assert pst.to_json(jrems) == text
    back = convert.residual_error_models_from_reference(jrems)
    assert back.get("y0") == rems.get("y0") and back.get("y1") == rems.get("y1")
    assert pt.from_json(text).get("y0") == rems.get("y0")


def test_unsupported_roots_and_schemas_raise():
    """A schema mismatch and an unknown root raise PharmsolError; the NCA
    result's schema is a supported root since the port has its NCA layer
    (an empty one loads as the JAX package loads it)."""
    with pytest.raises(PharmsolError, match="schema"):
        pt.from_json(json.dumps({"schema": "pharmsol-nca-result-v1-bogus"}))
    with pytest.raises(PharmsolError, match="schema"):
        pt.from_json(json.dumps({"schema": "bogus-v9"}))
    empty = json.dumps({"schema": "pharmsol-nca-result-v1"})
    assert pt.to_json(pt.from_json(empty)) == pst.to_json(pst.from_json(empty))
    with pytest.raises(PharmsolError, match="cannot serialize"):
        pt.to_json(object())
    with pytest.raises(PharmsolError, match="schema mismatch"):
        serde.data_from_dict({"schema": "pharmsol-error-models-v1"})


# -- AUC helpers --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_auc_helpers_match_jax(seed):
    """Random decaying profiles with a peak: every method of auc, aumc,
    auc_interval (boundaries inside and on knots), auc_segment and
    interpolate_linear, equal to the JAX package's."""
    rng = np.random.RandomState(seed)
    t = np.cumsum(rng.uniform(0.2, 3.0, 9)) - 0.2
    c = np.abs(10 * np.exp(-0.2 * t) * (1 - np.exp(-1.5 * t)) + 0.3 * rng.randn(9))
    c[rng.randint(9)] = 0.0
    for m in AUCMethod:
        jm = pst.AUCMethod(m.value)
        assert auc.auc(t, c, m) == jax_auc.auc(t, c, jm)
        assert auc.aumc(t, c, m) == jax_auc.aumc(t, c, jm)
        for a, b in ((t[1], t[5]), (0.5 * (t[0] + t[1]), 0.3 * t[-1] + 0.7 * t[-2]),
                     (t[0] - 1.0, t[-1] + 1.0)):
            assert auc.auc_interval(t, c, a, b, m) == jax_auc.auc_interval(t, c, a, b, jm)
        for i in range(8):
            assert auc.auc_segment(t[i], c[i], t[i + 1], c[i + 1], m) == \
                jax_auc.auc_segment(t[i], c[i], t[i + 1], c[i + 1], jm)
    for x in np.linspace(t[0] - 1.0, t[-1] + 1.0, 17):
        assert auc.interpolate_linear(t, c, x) == jax_auc.interpolate_linear(t, c, x)


def test_auc_doc_examples_and_errors():
    assert abs(auc.auc([0.0, 1.0, 2.0, 4.0], [0.0, 10.0, 8.0, 4.0]) - 26.0) < 1e-10
    got = auc.auc([0.0, 2.0], [10.0, 5.0], AUCMethod.LIN_UP_LOG_DOWN)
    assert abs(got - 5.0 * 2.0 / math.log(2.0)) < 1e-12
    t1, c1, t2, c2 = 1.0, 10.0, 3.0, 4.0
    k = math.log(c1 / c2) / (t2 - t1)
    want = (t1 * c1 - t2 * c2) / k + (c1 - c2) / (k * k)
    assert abs(auc.aumc([t1, t2], [c1, c2], AUCMethod.LIN_UP_LOG_DOWN) - want) < 1e-12
    got = auc.auc([0.0, 2.0, 4.0], [2.0, 10.0, 5.0], AUCMethod.LIN_LOG)
    assert abs(got - (12.0 + 10.0 / math.log(2.0))) < 1e-12
    for bad in (lambda: auc.auc([0.0, 1.0], [1.0]), lambda: auc.auc([0.0], [1.0]),
                lambda: auc.auc([0.0, 0.0], [1.0, 2.0]),
                lambda: auc.auc_interval([0.0, 1.0], [1.0, 2.0], 1.0, 0.5),
                lambda: auc.auc_segment(1.0, 1.0, 1.0, 2.0)):
        with pytest.raises(ObservationError):
            bad()
    assert issubclass(ObservationError, DataError)


# -- host helpers: the progress tracker and the LRU cache ------------------------


def test_progress_and_cache_helpers_match_jax():
    """``likelihood/progress.py`` and ``utils/cache.py`` against the JAX
    package's: the duration format, the tracker's printed counts (its ETA
    depends on the clock) and the cache's eviction order."""
    from pharmsol_tpu.likelihood import progress as jax_progress
    from pharmsol_tpu.utils import cache as jax_cache

    from pharmsol_tpu_torch.likelihood.progress import ProgressTracker, format_duration
    from pharmsol_tpu_torch.utils.cache import DEFAULT_CACHE_SIZE, LruCache

    for sec in (0.0, 59.9, 61.0, 3599.0, 3600.0, 86399.5, 90061.0):
        assert format_duration(sec) == jax_progress.format_duration(sec)
    lines = []
    for tracker_cls in (ProgressTracker, jax_progress.ProgressTracker):
        buf = io.StringIO()
        tracker = tracker_cls(40, stream=buf)
        for _ in range(40):
            tracker.inc()
        tracker.finish()
        assert tracker.count == 40
        lines.append([part.split(" ETA")[0] for part in buf.getvalue().split("\r") if part])
    assert lines[0] == lines[1] and len(lines[0]) == 20
    assert DEFAULT_CACHE_SIZE == jax_cache.DEFAULT_CACHE_SIZE
    caches = (LruCache(3), jax_cache.LruCache(3))
    for c in caches:
        for k in "abcd":
            c.insert(k, k.upper())
        c.get("b")
        c.insert("e", "E")
    assert [[c.get(k) for k in "abcde"] for c in caches] == [[None, "B", None, "D", "E"]] * 2
    assert caches[0].entry_count() == caches[1].entry_count() == 3
