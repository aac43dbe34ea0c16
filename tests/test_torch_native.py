"""The port's native host library (``pharmsol_tpu_torch/native``): the C++
columnar Pmetrics parser, a copy of the JAX package's
``native/src/pharmsol_native.cpp`` built with g++ into the ignored
``pharmsol_tpu_torch/_build/``.

The cases of the JAX package's ``tests/test_native.py`` on the port (its
speed case only prints, as there), and the port's native reader held
against the JAX package's on the same CSV: the same subjects, occasions,
events, covariates and values. These run on the host.
"""

import io
import time

import pytest

from pharmsol_tpu.native import read_pmetrics_native as jax_read_native

from pharmsol_tpu_torch.data.pmetrics import read_pmetrics, write_pmetrics
from pharmsol_tpu_torch.native import native_available, read_pmetrics_native
from pharmsol_tpu_torch.native import loader

CSV = """ID,EVID,TIME,DUR,DOSE,ADDL,II,INPUT,OUT,OUTEQ,C0,C1,C2,C3,WT,AGE!
1,1,0,0,600,2,12,or1,.,.,.,.,.,.,70.0,35
1,0,9,.,.,.,.,.,100,cp,0.1,0.05,0,0,70.0,35
1,0,24,.,.,.,.,.,-99,cp,.,.,.,.,72.0,35
2,1,0,2.0,600,.,.,iv,.,.,.,.,.,.,65.0,40
2,0,12,.,.,.,.,.,95,cp,.,.,.,.,65.0,40
2,0,14,.,.,.,.,.,80,cp,.,.,.,.,66.0,40
"""


def _events(data):
    """Every subject's occasions as comparable tuples."""
    out = []
    for s in data.subjects():
        for occ in s.occasions():
            evs = tuple((type(e).__name__, e.time, getattr(e, "amount", None),
                         getattr(e, "value", None), str(getattr(e, "input", "")),
                         str(getattr(e, "outeq", "")), getattr(e, "errorpoly", None),
                         getattr(e, "duration", None)) for e in occ.events)
            covs = tuple((n, tuple(occ.covariates.get(n).observations()),
                          occ.covariates.get(n).fixed) for n in occ.covariates.names())
            out.append((s.id, occ.index, evs, covs))
    return out


def test_native_library_builds():
    assert native_available(), "native toolchain expected in this image"
    assert loader.get_library().psn_version()
    built = list(loader.BUILD_DIR.glob("libpharmsol_native_*.so"))
    assert built and loader.BUILD_DIR.name == "_build"
    assert loader.BUILD_DIR.parent.name == "pharmsol_tpu_torch"


def test_native_parser_matches_python():
    py = read_pmetrics(io.StringIO(CSV))
    nat = read_pmetrics_native(CSV)
    assert len(nat) == len(py)
    assert _events(nat) == _events(py)
    for sid in ("1", "2"):
        a = py.get_subject(sid)
        b = nat.get_subject(sid)
        assert len(a.occasions()) == len(b.occasions())
        for occ_a, occ_b in zip(a.occasions(), b.occasions()):
            assert len(occ_a.events) == len(occ_b.events)
            for ea, eb in zip(occ_a.events, occ_b.events):
                assert type(ea) is type(eb)
                assert ea.time == eb.time
            assert occ_a.covariates.names() == occ_b.covariates.names()
            for name in occ_a.covariates.names():
                ca = occ_a.covariates.get(name)
                cb = occ_b.covariates.get(name)
                assert ca.observations() == cb.observations()
                assert ca.fixed == cb.fixed
    # ADDL expanded: subject 1 occasion 0 has 3 boluses
    assert len(nat.get_subject("1").occasions()[0].boluses()) == 3
    # missing OUT=-99 preserved
    obs = nat.get_subject("1").occasions()[0].observations()
    assert obs[1].value is None
    assert obs[0].errorpoly == (0.1, 0.05, 0.0, 0.0)


def test_native_parser_matches_jax_reader():
    assert _events(read_pmetrics_native(CSV)) == _events(jax_read_native(CSV))


def test_native_parser_error_messages():
    with pytest.raises(Exception) as exc:
        read_pmetrics_native("FOO,BAR\n1,2\n")
    assert "ID, TIME, EVID" in str(exc.value)


def test_native_parser_speed_on_large_file():
    rows = ["ID,EVID,TIME,DUR,DOSE,ADDL,II,INPUT,OUT,OUTEQ,C0,C1,C2,C3,WT"]
    for sid in range(500):
        rows.append(f"s{sid},1,0,0,100,.,.,0,.,.,.,.,.,.,70")
        for t in range(10):
            rows.append(f"s{sid},0,{t + 1},.,.,.,.,.,{50 - t},0,.,.,.,.,70")
    text = "\n".join(rows) + "\n"

    t0 = time.perf_counter()
    nat = read_pmetrics_native(text)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = read_pmetrics(io.StringIO(text))
    t_python = time.perf_counter() - t0
    assert len(nat) == len(py) == 500
    assert _events(nat) == _events(py)
    # informational only: the host's clock, no assertion
    print(f"native={t_native:.3f}s python={t_python:.3f}s")


def test_native_roundtrip_through_writer(tmp_path):
    py = read_pmetrics(io.StringIO(CSV))
    path = tmp_path / "rt.csv"
    write_pmetrics(py, str(path))
    nat = read_pmetrics_native(str(path))
    assert _events(nat) == _events(read_pmetrics(str(path)))


def test_native_fallback_without_toolchain(monkeypatch):
    """``PHARMSOL_TPU_NO_NATIVE=1`` takes the Python reader, as in the JAX
    package."""
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_tried", False)
    monkeypatch.setenv("PHARMSOL_TPU_NO_NATIVE", "1")
    assert not native_available()
    assert _events(read_pmetrics_native(CSV)) == _events(read_pmetrics(io.StringIO(CSV)))
