"""The single-subject API of the port against the JAX package (float64, CPU):
the closed form with covariates, seq, lag, fa and init
(``utils/f32_budget.py::feature_case``, buildable in either package; each
subject of the case under its own support point), labels through metadata
and the model accessors, and the single-subject cache. Tolerance: 1e-10
relative. Helpers from ``test_torch_single_subject.py``.
"""

import numpy as np
import pytest
import torch

import pharmsol_tpu as pst

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch.utils import f32_budget as fb

from test_torch_single_subject import closed_models, compare_subject, jax_ems, jax_subject


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


@pytest.mark.parametrize("name", ["segment_tv", "lag_fa", "lag_seq_depth1", "init_rows"])
def test_closed_form_features_match_jax(name):
    """Covariates (time-varying), seq, lag, fa and init on the subjects of
    K1b's case, each under its own support point."""
    jm, jd, sp = fb.feature_case(name, 2, 2, lib=pst)[:3]
    tm = fb.feature_case(name, 2, 2)[0]
    jems = jax_ems()
    for i, js in enumerate(jd.subjects()):
        compare_subject(jm, tm, js, sp[i], jems)


def test_metadata_labels_and_accessors():
    """Labels resolve through metadata: routes by name, outputs by name
    (``Prediction.outeq`` is the dense index); the accessors read the
    metadata, as the JAX package's do."""
    def build(lib):
        md = (lib.metadata.new("oral").parameters(["ka", "ke", "v"])
              .covariates([lib.metadata.CovariateDecl.continuous("wt")])
              .states(["gut", "central"]).outputs(["cp"])
              .route(lib.metadata.Route.bolus("oral").to_state("gut")))
        return lib.Analytical(lib.one_compartment_with_absorption,
                              out=lambda x, p, t, cov: x[1:2] / p[2],
                              nstates=2, ndrugs=1, nout=1).with_metadata(md)

    jm, tm = build(pst), build(pt)
    for m in (jm, tm):
        assert (m.parameter_index("ke"), m.covariate_index("wt"), m.state_index("central"),
                m.parameter_index("nope")) == (1, 0, 1, None)
    bare = pt.Analytical(pt.one_compartment, nstates=1, ndrugs=1, nout=1)
    assert bare.parameter_index("ke") is None and len(bare.assay_error_models()) == 0
    assert [n for n, _ in tm.assay_error_models().items()] == \
        [n for n, _ in jm.assay_error_models().items()]
    js = (pst.Subject.builder("lab").bolus(0.0, 100.0, "oral").covariate("wt", 0.0, 70.0)
          .observation(1.0, 5.0, "cp").observation(4.0, 3.0, "cp").build())
    jems = pst.AssayErrorModels().add(
        "cp", pst.AssayErrorModel.proportional(pst.ErrorPoly(0.1, 0.1), 1.0))
    compare_subject(jm, tm, js, [1.0, 0.2, 10.0], jems)


def test_cache_api_matches_jax():
    """The single-subject cache (cache.rs): a repeated call is a hit (the
    same object), -0.0 and 0.0 share a key, every result is an entry, a
    capacity bounds the entries, clear_cache and a builder call empty it,
    disable_cache turns it off. The port's key also holds the device and
    the dtype, so a float32 call does not read a float64 result."""
    js = jax_subject()
    ps = convert.data_from_reference([js]).subjects()[0]
    jems = jax_ems()
    tems = convert.error_models_from_reference(jems)
    jm, tm, _ = closed_models("one_compartment")
    for m, s, ems in ((jm, js, jems), (tm, ps, tems)):
        a = m.estimate_predictions(s, [0.2, 11.0])
        assert m.estimate_predictions(s, [0.2, 11.0]) is a
        m.estimate_log_likelihood(s, [0.2, 11.0], ems)
        assert m._pred_cache.entry_count() == 2
        m.estimate_predictions(s, [0.2, -0.0 + 11.0])
        assert m._pred_cache.entry_count() == 2
        m.clear_cache()
        assert m._pred_cache.entry_count() == 0
        m.with_cache_capacity(1)
        m.estimate_predictions(s, [0.2, 11.0])
        m.estimate_predictions(s, [0.3, 11.0])
        assert m._pred_cache.entry_count() == 1
        m.with_nstates(1)
        assert m._pred_cache.entry_count() == 0
        m.disable_cache()
        assert m._pred_cache is None
        assert m.estimate_predictions(s, [0.2, 11.0]) is not m.estimate_predictions(s, [0.2, 11.0])
        m.enable_cache()
        assert m._pred_cache.capacity == 100_000
    p64 = tm.estimate_predictions(ps, [0.2, 11.0])
    pt.set_float_dtype(torch.float32)
    try:
        p32 = tm.estimate_predictions(ps, [0.2, 11.0])
    finally:
        pt.set_float_dtype(torch.float64)
    assert p32 is not p64 and tm._pred_cache.entry_count() == 2
    np.testing.assert_allclose(p32.flat_predictions(), p64.flat_predictions(), rtol=1e-5)
