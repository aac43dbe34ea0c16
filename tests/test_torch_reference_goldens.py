"""The reference golden corpus over the port's single-subject API.

The 16 dosing scenarios of ``tests/test_reference_goldens.py`` (the
reference's ode_optimizations.rs and numerical_stability.rs configurations),
run through ``estimate_predictions`` of the port's Analytical and ODE models
(float64, on the CPU), with the JAX package's two gates:

1. ODE against analytical at the reference's REL 1e-2 / ABS 1e-6
   (ode_optimizations.rs:14-15);
2. analytical against the committed ``tests/goldens/reference_scenarios.json``
   (the JAX package's pinned values) at rtol 1e-9 / atol 1e-12.

Plus the likelihood parity between the two engines and the time-varying
covariate ODE (``tests/test_reference_goldens.py:215-257``). The scenarios'
events and parameters are imported from the JAX package's test module, so
both suites hold the same cases; the goldens file is only read.
"""

import json

import numpy as np
import pytest
import torch

import pharmsol_tpu_torch as pt

from test_reference_goldens import GOLDEN_PATH, SCENARIOS, ABS_TOL, REL_TOL


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def one_cmt_pair():
    analytical = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[:1] / p[1],
                               nstates=1, ndrugs=1, nout=1)
    ode = pt.ODE(lambda x, p, t, b, rateiv, cov: torch.stack([-p[0] * x[0] + b[0] + rateiv[0]]),
                 out=lambda x, p, t, cov: x[:1] / p[1], nstates=1, ndrugs=1, nout=1)
    return analytical, ode


def absorption_pair():
    analytical = pt.Analytical(pt.one_compartment_with_absorption,
                               out=lambda x, p, t, cov: x[1:2] / p[2],
                               nstates=2, ndrugs=2, nout=1)
    # bolus input 0 -> gut, bolus input 1 -> central ("load"); the kernel
    # infuses central through rateiv[0]
    ode = pt.ODE(lambda x, p, t, b, rateiv, cov: torch.stack([
        -p[0] * x[0] + b[0],
        p[0] * x[0] - p[1] * x[1] + b[1] + rateiv[0],
    ]), out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=2, nout=1)
    return analytical, ode


def two_cmt_pair():
    analytical = pt.Analytical(pt.two_compartments, out=lambda x, p, t, cov: x[:1] / p[3],
                               nstates=2, ndrugs=1, nout=1)
    ode = pt.ODE(lambda x, p, t, b, rateiv, cov: torch.stack([
        rateiv[0] - p[0] * x[0] - p[1] * x[0] + p[2] * x[1] + b[0],
        p[1] * x[0] - p[2] * x[1],
    ]), out=lambda x, p, t, cov: x[:1] / p[3], nstates=2, ndrugs=1, nout=1)
    return analytical, ode


PAIRS = {"one_cmt_pair": one_cmt_pair, "absorption_pair": absorption_pair,
         "two_cmt_pair": two_cmt_pair}
# (name, the port's model pair, events, params)
CASES = [(name, PAIRS[pair.__name__], events, params)
         for name, pair, events, params in SCENARIOS]


def build_subject(sid, events):
    b = pt.Subject.builder(sid)
    for ev in events:
        if ev[0] == "bolus":
            b = b.bolus(ev[1], ev[2], ev[3])
        elif ev[0] == "infusion":
            b = b.infusion(ev[1], ev[2], ev[3], ev[4])
        elif ev[0] == "obs":
            b = b.observation(ev[1], ev[2] if len(ev) > 2 else 0.0, 0)
    return b.build()


def test_every_scenario_is_ported():
    assert len(CASES) == 16
    with open(GOLDEN_PATH) as f:
        assert sorted(json.load(f)) == sorted(c[0] for c in CASES)


@pytest.mark.parametrize("name,pair,events,params", CASES, ids=[c[0] for c in CASES])
def test_ode_matches_analytical(name, pair, events, params):
    """Reference gate 1: ODE against analytical at REL 1e-2 / ABS 1e-6."""
    analytical, ode = pair()
    subject = build_subject(name, events)
    want = np.asarray(analytical.estimate_predictions(subject, params).flat_predictions())
    got = np.asarray(ode.estimate_predictions(subject, params).flat_predictions())
    assert want.shape == got.shape
    abs_err = np.abs(want - got)
    rel_err = abs_err / np.maximum(np.abs(want), ABS_TOL)
    ok = (abs_err <= ABS_TOL) | (rel_err <= REL_TOL)
    assert ok.all(), f"{name}: {want[~ok]} vs {got[~ok]}"


@pytest.mark.parametrize("name,pair,events,params", CASES, ids=[c[0] for c in CASES])
def test_analytical_matches_committed_golden(name, pair, events, params):
    """Reference gate 2: the pinned analytical values at rtol 1e-9."""
    with open(GOLDEN_PATH) as f:
        want = np.asarray(json.load(f)[name])
    analytical, _ = pair()
    subject = build_subject(name, events)
    got = np.asarray(analytical.estimate_predictions(subject, params).flat_predictions())
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12, err_msg=name)


def test_likelihood_matches_analytical():
    """ode_optimizations.rs:1103: log-likelihood parity between the engines
    within 1e-2 relative, as the JAX package's test holds it."""
    analytical, ode = one_cmt_pair()
    subject = build_subject("ll", [
        ("bolus", 0.0, 100.0, 0),
        ("obs", 1.0, 1.8), ("obs", 2.0, 1.6), ("obs", 4.0, 1.3), ("obs", 8.0, 0.8),
    ])
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.0, 0.1, 0.0, 0.0), 0.0))
    ll_a = analytical.estimate_log_likelihood(subject, [0.1, 50.0], ems)
    ll_o = ode.estimate_log_likelihood(subject, [0.1, 50.0], ems)
    assert np.isfinite(ll_a)
    assert abs(ll_a - ll_o) / max(abs(ll_a), 1e-10) < 1e-2


def test_time_varying_covariates_ode():
    """ode_optimizations.rs:1029: the piecewise covariate ODE is finite,
    positive and declines monotonically."""
    ode = pt.ODE(
        lambda x, p, t, b, rateiv, cov: torch.stack(
            [-(p[0] * (cov("wt", t) / 70.0)) * x[0] + b[0]]),
        out=lambda x, p, t, cov: x[:1] / p[1], nstates=1, ndrugs=1, nout=1)
    subject = (pt.Subject.builder("cov").bolus(0.0, 100.0, 0)
               .covariate("wt", 0.0, 70.0).covariate("wt", 2.0, 75.0)
               .covariate("wt", 6.0, 72.0)
               .observation(1.0, 0.0, 0).observation(2.0, 0.0, 0)
               .observation(4.0, 0.0, 0).observation(6.0, 0.0, 0)
               .observation(8.0, 0.0, 0).build())
    preds = np.asarray(ode.estimate_predictions(subject, [0.1, 50.0]).flat_predictions())
    assert np.all(np.isfinite(preds)) and np.all(preds > 0)
    assert np.all(np.diff(preds) < 0)
