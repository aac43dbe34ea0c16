"""The port's nonparametric adaptive-grid population fit
(``pharmsol_tpu_torch/optimize/npag.py``).

The cases of the JAX package's ``tests/test_npag.py`` on the port (the
sharded one becomes "a mesh raises": the multi-device split is not ported),
then the same small fit in both packages from the same numpy draws, float64
on the CPU: JAX ``engine='xla'`` against the port's ``engine='general'`` give
the same cycles and support count, support and weights within 1e-6 and the
log-likelihood within 1e-8 relative; ``engine='fused'`` runs the same fit on
the closed-form kernel's plain twin.
"""

import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import fit_population as jax_fit
from pharmsol_tpu.optimize.npag import _halton as jax_halton

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.optimize import PopulationResult, fit_population
from pharmsol_tpu_torch.optimize.npag import _halton, _solve_weights
from pharmsol_tpu_torch.utils.profiling import reset_stages, stage_counts


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


# bimodal 1-cmt IV population: a fast-eliminator and a slow-eliminator
# cluster, the case nonparametric estimation exists for
KE_MODES = (0.12, 0.45)
V_TRUE = 10.0
RANGES = [(0.05, 0.8), (5.0, 20.0)]


def _model(lib=pt):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _population(n_per_mode=6, noise=0.02, seed=1, input_label=0, out_label=0, lib=pt):
    rng = np.random.default_rng(seed)
    subjects = []
    for m, ke_mode in enumerate(KE_MODES):
        for i in range(n_per_mode):
            ke = ke_mode * (1 + 0.05 * rng.standard_normal())
            sb = lib.Subject.builder(f"m{m}s{i}").bolus(0.0, 100.0, input_label)
            for t in (1.0, 3.0, 6.0, 12.0, 24.0):
                c = 100.0 * np.exp(-ke * t) / V_TRUE
                sb = sb.observation(float(t), float(c * (1 + noise * rng.standard_normal())),
                                    out_label)
            subjects.append(sb.build())
    return lib.Data(subjects)


def _ems(out_label=0, lib=pt):
    return lib.AssayErrorModels().add(
        out_label, lib.AssayErrorModel.proportional(lib.ErrorPoly(0.0, 0.05), 1.0))


def test_halton_fills_unit_cube():
    h = _halton(256, 3)
    assert h.shape == (256, 3)
    assert np.all((h > 0) & (h < 1))
    # low-discrepancy: every octant of the cube gets points
    for d in range(3):
        assert np.sum(h[:, d] < 0.5) > 90
    np.testing.assert_array_equal(h, jax_halton(256, 3))
    with pytest.raises(PharmsolError, match="dims"):
        _halton(4, 17)


def test_solve_weights_matches_analytic_two_point():
    # two support points, psi known: NPML weights solve a 1-D problem with
    # an interior optimum that brute force verifies
    psi = np.array([[1.0, 0.2], [0.3, 1.0], [0.9, 0.4], [0.2, 0.8]])
    lam, pyl, ll = _solve_weights(psi)
    grid = np.linspace(1e-6, 1 - 1e-6, 20001)
    lls = np.sum(np.log(np.outer(psi[:, 0], grid) + np.outer(psi[:, 1], 1 - grid)), axis=0)
    best = grid[np.argmax(lls)]
    assert abs(lam[0] - best) < 1e-4
    assert abs(ll - lls.max()) < 1e-8
    # gradient condition: D_j == n on the support
    d = (psi / pyl[:, None]).sum(axis=0)
    assert np.allclose(d, psi.shape[0], atol=1e-6)


def test_fit_population_recovers_bimodal_ke():
    res = fit_population(_model(), _population(), _ems(), RANGES, init_points=64,
                         max_cycles=40)
    assert res.converged
    assert np.isclose(res.weights.sum(), 1.0)
    # optimality: no grid point scores above n (within tolerance)
    assert res.d_max < 1e-3 * res.posterior.shape[0]
    # the fitted mixture is bimodal in ke: mass near both modes
    ke, w = res.support[:, 0], res.weights
    for mode in KE_MODES:
        near = np.abs(ke - mode) / mode < 0.15
        assert w[near].sum() > 0.25, (mode, res.summary())
    # v is unimodal at the truth
    v_mean = float(res.weights @ res.support[:, 1])
    assert abs(v_mean - V_TRUE) / V_TRUE < 0.1
    # posterior classification: subjects built from mode 0 put most
    # posterior mass on low-ke points
    post_ke = res.individual_posterior_means()[:, 0]
    assert np.all(post_ke[:6] < 0.3) and np.all(post_ke[6:] > 0.3)
    assert "support points" in res.summary()


def _named_model(lib):
    md = (lib.metadata.new("m").parameters(["ke", "v"]).states(["central"])
          .outputs(["cp"]).routes([lib.Route.bolus("iv").to_state("central")]))
    return _model(lib).with_metadata(md)


def test_fit_population_named_ranges_and_refine():
    named = {"v": (5.0, 20.0), "ke": (0.05, 0.8)}
    kw = dict(init_points=48, max_cycles=25, refine="nm")
    res = fit_population(_named_model(pt),
                         _population(n_per_mode=4, input_label="iv", out_label="cp"),
                         _ems("cp"), named, **kw)
    assert res.parameter_names == ("ke", "v")
    assert res.log_likelihood > -np.inf
    assert res.support.shape[1] == 2
    assert "ke: mean" in res.summary()
    # the Nelder-Mead polish walks the same path in the JAX package
    want = jax_fit(_named_model(pst),
                   _population(n_per_mode=4, input_label="iv", out_label="cp", lib=pst),
                   _ems("cp", pst), named, engine="xla", **kw)
    assert res.support.shape == want.support.shape and res.cycles == want.cycles
    np.testing.assert_allclose(res.support, want.support, rtol=1e-6)
    np.testing.assert_allclose(res.weights, want.weights, atol=1e-6)
    assert abs(res.log_likelihood - want.log_likelihood) <= 1e-8 * abs(want.log_likelihood)
    with pytest.raises(PharmsolError, match="cover the model parameters"):
        fit_population(_named_model(pt), _population(1, input_label="iv", out_label="cp"),
                       _ems("cp"), {"ke": (0.05, 0.8)}, init_points=8)


def test_fit_population_a_mesh_raises():
    with pytest.raises(PharmsolError, match="Queue 1 item 14"):
        fit_population(_model(), _population(1), _ems(), RANGES, init_points=8,
                       mesh=object())


def test_fit_population_validates_inputs():
    with pytest.raises(PharmsolError, match="hi > lo"):
        fit_population(_model(), _population(1), _ems(), [(0.5, 0.1), (5.0, 20.0)],
                       init_points=8)
    with pytest.raises(PharmsolError, match="metadata"):
        fit_population(_model(), _population(1), _ems(),
                       {"ke": (0.1, 0.5), "v": (5.0, 20.0)}, init_points=8)
    with pytest.raises(PharmsolError, match="refine"):
        fit_population(_model(), _population(1), _ems(), RANGES, init_points=8,
                       max_cycles=1, refine="bogus")
    with pytest.raises(PharmsolError, match=r"\[\(lo, hi\), \.\.\.\]"):
        fit_population(_model(), _population(1), _ems(), [0.1, 0.5], init_points=8)


def test_fit_population_every_subject_lost_raises():
    # ranges far from the data: every grid point is -inf for every subject
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(1e-200, 0.0), 0.0))
    with pytest.raises(PharmsolError, match="-inf likelihood at EVERY grid point"):
        fit_population(_model(), _population(1), ems, [(5.0, 9.0), (1e3, 1e4)],
                       init_points=4, max_cycles=1)


# -- the port against the JAX package ----------------------------------------

FIT_KW = dict(init_points=64, max_cycles=12)


@pytest.fixture(scope="module")
def jax_result():
    return jax_fit(_model(pst), _population(lib=pst), _ems(lib=pst), RANGES, engine="xla",
                   **FIT_KW)


@pytest.mark.parametrize("engine", ["general", "fused", "auto"])
def test_fit_matches_the_jax_package(engine, jax_result):
    """The whole deterministic fit: start grid, weights, condensation,
    expansion, delta control. ``fused`` computes psi on the closed-form
    kernel's plain twin (CPU tensors), ``auto`` takes the general engine."""
    got = fit_population(_model(), _population(), _ems(), RANGES, engine=engine, **FIT_KW)
    want = jax_result
    assert isinstance(got, PopulationResult)
    assert (got.cycles, got.converged) == (want.cycles, want.converged)
    assert got.support.shape == want.support.shape
    np.testing.assert_allclose(got.support, want.support, rtol=1e-6)
    np.testing.assert_allclose(got.weights, want.weights, atol=1e-6)
    assert abs(got.log_likelihood - want.log_likelihood) <= 1e-8 * abs(want.log_likelihood)
    np.testing.assert_allclose(got.posterior, want.posterior, atol=1e-6)
    assert abs(got.d_max - want.d_max) <= 1e-6 * len(_population())
    np.testing.assert_allclose(got.population_mean(), want.population_mean(), rtol=1e-6)
    np.testing.assert_allclose(got.population_covariance(), want.population_covariance(),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(got.individual_posterior_means(),
                               want.individual_posterior_means(), rtol=1e-6)
    assert got.summary().splitlines()[1:] == want.summary().splitlines()[1:]


def test_fit_progress_prints_the_jax_lines(capsys):
    kw = dict(init_points=16, max_cycles=3, progress=True)
    fit_population(_model(), _population(3), _ems(), RANGES, **kw)
    got = capsys.readouterr().out.splitlines()
    jax_fit(_model(pst), _population(3, lib=pst), _ems(lib=pst), RANGES, engine="xla", **kw)
    want = capsys.readouterr().out.splitlines()
    assert len(got) == 3 and all(ln.startswith("cycle ") for ln in got)
    for g, w in zip(got, want):
        # "cycle 1: ll=..., (+gain), N pts (+added), delta=..."
        assert g.split(": ")[0] == w.split(": ")[0]
        assert g.split(", ")[1:] == w.split(", ")[1:]
        assert abs(float(g.split("ll=")[1].split(" ")[0])
                   - float(w.split("ll=")[1].split(" ")[0])) <= 1e-5


def test_fit_stages_and_support_width():
    """One psi call per solve plus one per candidate batch, each with
    exactly the support's columns (no padding to a bucket), and every
    weight solve on the host when the fit runs on the CPU."""
    seen = []
    import pharmsol_tpu_torch.optimize.npag as npag

    real = npag.log_likelihood_matrix

    def spy(equation, data, support, ems, **kw):
        seen.append((np.asarray(support).shape[0], kw["device"].type))
        return real(equation, data, support, ems, **kw)

    reset_stages()
    try:
        npag.log_likelihood_matrix = spy
        res = fit_population(_model(), _population(3), _ems(), RANGES, init_points=20,
                             max_cycles=2)
    finally:
        npag.log_likelihood_matrix = real
    stages = stage_counts()
    assert stages["npag/psi_device"][0] == len(seen)
    assert "npag/weights_device" not in stages
    assert seen[0] == (20, "cpu") and seen[-1][0] == res.support.shape[0]
    assert any(n % 64 for n, _ in seen)
    assert stages["npag/weights"][0] <= len(seen)
