"""The port's general SDE engine against the JAX package's ``engine='xla'``.

At zero diffusion every particle follows the deterministic Euler-Maruyama
march, which both engines take step for step with the same controller and
stopping rule, so psi agrees to rounding: within 1e-9 relative, float64 on the
CPU. With noise the two draw different numbers (torch generators against
JAX's threefry), so parity is statistical. Each model's closures are written
once per framework from the same formula; inputs come from numpy seeds.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu import metadata as jax_metadata
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch import metadata as pt_metadata
from pharmsol_tpu_torch.engine import sde as engine_sde
from pharmsol_tpu_torch.errors import PharmsolError


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def _ems(factor=0.5):
    return pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.0, 0.0, 0.0), factor))


def _decay_data():
    """test_pallas_sde.py:46-52: a bolus, an infusion on every other
    subject, three observations."""
    subs = []
    for i in range(5):
        sb = pst.SubjectBuilder(f"s{i}").bolus(0.0, 100.0, 0)
        if i % 2 == 0:
            sb = sb.infusion(0.5, 20.0, 0, 0.5)
        for t in (0.3, 0.8, 1.5):
            sb = sb.observation(t, float(8 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subs.append(sb.build())
    rng = np.random.default_rng(4)
    sp = np.column_stack([rng.uniform(0.2, 0.6, 6), rng.uniform(8, 14, 6)])
    return pst.Data(subs), sp


def _decay(xp, cls, **kw):
    return cls(drift=lambda x, p, t, r, cov: xp.stack([-p[0] * x[0] + r[0]]),
               diffusion=lambda p, t, cov: [0.0 * p[0]],
               out=lambda x, p, t, cov: x[0:1] / p[1],
               nparticles=16, nstates=1, ndrugs=1, nout=1, seed=3, **kw)


def _inject(xp, cls, md_module):
    """test_sde_engine.py:121: the bolus lands in `central` (state 1) through
    an inject-to-destination route."""
    md = (md_module.new("inject").parameters(["ke", "v", "g"])
          .states(["depot", "central"]).outputs(["cp"])
          .route(md_module.Route.bolus("oral").to_state("central")
                 .inject_input_to_destination())
          .particles(4))
    return cls(drift=lambda x, p, t, r, cov: xp.stack([0.0 * x[0], -p[0] * x[1]]),
               diffusion=lambda p, t, cov: [0.0 * p[2], 0.0 * p[2]],
               out=lambda x, p, t, cov: x[1:2] / p[1],
               nparticles=4, nstates=2, ndrugs=1, nout=1).with_metadata(md)


def _readme(xp, cls, **kw):
    """examples/sde_readme.py: a latent mean-reverting elimination rate,
    init sets ke_latent = ke0."""
    return cls(drift=lambda x, p, t, r, cov: xp.stack([-x[1] * x[0], -(x[1] - p[0])]),
               diffusion=lambda p, t, cov: [0.0 * p[2], p[2]],
               init=lambda p, t, cov: [0.0 * p[0], p[0]],
               out=lambda x, p, t, cov: x[0:1] / p[1],
               nstates=2, ndrugs=1, nout=1, **kw)


def _readme_data(n=4, label=0):
    rng = np.random.RandomState(11)
    subs = []
    for i in range(n):
        sb = pst.SubjectBuilder(f"r{i}").bolus(0.0, 100.0, label)
        for t, v in zip((1.0, 2.0, 4.0, 8.0), (8.0, 6.2, 4.1, 1.8)):
            sb = sb.observation(t, float(v * np.exp(0.1 * rng.randn())), label)
        subs.append(sb.build())
    return pst.Data(subs)


def _censored_data():
    """test_pallas_sde.py:377-383: BLOQ and ALOQ observations."""
    subs = []
    for i in range(3):
        sb = (pst.SubjectBuilder(f"c{i}").bolus(0.0, 100.0, 0)
              .observation(0.3, float(8 * np.exp(-0.3 * 0.3) + 0.1 * i), 0)
              .censored_observation(1.5, 0.5, 0, pst.Censor.BLOQ)
              .censored_observation(0.1, 9.0, 0, pst.Censor.ALOQ))
        subs.append(sb.build())
    rng = np.random.default_rng(4)
    sp = np.column_stack([rng.uniform(0.2, 0.6, 4), rng.uniform(8, 14, 4)])
    return pst.Data(subs), sp


def _case(name):
    """(JAX model, port model, data, support, JAX error models) at zero
    diffusion."""
    if name == "bolus_infusion":
        data, sp = _decay_data()
        return _decay(jnp, pst.SDE), _decay(torch, pt.SDE), data, sp, _ems()
    if name == "coupled":
        data, sp = _decay_data()
        return (_decay(jnp, pst.SDE, em_control="coupled"),
                _decay(torch, pt.SDE, em_control="coupled"), data, sp, _ems())
    if name == "censored":
        data, sp = _censored_data()
        return _decay(jnp, pst.SDE), _decay(torch, pt.SDE), data, sp, _ems()
    if name == "inject":
        rng = np.random.default_rng(2)
        subs = [pst.SubjectBuilder(f"i{i}").bolus(0.0, 100.0, "oral")
                .observation(1.0, float(80 + 5 * i), "cp")
                .observation(2.5, float(60 + 5 * i), "cp").build() for i in range(3)]
        sp = np.column_stack([rng.uniform(0.1, 0.4, 5), rng.uniform(0.8, 1.2, 5),
                              np.zeros(5)])
        ems = pst.AssayErrorModels().add(
            "cp", pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.1, 0.0, 0.0), 1.0))
        return (_inject(jnp, pst.SDE, jax_metadata), _inject(torch, pt.SDE, pt_metadata),
                pst.Data(subs), sp, ems)
    assert name == "init"
    rng = np.random.default_rng(6)
    sp = np.abs(np.array([0.2, 10.0, 0.0]) * (1 + 0.1 * rng.standard_normal((5, 3))))
    return (_readme(jnp, pst.SDE, nparticles=8, seed=42),
            _readme(torch, pt.SDE, nparticles=8, seed=42), _readme_data(), sp,
            pst.AssayErrorModels().add(
                0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.3, 0.1, 0.0, 0.0), 0.5)))


def _port_psi(model, data, sp, ems, engine="general"):
    return pt.log_likelihood_matrix(model, convert.data_from_reference(data), sp,
                                    convert.error_models_from_reference(ems),
                                    engine=engine).numpy()


@pytest.mark.parametrize("name", ["bolus_infusion", "inject", "init", "coupled", "censored"])
def test_zero_diffusion_matches_jax_xla(name):
    jm, tm, data, sp, ems = _case(name)
    want = np.asarray(jax_psi(jm, data, sp, ems, engine="xla"))
    got = _port_psi(tm, data, sp, ems)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) < 1e-9


def test_inject_to_destination_dose_lands_in_its_state():
    """Without the route the dose would sit in the inert depot and the
    prediction of `central` would stay 0 (the JAX test's oracle)."""
    _, tm, data, sp, ems = _case("inject")
    assert tm.spec.bolus_dest == (1,)
    got = _port_psi(tm, data, sp, ems)
    plain = pt.SDE(tm._drift, tm._diffusion, out=tm._out, nparticles=4,
                   nstates=2, ndrugs=1, nout=1)
    subjects = [pt.Subject.builder(f"i{i}").bolus(0.0, 100.0, 0)
                .observation(1.0, float(80 + 5 * i), 0)
                .observation(2.5, float(60 + 5 * i), 0).build() for i in range(3)]
    ems0 = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    miss = pt.log_likelihood_matrix(plain, pt.Data(subjects), sp, ems0).numpy()
    assert np.all(got > miss + 20.0)


def _two_state(xp, cls, seed, **kw):
    return cls(drift=lambda x, p, t, r, cov: xp.stack([-x[0] * x[1], -x[1] + p[0]]),
               diffusion=lambda p, t, cov: [1.0 + 0.0 * p[0], 0.01 + 0.0 * p[0]],
               init=lambda p, t, cov: [0.0 * p[0], 1.0 + 0.0 * p[0]],
               out=lambda x, p, t, cov: x[0:1],
               nparticles=400, nstates=2, ndrugs=1, nout=1, seed=seed, **kw)


def _two_state_subject():
    return (pst.Subject.builder("id1").bolus(0.0, 20.0, 0)
            .observation(0.2, 16.6434, 0).observation(0.4, 14.3233, 0)
            .observation(0.6, 9.8468, 0).observation(0.8, 9.4177, 0)
            .observation(1.0, 7.5170, 0).build())


def test_stochastic_statistical_parity_with_jax():
    """test_pallas_sde.py:96-121: four seeds a side, 400 particles; the mean
    particle-filter log-likelihoods agree within 0.6."""
    data = pst.Data([_two_state_subject()])
    ems = _ems(factor=0.0)
    sp = np.array([[1.0]])
    jax_ll = [float(jax_psi(_two_state(jnp, pst.SDE, s), data, sp, ems, engine="xla")[0, 0])
              for s in range(4)]
    port_ll = [float(_port_psi(_two_state(torch, pt.SDE, s), data, sp, ems)[0, 0])
               for s in range(4)]
    assert all(np.isfinite(v) for v in jax_ll + port_ll)
    assert abs(np.mean(jax_ll) - np.mean(port_ll)) < 0.6, (jax_ll, port_ll)


def _noise_case(noise, g):
    """test_sde_engine.py:165-207: supports 0.2 and 0.200001 side by side."""
    model = pt.SDE(drift=lambda x, p, t, r, cov: -p[0] * x[:1],
                   diffusion=lambda p, t, cov: [g + 0.0 * p[0]],
                   out=lambda x, p, t, cov: x[:1] / p[1],
                   nparticles=300, nstates=1, ndrugs=1, nout=1, seed=7).with_noise(noise)
    data = pt.Data([pt.Subject.builder("n1").bolus(0.0, 100.0, 0)
                    .observation(1.0, 4.2, 0).observation(3.0, 2.1, 0).build()])
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    sp = np.array([[0.2, 20.0], [0.200001, 20.0], [0.4, 25.0]])
    return pt.log_likelihood_matrix(model, data, sp, ems).numpy()


def test_noise_modes():
    """Zero diffusion is mode-invariant; common random numbers keep nearly
    equal supports nearly equal, independent draws decorrelate them, and
    both estimate the same likelihood."""
    np.testing.assert_allclose(_noise_case("common", 0.0),
                               _noise_case("independent", 0.0), rtol=1e-12)
    psi_c, psi_i = _noise_case("common", 0.05), _noise_case("independent", 0.05)
    d_common = abs(psi_c[0, 0] - psi_c[0, 1])
    d_indep = abs(psi_i[0, 0] - psi_i[0, 1])
    assert d_common < 1e-3 and d_indep > d_common
    np.testing.assert_allclose(psi_c, psi_i, atol=0.5)


def test_seed_reproduces_and_changes_the_draws():
    data = _readme_data(2)
    sp = np.array([[0.2, 10.0, 0.05], [0.25, 9.0, 0.05]])
    ems = pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.3, 0.1, 0.0, 0.0), 0.5))
    a = _port_psi(_readme(torch, pt.SDE, nparticles=64, seed=1), data, sp, ems)
    b = _port_psi(_readme(torch, pt.SDE, nparticles=64, seed=1), data, sp, ems)
    c = _port_psi(_readme(torch, pt.SDE, nparticles=64, seed=2), data, sp, ems)
    np.testing.assert_array_equal(a, b)
    assert np.all(a != c) and np.all(np.isfinite(c))
    assert np.max(np.abs(a - c)) < 1.0


@pytest.mark.parametrize("scheme", ["stratified", "systematic"])
def test_resampler_counts_follow_the_weights(scheme):
    """Both schemes give each particle k between floor and ceil of
    P w_k +- 1 offspring (test_sde_engine.py:267-295 bounds the mean)."""
    P, reps = 512, 200
    gen = torch.Generator().manual_seed(0)
    w = torch.as_tensor(np.random.RandomState(0).dirichlet(np.ones(P) * 0.3))
    shape = (reps, P) if scheme == "stratified" else (reps, 1)
    U = torch.rand(shape, generator=gen, dtype=torch.float64)
    idx = engine_sde._resample_index(w.expand(reps, P),
                                     engine_sde.resample_positions(U, P).expand(reps, P))
    counts = torch.stack([torch.bincount(r, minlength=P) for r in idx]).double()
    assert int(idx.min()) >= 0 and int(idx.max()) < P
    assert float((counts - P * w).abs().max()) < 2.0
    freq = counts.mean(0) / P
    assert float((freq - w).abs().max()) < 2.0 / P


def test_systematic_resampling_runs_in_the_general_engine():
    data = _readme_data(2)
    sp = np.array([[0.2, 10.0, 0.05]])
    ems = pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.3, 0.1, 0.0, 0.0), 0.5))
    st = _port_psi(_readme(torch, pt.SDE, nparticles=200, seed=5), data, sp, ems)
    sy = _port_psi(_readme(torch, pt.SDE, nparticles=200, seed=5)
                   .with_resampling("systematic"), data, sp, ems)
    assert np.all(np.isfinite(sy)) and np.all(st != sy)
    np.testing.assert_allclose(sy, st, atol=0.5)


def test_runaway_cell_poisons_without_spinning():
    """A finite-time blow-up: the stall guard ends the march, the cloud is
    NaN (test_sde_engine.py:236-264)."""
    X = torch.full((1, 1, 16, 1), 1e18, dtype=torch.float32)
    t0 = torch.zeros((1, 1), dtype=torch.float32)
    start = time.perf_counter()
    out = engine_sde._em_segment(
        lambda X, p, t, r: X * X, lambda p, t: torch.ones((1, 1, 1)), X, None, t0,
        t0 + 10.0, None, lambda: torch.randn((3, 1, 1, 16, 1)), coupled=False)
    assert torch.isnan(out).all()
    assert time.perf_counter() - start < 60.0


def test_options_validate_and_carry_across():
    m = pt.SDE(lambda x, p, t, r, cov: [-p[0] * x[0]], lambda p, t, cov: [p[1]],
               nstates=1, ndrugs=1, nout=1)
    assert (m.nparticles(), m._seed, m._noise, m._resampling, m._em_control) == (
        1000, 0, "common", "stratified", "independent")
    for method, bad in (("with_noise", "bogus"), ("with_resampling", "multinomial"),
                        ("with_em_control", "bogus")):
        with pytest.raises(ValueError):
            getattr(m, method)(bad)
    jm = (pst.SDE(lambda x, p, t, r, cov: jnp.stack([-p[0] * x[0]]),
                  lambda p, t, cov: jnp.stack([p[1]]), nparticles=77, nstates=1,
                  ndrugs=1, nout=1, seed=9)
          .with_noise("independent").with_resampling("systematic")
          .with_em_control("coupled"))
    opts = convert.sde_options_from_reference(jm)
    assert opts == dict(nparticles=77, seed=9, noise="independent",
                        resampling="systematic", em_control="coupled", lag=None, fa=None)
    tm = pt.SDE(lambda x, p, t, r, cov: [-p[0] * x[0]], lambda p, t, cov: [p[1]],
                nstates=1, ndrugs=1, nout=1, **opts)
    assert tm.spec.nparticles == 77 and tm.spec.noise == "independent"


@pytest.mark.parametrize("kw", ["lag", "fa"])
def test_unported_sde_equations_raise(kw):
    """Lag and fa are ported (kernel K3b): the model takes them into its
    spec; a lag/fa vector of the wrong length still raises when lowered."""
    fn = {"lag": lambda p, t, cov: {0: 0.5}, "fa": lambda p, t, cov: {0: 0.8}}[kw]
    m = pt.SDE(lambda x, p, t, r, cov: [-p[0] * x[0]], lambda p, t, cov: [0.0 * p[1]],
               nstates=1, ndrugs=1, nout=1, **{kw: fn})
    assert getattr(m.spec, kw) is fn
    bad = pt.SDE(lambda x, p, t, r, cov: [-p[0] * x[0]], lambda p, t, cov: [0.0 * p[1]],
                 nstates=1, ndrugs=1, nout=1, **{kw: lambda p, t, cov: [0.5, 0.5]})
    data = pt.Data([pt.Subject.builder("a").bolus(0.0, 100.0, 0)
                    .observation(1.0, 8.0, 0).build()])
    ems = pt.AssayErrorModels().add(0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    with pytest.raises(PharmsolError, match="vector of length 1"):
        pt.log_likelihood_matrix(bad, data, np.array([[0.2, 0.1]]), ems, engine="general")


def test_metadata_particle_count_is_taken():
    md = (pt_metadata.new("m").parameters(["ke", "g"]).states(["c"]).outputs(["cp"])
          .route(pt_metadata.Route.bolus("iv").to_state("c")).particles(32))
    m = pt.SDE(lambda x, p, t, r, cov: [-p[0] * x[0]], lambda p, t, cov: [p[1]],
               nparticles=32, nstates=1, ndrugs=1, nout=1).with_metadata(md)
    assert m.nparticles() == 32 and m.spec.bolus_dest == (0,)
    with pytest.raises(Exception, match="particles"):
        pt.SDE(lambda x, p, t, r, cov: [-p[0] * x[0]], lambda p, t, cov: [p[1]],
               nparticles=10, nstates=1, ndrugs=1, nout=1).with_metadata(md)
