"""The fused SDE path: its Philox noise, its plain twin, its plan.

``psi_sde_plain`` (through ``_FusedSdePsiPlan``) runs the base tier of the
JAX kernel ``ops/pallas_sde.py::psi_sde`` with the kernel's stopping rule, so
at zero diffusion, where the noise never enters, it equals that kernel in
interpret mode to rounding: within 1e-9 relative (one case, the smallest the
JAX kernel's 8 x 128 tile allows). It also equals the port's general engine
there to 1e-9, and agrees with it statistically with noise. The Philox
generator is held against the published Random123 known-answer vectors.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import convert
from pharmsol_tpu_torch import metadata as pt_metadata
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood import matrix
from pharmsol_tpu_torch.likelihood.plans.sde import _FusedSdePsiPlan
from pharmsol_tpu_torch.ops import fused_sde, philox


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


# ---------------------------------------------------------------------------
# Philox4x32-10 and the normals drawn from it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counter, key, words", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answer_vectors(counter, key, words):
    """Random123's kat_vectors for philox4x32_10."""
    got = philox.philox4x32(*counter, key)
    assert " ".join(f"{int(w):08x}" for w in got) == words


def test_philox_broadcasts_and_keys_by_seed():
    part = torch.arange(1000, dtype=torch.int64)
    w = philox.philox4x32(part, 5, torch.arange(3).view(3, 1), 2, philox.seed_key(42))
    assert all(t.shape == (3, 1000) for t in w)
    one = philox.philox4x32(17, 5, 1, 2, philox.seed_key(42))
    assert [int(t[1, 17]) for t in w] == [int(t) for t in one]
    assert philox.seed_key(42) == (42, 0) and philox.seed_key((1 << 40) + 7) == (7, 256)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_normals_have_standard_moments(dtype):
    """2^18 normals: mean, variance, skew and kurtosis of N(0, 1) within
    five standard errors; uniforms in (0, 1]."""
    n_calls = (1 << 18) // philox.normals_per_call(dtype)
    z = torch.cat(philox.normals(dtype, particle=torch.arange(n_calls) % 4096,
                                 segment=3, trial=torch.arange(n_calls) // 4096,
                                 slot=1, group=0, support=7, row=11,
                                 key=philox.seed_key(5))).double()
    n = z.numel()
    assert abs(float(z.mean())) < 5 / math.sqrt(n)
    assert abs(float(z.var()) - 1.0) < 5 * math.sqrt(2.0 / n)
    assert abs(float((z ** 3).mean())) < 5 * math.sqrt(15.0 / n)
    assert abs(float((z ** 4).mean()) - 3.0) < 5 * math.sqrt(96.0 / n)
    u = philox.resample_uniform(dtype, particle=torch.arange(4096), segment=0,
                                support=0, row=0, key=(1, 2))
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0
    assert abs(float(u.double().mean()) - 0.5) < 5 * math.sqrt(1 / 12 / 4096)


def test_uniforms_cover_zero_open_one_closed():
    top = torch.tensor(0xFFFFFFFF, dtype=torch.int64)
    bottom = torch.tensor(0, dtype=torch.int64)
    assert float(philox.uniforms_from_words([top], torch.float32)[0]) == 1.0
    assert float(philox.uniforms_from_words([bottom], torch.float32)[0]) == 2.0 ** -24
    assert float(philox.uniforms_from_words([top, top], torch.float64)[0]) == 1.0
    assert float(philox.uniforms_from_words([bottom, bottom], torch.float64)[0]) == 2.0 ** -53


# ---------------------------------------------------------------------------
# The kernel's reduction order, reproduced by the twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 8, 255, 256, 257, 1000, 4096])
def test_block_order_sums_match_plain_sums(P):
    ppt = fused_sde.particles_per_thread(P)
    assert ppt * fused_sde.THREADS >= P and ppt in fused_sde.PARTICLES_PER_THREAD
    v = torch.as_tensor(np.random.RandomState(P).uniform(0, 1, (3, P)))
    torch.testing.assert_close(fused_sde._block_sum(v, ppt), v.sum(-1), rtol=1e-13, atol=0)
    torch.testing.assert_close(fused_sde._block_cumsum(v, ppt), v.cumsum(-1),
                               rtol=1e-13, atol=0)
    ints = torch.arange(P, dtype=torch.float64).expand(2, P)  # exact in any order
    assert torch.equal(fused_sde._block_cumsum(ints, ppt), ints.cumsum(-1))


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def _ems(factor=0.5):
    return pst.AssayErrorModels().add(
        0, pst.AssayErrorModel.additive(pst.ErrorPoly(0.5, 0.0, 0.0, 0.0), factor))


def _decay(xp, cls, nparticles=8, g=0.0, **kw):
    return cls(drift=lambda x, p, t, r, cov: xp.stack([-p[0] * x[0] + r[0]]),
               diffusion=lambda p, t, cov: [g + 0.0 * p[0]],
               out=lambda x, p, t, cov: x[0:1] / p[1],
               nparticles=nparticles, nstates=1, ndrugs=1, nout=1, seed=3, **kw)


def _decay_data(n=3, S=4):
    subs = []
    for i in range(n):
        sb = pst.SubjectBuilder(f"s{i}").bolus(0.0, 100.0, 0)
        if i % 2 == 0:
            sb = sb.infusion(0.5, 20.0, 0, 0.5)
        for t in (0.3, 0.8, 1.5):
            sb = sb.observation(t, float(8 * np.exp(-0.3 * t) + 0.1 * i), 0)
        subs.append(sb.build())
    rng = np.random.default_rng(4)
    sp = np.column_stack([rng.uniform(0.2, 0.6, S), rng.uniform(8, 14, S)])
    return pst.Data(subs), sp


def test_twin_matches_the_jax_kernel_in_interpret_mode():
    """The one interpret-mode case: zero diffusion, 1 state, 8 particles,
    3 observations (the JAX kernel pads to its 8 x 128 tile)."""
    data, sp = _decay_data()
    want = np.asarray(jax_psi(_decay(jnp, pst.SDE), data, sp, _ems(), engine="pallas"))
    before = fused_sde.LAUNCHES
    got = pt.log_likelihood_matrix(_decay(torch, pt.SDE), convert.data_from_reference(data),
                                   sp, convert.error_models_from_reference(_ems()),
                                   engine="fused").numpy()
    assert fused_sde.LAUNCHES == before  # the twin ran: CPU tensors
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) < 1e-9


def _readme(nparticles=16, sigma_scale=0.0, em_control="independent"):
    md = (pt_metadata.new("ke_diffusion").parameters(["ke0", "v", "sigma_ke"])
          .states(["central", "ke_latent"]).outputs(["cp"])
          .route(pt_metadata.Route.bolus("iv").to_state("central"))
          .particles(nparticles))
    return pt.SDE(lambda x, p, t, r, cov: torch.stack([-x[1] * x[0], -(x[1] - p[0])]),
                  lambda p, t, cov: [0.0, sigma_scale * p[2]],
                  init=lambda p, t, cov: [0.0, p[0]],
                  out=lambda x, p, t, cov: x[0:1] / p[1],
                  nparticles=nparticles, nstates=2, ndrugs=1, nout=1, seed=42,
                  em_control=em_control).with_metadata(md)


def _readme_case(R=5, S=6, seed=3):
    rng = np.random.RandomState(seed)
    subs = []
    for i in range(R):
        b = pt.Subject.builder(f"r{i}").bolus(0.0, 100.0, "iv")
        for t, v in zip((1.0, 2.0, 4.0, 8.0), (8.0, 6.2, 4.1, 1.8)):
            b = b.observation(t, float(v * np.exp(0.15 * rng.randn())), "cp")
        subs.append(b.build())
    sp = np.abs(np.array([0.2, 10.0, 0.05]) * (1 + 0.15 * rng.randn(S, 3)))
    ems = pt.AssayErrorModels().add(
        "cp", pt.AssayErrorModel.additive(pt.ErrorPoly(0.3, 0.1), 0.5))
    return pt.Data(subs), sp, ems


def _two_input(nparticles=16, g=0.0, em_control="coupled"):
    md = (pt_metadata.new("two").parameters(["k1", "k2", "v", "g"])
          .states(["a", "b", "c"]).outputs(["cp", "cb"])
          .route(pt_metadata.Route.bolus("oral").to_state("b").inject_input_to_destination())
          .route(pt_metadata.Route.bolus("iv").to_state("a"))
          .route(pt_metadata.Route.infusion("iv").to_state("a"))
          .particles(nparticles))
    return pt.SDE(lambda x, p, t, r, cov: torch.stack([
                      -p[0] * x[0] + r[1], -p[1] * x[1],
                      p[0] * x[0] + p[1] * x[1] - 0.2 * x[2] + r[0]]),
                  lambda p, t, cov: [0.0, g * p[3], 0.5 * g * p[3]],
                  out=lambda x, p, t, cov: torch.stack([x[2] / p[2], x[1] / p[2] + 0.1 * p[2]]),
                  nparticles=nparticles, nstates=3, ndrugs=2, nout=2, seed=7,
                  em_control=em_control).with_metadata(md)


def _two_input_case(R=4, S=5):
    rng = np.random.RandomState(8)
    subs = []
    for i in range(R):
        b = (pt.Subject.builder(f"c{i}").bolus(0.0, 100.0, "oral")
             .bolus(1.0, 60.0, "iv").infusion(2.0, 40.0, "iv", 1.5))
        for k, t in enumerate((0.5, 1.5, 3.0, 5.0)):
            b = b.observation(t, float(abs(5.0 + rng.randn())), "cp" if k % 2 else "cb")
        b = (b.censored_observation(8.0, 0.5, "cp", pt.Censor.BLOQ)
             .censored_observation(0.25, 9.0, "cp", pt.Censor.ALOQ))
        subs.append(b.build())
    sp = np.column_stack([rng.uniform(0.5, 2.0, S), rng.uniform(0.3, 1.2, S),
                          rng.uniform(8, 14, S), rng.uniform(0.05, 0.3, S)])
    ems = (pt.AssayErrorModels()
           .add("cp", pt.AssayErrorModel.additive(pt.ErrorPoly(0.3, 0.1), 0.5))
           .add("cb", pt.AssayErrorModel.proportional(pt.ErrorPoly(0.0, 0.2), 1.0)))
    return pt.Data(subs), sp, ems


def _plan(model, data, sp, ems, dtype=torch.float64):
    grid = model.lower(data.subjects())
    lowered = ems.lower(model.resolve_output_label, model.nouteqs())
    return _FusedSdePsiPlan(model, grid, sp, lowered, torch.device("cpu"), dtype)


@pytest.mark.parametrize("name", ["readme_init", "two_inputs_censored_coupled",
                                  "two_inputs_independent"])
def test_twin_matches_general_engine_at_zero_diffusion(name):
    """Different stopping rules (the kernel's relative one, the engine's
    absolute one) and the same deterministic march: 1e-9."""
    if name == "readme_init":
        model, (data, sp, ems) = _readme(), _readme_case()
    else:
        em = "coupled" if name.endswith("coupled") else "independent"
        model, (data, sp, ems) = _two_input(em_control=em), _two_input_case()
    plan = _plan(model, data, sp, ems)
    if name.startswith("two"):
        assert plan.dose_states == (1, 1) and plan.rate_inputs == (0,)
        assert plan.out_bias is not None and plan.streams[6] is not None
    else:
        assert plan.init is not None
    got = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    want = pt.log_likelihood_matrix(model, data, sp, ems, engine="general").numpy()
    assert np.isfinite(got).all()
    assert _rel(got, want) < 1e-9


def test_twin_and_general_engine_agree_statistically():
    """With noise (coupled control keeps the march short here): the mean
    per-cell psi difference lies within four standard errors of zero."""
    data, sp, ems = _readme_case(R=6, S=8, seed=9)
    model = _readme(nparticles=200, sigma_scale=4.0, em_control="coupled")
    twin = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    general = pt.log_likelihood_matrix(model.with_noise("independent"), data, sp, ems,
                                       engine="general").numpy()
    d = (twin - general).ravel()
    assert np.isfinite(d).all() and np.abs(d).max() > 0
    assert abs(d.mean()) <= 4 * d.std(ddof=1) / math.sqrt(d.size)


def test_twin_is_reproducible_and_keyed_by_seed():
    data, sp, ems = _readme_case(R=2, S=3)
    model = _readme(nparticles=64, sigma_scale=4.0, em_control="coupled")
    a = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    b = pt.log_likelihood_matrix(model, data, sp, ems, engine="fused").numpy()
    c = pt.log_likelihood_matrix(model.with_seed(43), data, sp, ems, engine="fused").numpy()
    np.testing.assert_array_equal(a, b)
    assert np.all(a != c)


# ---------------------------------------------------------------------------
# What the plan and the wrapper refuse
# ---------------------------------------------------------------------------


def _small():
    data, sp, ems = _readme_case(R=2, S=2)
    return data, sp, ems


@pytest.mark.parametrize("what, match", [
    ("systematic", "stratified"),
    ("nonlinear_out", "linear"),
    ("drift_sin", "`tanh`"),  # a function the generator does not take
    ("diffusion_if", "branches on a traced value"),
    ("particles", "particles"),
])
def test_plan_rejections_raise_and_auto_records_them(what, match, monkeypatch):
    data, sp, ems = _small()
    model = _readme()
    if what == "systematic":
        model = model.with_resampling("systematic")
    elif what == "nonlinear_out":
        model._out = lambda x, p, t, cov: (x[0:1] / p[1]) ** 2
        model._invalidate()
    elif what == "drift_sin":
        model._drift = lambda x, p, t, r, cov: torch.stack([-x[1] * torch.tanh(x[0]),
                                                            -(x[1] - p[0])])
        model._invalidate()
    elif what == "diffusion_if":
        model._diffusion = lambda p, t, cov: [0.0, p[2] if p[2] > 0 else 0.0]
        model._invalidate()
    else:
        model = pt.SDE(model._drift, model._diffusion, init=model._init, out=model._out,
                       nparticles=fused_sde.MAX_PARTICLES + 1, nstates=2, ndrugs=1,
                       nout=1)
        data = pt.Data([pt.Subject.builder("a").bolus(0.0, 100.0, 0)
                        .observation(1.0, 8.0, 0).build()])
        ems = pt.AssayErrorModels().add(
            0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.3, 0.1), 0.5))
    with pytest.raises(PharmsolError, match=match):
        pt.log_likelihood_matrix(model, data, sp, ems, engine="fused")
    monkeypatch.setattr(matrix, "_auto_engine", lambda device: ("fused", "forced"))
    try:
        pt.log_likelihood_matrix(model, data, sp, ems)
    except RuntimeError:
        assert what == "diffusion_if"  # vmap refuses data-dependent control flow too
    decision = pt.last_engine_decision(model)
    assert decision["engine"] == "general"
    assert "fused plan rejected the model" in decision["reason"] and match.strip("`") in \
        decision["reason"]


def test_covariates_raise_in_every_engine():
    """Since kernel K3b the data's covariates no longer raise: a model that
    reads none runs in every engine (fused and general agree at zero
    diffusion), and a drift that reads one the data lacks still raises."""
    model = _readme()
    data = pt.Data([pt.Subject.builder("c").bolus(0.0, 100.0, "iv")
                    .covariate("wt", 0.0, 70.0).observation(1.0, 8.0, "cp").build()])
    _, sp, ems = _small()
    sp = sp.copy()
    sp[:, 2] = 0.0
    psi = {engine: pt.log_likelihood_matrix(model, data, sp, ems, engine=engine)
           for engine in ("auto", "fused", "general")}
    assert all(bool(torch.isfinite(v).all()) for v in psi.values())
    assert _rel(psi["fused"].numpy(), psi["general"].numpy()) < 1e-9
    reads = _readme()
    reads._drift = lambda x, p, t, r, cov: torch.stack(
        [-x[1] * x[0] * cov("crcl", t), -(x[1] - p[0])])
    reads._invalidate()
    with pytest.raises(PharmsolError, match="unknown covariate `crcl`"):
        pt.log_likelihood_matrix(reads, data, sp, ems, engine="fused")


def test_wrapper_validates_its_inputs():
    data, sp, ems = _small()
    plan = _plan(_readme(), data, sp, ems)
    kw = plan.kernel_kwargs()
    with pytest.raises(ValueError, match="support must be"):
        fused_sde.psi_sde(*plan.streams, plan.support[:, :2].contiguous(), plan.gen, **kw)
    with pytest.raises(ValueError, match="em_control"):
        fused_sde.psi_sde(*plan.streams, plan.support, plan.gen, **dict(kw, em_control="x"))
    with pytest.raises(ValueError, match="go together"):
        fused_sde.psi_sde(*plan.streams, plan.support, plan.gen, **dict(kw, init_mask=None))
    with pytest.raises(ValueError, match="particles"):
        fused_sde.psi_sde(*plan.streams, plan.support, plan.gen,
                          **dict(kw, n_particles=fused_sde.MAX_PARTICLES + 1))
    with pytest.raises(ValueError, match="dose_states"):
        fused_sde.psi_sde(*plan.streams, plan.support, plan.gen, **dict(kw, dose_states=(2,)))
    with pytest.raises(ValueError, match="shared memory"):
        fused_sde.check_particle_count(40, 4096, torch.float64)
    assert fused_sde.shared_bytes(2, 1000, torch.float64) == 24_000
