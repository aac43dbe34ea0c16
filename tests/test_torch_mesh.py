"""The port's device split (``pharmsol_tpu_torch/parallel/mesh.py``).

The JAX package's sharded psi and sharded batch (``parallel/mesh.py``; its
tests in ``test_pallas_psi.py``, ``test_pallas_ode.py``,
``test_pallas_sde.py``) on the port, float64 on the CPU: meshes of repeated
``cpu`` devices ((8, 1), (4, 2), (1, 1)) in place of the conftest's eight
virtual JAX devices. Each case is held within 1e-10 relative against the
JAX package's ``log_likelihood_matrix_sharded(engine="xla")`` on its
eight-device mesh and its unsharded psi, on the same numpy-seeded inputs;
``fused`` runs each kernel's plain twin shard by shard (the split ODE twin
against the JAX ODE kernel in interpret mode, unsharded). Rows (20) and
supports (37) divide none of the meshes. The feature tiers' split is
``test_torch_mesh_features.py``. The JAX Pallas kernels under
``shard_map`` (interpret mode) are the ``slow`` case.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_batch as jax_batch
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi
from pharmsol_tpu.parallel.mesh import log_likelihood_batch_sharded as jax_batch_sharded
from pharmsol_tpu.parallel.mesh import log_likelihood_matrix_sharded as jax_sharded
from pharmsol_tpu.parallel.mesh import population_mesh as jax_mesh

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.likelihood.matrix import log_likelihood_batch, log_likelihood_matrix
from pharmsol_tpu_torch.parallel import (
    Mesh, log_likelihood_batch_sharded, log_likelihood_matrix_sharded, population_mesh,
)

REL = 1e-10
SHAPES = [(8, 1), (4, 2), (1, 1)]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def cpu_mesh(shape):
    return population_mesh(shape=shape, devices=["cpu"] * (shape[0] * shape[1]))


def close(got, want, rel=REL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1.0)
    assert float(err.max(initial=0.0)) <= rel, float(err.max())


def _ems(lib):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))


def _repeat_subjects(lib, n, seed, covariate=None):
    """A two-dose regimen with 4 observations; subject i has a weight of 55 +
    3 i (and with ``covariate='tv'`` a second knot at 12 h and an infusion)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        b = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0).bolus(6.0, 50.0, 0)
        if covariate is not None:
            b = b.covariate("wt", 0.0, 55.0 + 3.0 * i)
        if covariate == "tv":
            b = b.infusion(2.0, 40.0, 0, 1.0).covariate("wt", 12.0, 60.0 + i)
        for t in (1.0, 4.0, 8.0, 12.0):
            b = b.observation(t, float(abs(4.0 + rng.randn())), 0)
        out.append(b.build())
    return lib.Data(out)


def _two_cmt(lib):
    return lib.Analytical(lib.two_compartments, out=lambda x, p, t, cov: x[0:1] / p[3],
                          nstates=2, ndrugs=1, nout=1)


def _covariate_model(lib, stack):
    def seq(p, t, cov):
        return stack([p[0] * (cov("wt", t) / 70.0) ** 0.75, p[1]])

    return lib.Analytical(lib.one_compartment, seq_eq=seq,
                          out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _support(center, n, seed):
    rng = np.random.RandomState(seed)
    return np.abs(np.asarray(center)[None, :] * (1.0 + 0.2 * rng.randn(n, len(center))))


CASES = {
    # name -> (model(lib, stack), data(lib), support)
    "two_cmt": (lambda lib, st: _two_cmt(lib), lambda lib: _repeat_subjects(lib, 20, 29),
                _support([0.15, 0.3, 0.2, 10.0], 37, 29)),
    "mult": (_covariate_model, lambda lib: _repeat_subjects(lib, 11, 11, "const"),
             _support([0.15, 10.0], 13, 11)),
    "mult_seg": (_covariate_model, lambda lib: _repeat_subjects(lib, 11, 12, "tv"),
                 _support([0.15, 10.0], 13, 12)),
}


@pytest.fixture(scope="module")
def jax_refs():
    """Each case's JAX psi: sharded (xla, eight virtual devices), and for
    ``two_cmt`` also unsharded (the sharded JAX psi of the others is held to
    their unsharded one by the JAX package's own tests)."""
    out = {}
    for name, (model, data, sp) in CASES.items():
        m, d = model(pst, jnp.stack), data(pst)
        out[name] = [jax_sharded(m, d, sp, _ems(pst), mesh=jax_mesh(), engine="xla")]
        if name == "two_cmt":
            out[name].append(jax_psi(m, d, sp, _ems(pst)))
    return out


@pytest.mark.parametrize("engine", ["general", "fused"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_psi_matches_jax(case, shape, engine, jax_refs):
    model, data, sp = CASES[case]
    got = log_likelihood_matrix_sharded(model(pt, torch.stack), data(pt), sp, _ems(pt),
                                        mesh=cpu_mesh(shape), engine=engine)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    for want in jax_refs[case]:
        close(got, want)


def test_sharded_fused_plan_is_split_per_shard(monkeypatch):
    """The fused path builds one plan and launches its kernel once per
    subjects shard, on row blocks of equal size (the last row repeated)."""
    from pharmsol_tpu_torch.ops import fused_psi

    calls = []
    real = fused_psi.psi_analytical

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(fused_psi, "psi_analytical", spy)
    model, data, sp = CASES["two_cmt"]
    log_likelihood_matrix_sharded(model(pt, torch.stack), data(pt), sp, _ems(pt),
                                  mesh=cpu_mesh((8, 1)), engine="fused")
    assert calls == [3] * 8  # 20 rows -> 8 blocks of 3 (4 padding rows)
    calls.clear()
    log_likelihood_matrix_sharded(model(pt, torch.stack), data(pt), sp, _ems(pt),
                                  mesh=cpu_mesh((4, 2)), engine="fused")
    assert calls == [5] * 4  # the support is shared: one launch per subjects shard


def test_sharded_validates_like_unsharded():
    """The split path shares the fused plan's validation (JAX
    ``test_pallas_psi.py:407``), and refuses what the unsharded call refuses."""
    s = (pt.Subject.builder("s").bolus(0.0, 100.0, 0).covariate("wt", 0.0, 70.0)
         .observation(1.0, 5.0, 0).build())
    model = pt.Analytical(pt.two_compartments, out=lambda x, p, t, cov: (x[0:1] ** 2) / p[3],
                          nstates=2, ndrugs=1, nout=1)
    mesh = cpu_mesh((2, 1))
    with pytest.raises(PharmsolError, match="linear output"):
        log_likelihood_matrix_sharded(model, pt.Data([s]), np.ones((4, 4)), _ems(pt),
                                      mesh=mesh, engine="fused")
    with pytest.raises(PharmsolError, match="unknown psi engine"):
        log_likelihood_matrix_sharded(model, pt.Data([s]), np.ones((4, 4)), _ems(pt),
                                      mesh=mesh, engine="xla")
    with pytest.raises(PharmsolError, match="2D"):
        log_likelihood_matrix_sharded(model, pt.Data([s]), np.ones(4), _ems(pt), mesh=mesh)
    with pytest.raises(PharmsolError, match="does not hold"):
        population_mesh(shape=(3, 1), devices=["cpu"] * 2)
    with pytest.raises(PharmsolError, match="is_available"):
        population_mesh(devices=["cuda:0"])


def test_row_split_fails_closed():
    """A launch tensor without a declared row axis, or with a row axis that
    does not hold R rows, raises instead of reaching every shard whole."""
    from pharmsol_tpu_torch.likelihood.matrix import _fused_plan

    model, data, sp = CASES["two_cmt"]
    model, data = model(pt, torch.stack), data(pt)
    grid = model.lower(data.subjects())
    lowered = _ems(pt).lower(model.resolve_output_label, model.nouteqs())
    plan = _fused_plan(model, grid, sp, lowered, torch.device("cpu"), torch.float64)
    fn, args, kwargs, axes = plan.launch_spec()
    rows = torch.arange(plan.R)
    np.testing.assert_array_equal(plan.run_block(rows, "cpu").numpy(), plan.run_rows().numpy())
    plan.launch_spec = lambda: (fn, args, kwargs, {k: v for k, v in axes.items() if k != 0})
    with pytest.raises(PharmsolError, match="declares no row axis"):
        plan.run_block(rows, "cpu")
    plan.launch_spec = lambda: (fn, args, kwargs, dict(axes, out_coef=0))
    with pytest.raises(PharmsolError, match="no 20 rows on its axis 0"):
        plan.run_block(rows, "cpu")


def test_mesh_axes_are_read_by_position():
    """Axis names are free: the first axis holds the subjects, the second
    the support."""
    mesh = population_mesh(shape=(4, 2), devices=["cpu"] * 8, axis_names=("rows", "points"))
    assert (mesh.subjects_axis, mesh.support_axis) == ("rows", "points")
    model, data, sp = CASES["two_cmt"]
    want = log_likelihood_matrix_sharded(model(pt, torch.stack), data(pt), sp, _ems(pt),
                                         mesh=cpu_mesh((4, 2)))
    for engine in ("general", "fused"):
        got = log_likelihood_matrix_sharded(model(pt, torch.stack), data(pt), sp, _ems(pt),
                                            mesh=mesh, engine=engine)
        close(got, want, 1e-12)


def test_population_mesh_may_repeat_a_device():
    mesh = cpu_mesh((4, 2))
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"subjects": 4, "support": 2}
    assert mesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def _ode(lib, stack):
    def rhs(x, p, t, b, rateiv, cov):
        return stack([-p[0] * x[0] + b[0], p[0] * x[0] - p[1] * x[1] + rateiv[0]])

    return lib.ODE(rhs, out=lambda x, p, t, cov: x[1:2] / p[2], nstates=2, ndrugs=1, nout=1)


def test_sharded_ode_matches_jax():
    """dopri5: the general engine against JAX xla unsharded, the split
    fused twin (K2a) against the whole one and the JAX kernel."""
    def data(lib):
        rng = np.random.RandomState(5)
        out = []
        for i in range(5):
            b = lib.Subject.builder(f"o{i}").bolus(0.0, 100.0, 0)
            if i % 2:
                b = b.infusion(2.0, 50.0, 0, 1.0)
            for t in (0.5, 2.0, 6.0):
                b = b.observation(t, float(abs(3.0 + rng.randn())), 0)
            out.append(b.build())
        return lib.Data(out)

    sp = _support([1.2, 0.2, 10.0], 3, 5)
    want = jax_psi(_ode(pst, jnp.stack), data(pst), sp, _ems(pst))
    want_kernel = jax_psi(_ode(pst, jnp.stack), data(pst), sp, _ems(pst), engine="pallas")
    fused = log_likelihood_matrix(_ode(pt, torch.stack), data(pt), sp, _ems(pt),
                                  engine="fused", device="cpu")
    for shape in ((4, 1), (2, 2)):
        mesh = cpu_mesh(shape)
        close(log_likelihood_matrix_sharded(_ode(pt, torch.stack), data(pt), sp, _ems(pt),
                                            mesh=mesh, engine="general"), want)
        # the fused march (dense output across observation-only breakpoints)
        # differs from the segment march within the solver's tolerance: the
        # split twin is held to the whole twin and to the JAX kernel
        got = log_likelihood_matrix_sharded(_ode(pt, torch.stack), data(pt), sp, _ems(pt),
                                            mesh=mesh, engine="fused")
        close(got, fused, 1e-12)
        close(got, want_kernel)


def _sde(lib, stack):
    return lib.SDE(
        drift=lambda x, p, t, rateiv, cov: stack([-p[0] * x[0] + rateiv[0]]),
        diffusion=lambda p, t, cov: stack([p[0] * 0.0]),
        out=lambda x, p, t, cov: x[0:1] / p[1],
        nparticles=16, nstates=1, ndrugs=1, nout=1, seed=3)


def test_sharded_sde_zero_diffusion_matches_unsharded():
    """At zero diffusion the filter is deterministic: the shards' other
    Philox counters are never consulted, so the split psi equals the
    unsharded fused twin's and JAX's (JAX ``test_pallas_sde.py:61``)."""
    def data(lib):
        out = []
        for i in range(10):
            b = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, 0)
            for t in (0.3, 0.8, 1.5):
                b = b.observation(t, float(8 * np.exp(-0.3 * t) + 0.1 * i), 0)
            out.append(b.build())
        return lib.Data(out)

    rng = np.random.default_rng(11)
    sp = np.column_stack([rng.uniform(0.2, 0.6, 6), rng.uniform(8, 14, 6)])
    want = log_likelihood_matrix(_sde(pt, torch.stack), data(pt), sp, _ems(pt),
                                 engine="fused", device="cpu")
    got = log_likelihood_matrix_sharded(_sde(pt, torch.stack), data(pt), sp, _ems(pt),
                                        mesh=cpu_mesh((8, 1)), engine="fused")
    assert got.shape == (10, 6)
    close(got, want, 1e-12)
    close(got, jax_psi(_sde(pst, jnp.stack), data(pst), sp, _ems(pst)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_batch_matches_jax(shape):
    def rems(lib):
        return lib.ResidualErrorModels().add(0, lib.ResidualErrorModel.combined(0.3, 0.1))

    rng = np.random.RandomState(3)
    params = np.abs(np.array([0.15, 10.0])[None] * (1 + 0.2 * rng.randn(11, 2)))
    m_pt, d_pt = _covariate_model(pt, torch.stack), _repeat_subjects(pt, 11, 11, "tv")
    m_j, d_j = _covariate_model(pst, jnp.stack), _repeat_subjects(pst, 11, 11, "tv")
    got = log_likelihood_batch_sharded(m_pt, d_pt, params, rems(pt), mesh=cpu_mesh(shape))
    close(got, log_likelihood_batch(m_pt, d_pt, params, rems(pt), device="cpu"), 1e-12)
    close(got, jax_batch_sharded(m_j, d_j, params, rems(pst), mesh=jax_mesh()))
    close(got, jax_batch(m_j, d_j, params, rems(pst)))
    with pytest.raises(PharmsolError, match="rows but"):
        log_likelihood_batch_sharded(m_pt, d_pt, params[:3], rems(pt), mesh=cpu_mesh(shape))


@pytest.mark.slow
@pytest.mark.parametrize("case", ["mult", "mult_seg"])
def test_sharded_fused_matches_jax_pallas_shard_map(case):
    """The JAX Pallas kernel under ``shard_map`` (interpret mode) on a (4, 2)
    mesh, against the port's split twin."""
    model, data, sp = CASES[case]
    want = jax_sharded(model(pst, jnp.stack), data(pst), sp, _ems(pst),
                       mesh=jax_mesh(shape=(4, 2)), engine="pallas")
    got = log_likelihood_matrix_sharded(model(pt, torch.stack), data(pt), sp, _ems(pt),
                                        mesh=cpu_mesh((4, 2)), engine="fused")
    close(got, want)
