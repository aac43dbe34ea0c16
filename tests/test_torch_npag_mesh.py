"""``fit_population(mesh=...)`` on the port: every psi evaluation of the fit
goes through the device split (``parallel/mesh.py``), as the JAX package's
``tests/test_npag.py::test_fit_population_sharded_matches_unsharded``
(``slow`` there) does on its (4, 2) mesh. Float64 on the CPU, a (4, 2) mesh
of repeated ``cpu`` devices, the same numpy-seeded population in both
packages: the port's split fit is held to the JAX package's fit
(``engine='xla'``, unsharded; its sharded fit on the conftest's eight
virtual devices is the ``slow`` case) and to the port's unsharded fit,
supports within 1e-10 and weights within 1e-8, on the general engine and on
the closed-form kernel's plain twin.
"""

import numpy as np
import pytest

import pharmsol_tpu as pst
from pharmsol_tpu.optimize import fit_population as jax_fit
from pharmsol_tpu.parallel.mesh import population_mesh as jax_mesh

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.optimize import fit_population
from pharmsol_tpu_torch.parallel import population_mesh


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


RANGES = [(0.05, 0.8), (5.0, 20.0)]
FIT_KW = dict(init_points=32, max_cycles=12)


def _model(lib=pt):
    return lib.Analytical(lib.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
                          nstates=1, ndrugs=1, nout=1)


def _population(n_per_mode=3, noise=0.02, seed=1, lib=pt):
    """The JAX test's bimodal 1-cmt IV population (``test_npag.py``)."""
    rng = np.random.default_rng(seed)
    subjects = []
    for m, ke_mode in enumerate((0.12, 0.45)):
        for i in range(n_per_mode):
            ke = ke_mode * (1 + 0.05 * rng.standard_normal())
            sb = lib.Subject.builder(f"m{m}s{i}").bolus(0.0, 100.0, 0)
            for t in (1.0, 3.0, 6.0, 12.0, 24.0):
                c = 100.0 * np.exp(-ke * t) / 10.0
                sb = sb.observation(float(t), float(c * (1 + noise * rng.standard_normal())), 0)
            subjects.append(sb.build())
    return lib.Data(subjects)


def _ems(lib=pt):
    return lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.proportional(lib.ErrorPoly(0.0, 0.05), 1.0))


@pytest.fixture(scope="module")
def jax_result():
    return jax_fit(_model(pst), _population(lib=pst), _ems(pst), RANGES, engine="xla",
                   **FIT_KW)


def _same_fit(got, want, ll_rel=1e-12):
    assert got.cycles == want.cycles
    assert got.support.shape == want.support.shape
    np.testing.assert_allclose(got.support, want.support, rtol=1e-10)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-8)
    assert np.isclose(got.log_likelihood, want.log_likelihood, rtol=ll_rel, atol=0.0)


@pytest.mark.parametrize("engine", ["general", "fused"])
def test_fit_population_sharded_matches_unsharded(engine, jax_result):
    data = _population()
    base = fit_population(_model(), data, _ems(), RANGES, device="cpu", engine=engine,
                          **FIT_KW)
    mesh = population_mesh(shape=(4, 2), devices=["cpu"] * 8)
    shard = fit_population(_model(), data, _ems(), RANGES, mesh=mesh, engine=engine,
                           **FIT_KW)
    _same_fit(shard, jax_result)
    _same_fit(shard, base)


@pytest.mark.slow
def test_fit_population_sharded_matches_jax_sharded():
    """The JAX package's own sharded fit on the conftest's eight virtual
    devices, (4, 2), against the port's on eight ``cpu`` devices."""
    want = jax_fit(_model(pst), _population(lib=pst), _ems(pst), RANGES, engine="xla",
                   mesh=jax_mesh(shape=(4, 2)), **FIT_KW)
    got = fit_population(_model(), _population(), _ems(), RANGES, engine="general",
                         mesh=population_mesh(shape=(4, 2), devices=["cpu"] * 8), **FIT_KW)
    _same_fit(got, want)


def test_fit_population_mesh_takes_its_first_device():
    from pharmsol_tpu_torch.errors import PharmsolError

    mesh = population_mesh(shape=(2, 1), devices=["cpu"] * 2)
    with pytest.raises(PharmsolError, match="is_available"):
        fit_population(_model(), _population(1), _ems(), RANGES, init_points=8,
                       mesh=mesh, device="cuda")
