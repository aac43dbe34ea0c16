"""The port's C++ ``.pkm`` host (``pharmsol_tpu_torch/native/pkm_host.py``
over its copy of the JAX package's ``native/src/pkm_host.cpp``).

The cases of the JAX package's ``tests/test_pkm_host.py`` on the port: an
artifact saved by the port's DSL runs in the standalone C++ host, held
against the port's ``dsl/pure.py`` (the evaluation contract, 1e-12), the
port's engine on the CPU (its ``estimate_predictions``), and the JAX
package's ``PureModel`` on the same artifact (1e-12). Float64, on the host.
"""

import numpy as np
import pytest

from pharmsol_tpu.dsl.pure import PureCovariate as JaxPureCovariate
from pharmsol_tpu.dsl.pure import PureModel as JaxPureModel

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import Subject
from pharmsol_tpu_torch.dsl import compile_model, save_artifact
from pharmsol_tpu_torch.dsl.pure import PureCovariate, PureModel
from pharmsol_tpu_torch.native.pkm_host import pkm_host_available, run_pkm_host


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def test_pkm_host_builds():
    assert pkm_host_available(), "a C++ toolchain is expected in this image"


ODE_SRC = """
name = portable
kind = ode
params = ka, cl, v
covariates = wt@linear
states = depot, central
derived = ke
outputs = cp
bolus(oral) -> depot
ke = cl * pow(wt / 70.0, 0.75) / v
dx(depot) = -ka * depot
dx(central) = ka * depot - ke * central
out(cp) = central / v
"""


def _save(src, tmp_path, name):
    runtime = compile_model(src)
    path = str(tmp_path / name)
    save_artifact(runtime, path)
    return runtime, path


def test_ode_host_matches_pure_and_jitted(tmp_path):
    runtime, path = _save(ODE_SRC, tmp_path, "ode.pkm")
    params = [1.2, 4.0, 35.0]
    obs_times = [1.0, 4.0, 12.0]
    boluses = [(0.0, 100.0, 0)]
    cov = {"wt": PureCovariate([(0.0, 80.0)])}

    got = run_pkm_host(path, params, boluses, obs_times, cov=cov, dt=0.005)
    want_pure = PureModel.load(path).simulate(
        params, boluses=boluses, obs_times=obs_times, cov=cov, dt=0.005
    )
    # identical algorithm (fixed-step RK4, same step count) in both hosts;
    # only libm ulp differences separate them
    np.testing.assert_allclose(got, want_pure, rtol=1e-12)
    want_jax = JaxPureModel.load(path).simulate(
        params, boluses=boluses, obs_times=obs_times,
        cov={"wt": JaxPureCovariate([(0.0, 80.0)])}, dt=0.005)
    np.testing.assert_allclose(got, want_jax, rtol=1e-12)

    s = Subject.builder("s").bolus(0.0, 100.0, "oral").covariate("wt", 0.0, 80.0)
    for t in obs_times:
        s = s.observation(t, 0.0, "cp")
    want_jit = np.asarray(
        runtime.model.estimate_predictions(s.build(), params, device="cpu").flat_predictions()
    )
    np.testing.assert_allclose([g[0] for g in got], want_jit, rtol=1e-4)


def test_ode_host_time_varying_covariate(tmp_path):
    _, path = _save(ODE_SRC, tmp_path, "ode_tv.pkm")
    params = [1.5, 3.0, 20.0]
    obs_times = [0.5, 2.0, 6.0, 10.0]
    boluses = [(0.0, 80.0, 0), (6.0, 40.0, 0)]
    cov = {"wt": PureCovariate([(0.0, 60.0), (8.0, 90.0)])}
    got = run_pkm_host(path, params, boluses, obs_times, cov=cov, dt=0.002)
    want = PureModel.load(path).simulate(
        params, boluses=boluses, obs_times=obs_times, cov=cov, dt=0.002
    )
    np.testing.assert_allclose(got, want, rtol=1e-12)


ANALYTICAL_SRC = """
name = portable_analytical
kind = analytical
params = ka, cl, v
covariates = wt@linear
states = depot, central
derived = ke
outputs = cp
bolus(oral) -> depot
structure = one_compartment_with_absorption
ke = cl * pow(wt / 70.0, 0.75) / v
out(cp) = central / v
"""


def test_analytical_host_matches_pure_and_jitted(tmp_path):
    runtime, path = _save(ANALYTICAL_SRC, tmp_path, "ana.pkm")
    params = [1.2, 4.0, 35.0]
    obs_times = [1.0, 4.0, 12.0, 24.0]
    boluses = [(0.0, 100.0, 0), (12.0, 50.0, 0)]
    cov = {"wt": PureCovariate([(0.0, 80.0)])}

    got = run_pkm_host(path, params, boluses, obs_times, cov=cov)
    want_pure = PureModel.load(path).simulate(
        params, boluses=boluses, obs_times=obs_times, cov=cov
    )
    np.testing.assert_allclose(got, want_pure, rtol=1e-12)
    want_jax = JaxPureModel.load(path).simulate(
        params, boluses=boluses, obs_times=obs_times,
        cov={"wt": JaxPureCovariate([(0.0, 80.0)])})
    np.testing.assert_allclose(got, want_jax, rtol=1e-12)

    s = Subject.builder("s").bolus(0.0, 100.0, "oral").bolus(
        12.0, 50.0, "oral").covariate("wt", 0.0, 80.0)
    for t in obs_times:
        s = s.observation(t, 0.0, "cp")
    want_jit = np.asarray(
        runtime.model.estimate_predictions(s.build(), params, device="cpu").flat_predictions()
    )
    np.testing.assert_allclose([g[0] for g in got], want_jit, rtol=1e-9)


SDE_SRC = """
name = portable_sde
kind = sde
params = ke, vol
states = central
particles = 16
outputs = cp
bolus(iv) -> central
dx(central) = -ke * central
noise(central) = 0.0
out(cp) = central / vol
"""


def test_sde_zero_diffusion_host_matches_pure(tmp_path):
    _, path = _save(SDE_SRC, tmp_path, "sde.pkm")
    params = [0.3, 10.0]
    obs_times = [0.5, 1.0, 2.0]
    boluses = [(0.0, 100.0, 0)]
    got = run_pkm_host(path, params, boluses, obs_times, dt=0.002,
                       nparticles=4)
    want = PureModel.load(path).simulate(
        params, boluses=boluses, obs_times=obs_times, dt=0.002, nparticles=4
    )
    # zero diffusion: the particle cloud is deterministic in both hosts
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_sde_stochastic_mean_near_deterministic(tmp_path):
    src = SDE_SRC.replace("noise(central) = 0.0", "noise(central) = 0.5")
    _, path = _save(src, tmp_path, "sde2.pkm")
    got = run_pkm_host(path, [0.3, 10.0], [(0.0, 100.0, 0)], [1.0],
                       dt=0.01, nparticles=64, seed=3)
    det = 100.0 * np.exp(-0.3) / 10.0
    assert abs(got[0][0] - det) < 1.0


ARRAY_SRC = """
model transit {
  kind ode
  parameters { ktr, ke, v }
  states { a[4] }
  routes { bolus oral -> a[0] }
  dynamics {
    dx[0] = -ktr * a[0]
    for i in 1..3 {
      dx[i] = ktr * (a[i-1] - a[i])
    }
    dx(a[3]) = ktr * a[2] - ke * a[3]
  }
  outputs { out(cp) = a[3] / v }
}
"""


def test_array_states_and_for_loops(tmp_path):
    """Array states, for-loops and indexed dx targets run in the C++ host."""
    _, path = _save(ARRAY_SRC, tmp_path, "arr.pkm")
    params = [2.0, 0.4, 15.0]
    obs_times = [0.5, 1.0, 3.0, 8.0]
    boluses = [(0.0, 100.0, 0)]
    got = run_pkm_host(path, params, boluses, obs_times, dt=0.002)
    want = PureModel.load(path).simulate(
        params, boluses=boluses, obs_times=obs_times, dt=0.002
    )
    np.testing.assert_allclose(got, want, rtol=1e-12)
