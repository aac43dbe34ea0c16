"""The port's population NCA batches against the JAX package's (mirrors
``tests/test_nca_batch.py``): the host ``nca/batch.py::batch_nca`` (a copy)
and the device ``nca/batch_device.py::batch_nca_device`` (torch tensor
operations on an explicit device, the JAX package's jitted program).

- Every test of ``tests/test_nca_batch.py`` runs on the port (its source
  with the imports pointed at the port, ``test_torch_nca.py::port_module``), on the
  CPU, at its own tolerances (device against host 1e-8 relative, route and
  steady-state blocks against per-subject ``nca`` 1e-8), but for two: the
  wall-clock throughput assert (``test_batch_nca_throughput``, which
  measures the machine, not the port) and the JAX mesh check
  (``test_device_runs_sharded``).
- The port's device batch against the JAX package's on the same profiles,
  every key and route, within 1e-12 relative (the same arithmetic in
  another order: a 1e-13 cancellation in the percent-extrapolated keys);
  the host batch equal to the JAX package's bit for bit.
"""

import numpy as np
import pytest

from pharmsol_tpu.nca import NCAOptions as JaxOptions
from pharmsol_tpu.nca.batch import batch_nca as jax_batch_nca
from pharmsol_tpu.nca.batch_device import batch_nca_device as jax_batch_nca_device

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.data.event import AUCMethod
from pharmsol_tpu_torch.nca import NCAOptions
from pharmsol_tpu_torch.nca.batch import batch_nca
from pharmsol_tpu_torch.nca.batch_device import batch_nca_device

from test_torch_nca import port_module, run, suite_tests

SUITE = port_module("test_nca_batch.py")
NOT_PORTED = ("test_batch_nca_throughput", "TestBatchNCADevice.test_device_runs_sharded")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


@pytest.mark.parametrize("name", suite_tests(SUITE, exclude=NOT_PORTED))
def test_nca_batch_suite_on_the_port(name):
    run(SUITE, name)


def _close(got, want, key):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=key)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-12, atol=1e-300, err_msg=key)


@pytest.mark.parametrize("route", [None, "iv_bolus", "iv_infusion", "extravascular"])
def test_device_batch_matches_jax(route):
    t, c = SUITE.make_profiles(n=80, T=24, seed=6)
    kw = dict(dose=100.0, route=route)
    if route == "iv_infusion":
        kw["infusion_duration"] = 0.75
    for opts, jopts in ((NCAOptions(), JaxOptions()),
                        (NCAOptions().with_tau(12.0), JaxOptions().with_tau(12.0))):
        got = batch_nca_device(t, c, options=opts, **kw)
        want = jax_batch_nca_device(t, c, options=jopts, **kw)
        assert set(got) == set(want)
        for key in want:
            _close(got[key], np.asarray(want[key]), key)


def test_device_batch_linear_and_no_dose_match_jax():
    from pharmsol_tpu.data.event import AUCMethod as JaxAUC

    t, c = SUITE.make_profiles(n=30, T=16, seed=3)
    got = batch_nca_device(t, c, options=NCAOptions(auc_method=AUCMethod.LINEAR))
    want = jax_batch_nca_device(t, c, options=JaxOptions(auc_method=JaxAUC.LINEAR))
    assert set(got) == set(want) and "cl_f" not in got
    for key in want:
        _close(got[key], np.asarray(want[key]), key)


def test_host_batch_equals_jax():
    t, c = SUITE.make_profiles(n=50, T=20, seed=9)
    got, want = batch_nca(t, c, dose=100.0), jax_batch_nca(t, c, dose=100.0)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_device_batch_keeps_tensors_on_request():
    import torch

    t, c = SUITE.make_profiles(n=5, T=12, seed=4)
    out = batch_nca_device(torch.tensor(t), torch.tensor(c), dose=100.0, as_numpy=False)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in out.values())
    with pytest.raises(ValueError, match="AdjR2"):
        from pharmsol_tpu_torch.nca import LambdaZMethod

        opts = NCAOptions()
        opts.lambda_z.method = LambdaZMethod.R2
        batch_nca_device(t, c, options=opts)
    with pytest.raises(ValueError, match="route"):
        batch_nca_device(t, c, route="im")
