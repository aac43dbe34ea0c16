"""The port's NPML weight solve (``pharmsol_tpu_torch/optimize/weights.py``).

The cases of the JAX package's ``tests/test_weights.py`` on the port's
functions, then the port against the JAX package on the same psi (float64
on the CPU): ``solve_weights`` gives the same weights within 1e-8 and the
same log-likelihood within 1e-10 relative; the torch burn-in stops where
the JAX package's ``lax.while_loop`` rule stops whatever the interval at
which its stop flag is read back; and the device/host switch keys on CUDA
and the port's own threshold.
"""

import numpy as np
import pytest
import torch

from pharmsol_tpu.optimize import weights as jax_weights

from pharmsol_tpu_torch.optimize import weights
from pharmsol_tpu_torch.optimize.weights import (
    _burnin_device,
    _burnin_device_loop,
    _burnin_host,
    _device_eligible,
    _newton_active,
    solve_weights,
    solve_weights_plain,
)
from pharmsol_tpu_torch.utils.profiling import reset_stages, stage_counts


def _mixture_psi(rng, n, k, bw=0.1):
    """Synthetic psi: subjects drawn near a few modes, row-normalized."""
    centers = rng.rand(max(1, k // 50) + 2)
    true = centers[rng.randint(len(centers), size=n)]
    theta = np.sort(rng.rand(k))
    log_psi = -0.5 * ((true[:, None] - theta[None, :]) / bw) ** 2
    return np.exp(log_psi - log_psi.max(axis=1, keepdims=True))


def _ll(psi, lam):
    return float(np.sum(np.log(np.maximum(psi @ lam, 1e-300))))


@pytest.mark.parametrize("n,k", [(60, 8), (400, 150), (300, 2)])
def test_hybrid_matches_plain_optimum(n, k):
    psi = _mixture_psi(np.random.RandomState(n + k), n, k)
    lam_p, pyl_p, ll_p = solve_weights_plain(psi)
    lam_n, pyl_n, ll_n = solve_weights(psi)
    assert ll_n >= ll_p - 1e-6 * max(1.0, abs(ll_p))
    assert abs(lam_n.sum() - 1.0) < 1e-12
    assert np.all(lam_n >= 0.0)


def test_hybrid_satisfies_kkt():
    psi = _mixture_psi(np.random.RandomState(3), 500, 120)
    lam, pyl, ll = solve_weights(psi)
    n = psi.shape[0]
    d = psi.T @ (1.0 / pyl)
    # supported points sit at D = n; excluded points below (Lindsay 1983)
    sup = lam > 1e-8
    assert np.all(d[sup] <= n * (1.0 + 1e-6))
    assert np.max(np.abs(d[sup] - n)) < n * 1e-4
    assert np.all(d[~sup] <= n * (1.0 + 1e-4))


def test_two_point_analytic():
    psi = np.array([[1.0, 1e-8], [1e-8, 1.0]])
    lam, pyl, ll = solve_weights(psi)
    assert np.allclose(lam, [0.5, 0.5], atol=1e-6)


def test_kkt_outer_loop_readmits_pruned_column():
    rng = np.random.RandomState(11)
    psi = _mixture_psi(rng, 200, 60, bw=0.05)
    lam, pyl, ll = solve_weights(psi)
    lam_p, pyl_p, ll_p = solve_weights_plain(psi, max_iters=20000)
    assert ll >= ll_p - 1e-6 * max(1.0, abs(ll_p))


def test_burnin_host_prunes_and_preserves_mass():
    psi = _mixture_psi(np.random.RandomState(5), 300, 100)
    lam = _burnin_host(psi)
    assert lam.shape == (100,)
    assert abs(lam.sum() - 1.0) < 1e-12
    assert np.sum(lam > 0) < 100  # pruning actually happened


def test_burnin_device_matches_host_direction():
    # the float32 torch burn-in (a CPU tensor here) must land in the same
    # basin as the host burn-in: Newton from either endpoint reaches the
    # same log-likelihood
    psi = _mixture_psi(np.random.RandomState(7), 250, 96)
    n = psi.shape[0]
    lam_dev = _burnin_device(torch.as_tensor(psi, dtype=torch.float32))
    assert lam_dev.shape == (96,) and lam_dev.dtype == np.float64
    assert abs(lam_dev.sum() - 1.0) < 1e-9
    lam_a = _newton_active(psi, lam_dev, n)
    lam_b = _newton_active(psi, _burnin_host(psi), n)
    assert abs(_ll(psi, lam_a) - _ll(psi, lam_b)) < 1e-6 * max(1.0, abs(_ll(psi, lam_b)))


def test_single_column_short_circuit():
    psi = np.abs(np.random.RandomState(0).rand(10, 1)) + 0.1
    lam, pyl, ll = solve_weights(psi)
    assert lam.shape == (1,) and lam[0] == 1.0
    assert np.allclose(pyl, psi[:, 0])


# -- the port against the JAX package ----------------------------------------


@pytest.mark.parametrize("n,k,seed", [(60, 8, 0), (400, 150, 1), (250, 96, 2), (300, 2, 3)])
def test_solve_weights_matches_the_jax_package(n, k, seed):
    psi = _mixture_psi(np.random.RandomState(seed), n, k)
    lam_j, pyl_j, ll_j = jax_weights.solve_weights(psi)
    lam_t, pyl_t, ll_t = solve_weights(psi)
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(pyl_t, pyl_j, rtol=1e-8)
    assert abs(ll_t - ll_j) <= 1e-10 * max(1.0, abs(ll_j))
    lam_p, _, ll_p = solve_weights_plain(psi)
    lam_q, _, ll_q = jax_weights.solve_weights_plain(psi)
    np.testing.assert_array_equal(lam_p, lam_q)
    assert ll_p == ll_q


@pytest.mark.parametrize("n,k,seed", [(250, 96, 7), (400, 30, 8)])
def test_host_phases_equal_the_jax_package(n, k, seed):
    """The host burn-in and the active-set Newton are the same numpy code."""
    psi = _mixture_psi(np.random.RandomState(seed), n, k)
    lam_t, lam_j = _burnin_host(psi), jax_weights._burnin_host(psi)
    np.testing.assert_array_equal(lam_t, lam_j)
    np.testing.assert_array_equal(_newton_active(psi, lam_t, n),
                                  jax_weights._newton_active(psi, lam_j, n))


def _burnin_reference(psi: np.ndarray):
    """The JAX package's ``lax.while_loop`` burn-in written as a plain loop
    that tests its stop after every iteration: (lam, iterations)."""
    psi = torch.as_tensor(psi, dtype=torch.float32)
    n, k = psi.shape
    lam = torch.full((k,), 1.0 / k, dtype=torch.float32)
    last = torch.tensor(-1e30, dtype=torch.float32)
    streak = iters = 0
    while iters < weights._BURNIN_MAX_ITERS and streak < 3:
        pyl = torch.maximum(psi @ lam, torch.tensor(1e-30, dtype=torch.float32))
        ll = torch.sum(torch.log(pyl))
        lam = lam * (psi.t() @ (1.0 / pyl)) * (1.0 / n)
        lam = lam / torch.sum(lam)
        small = bool((ll - last) < weights._BURNIN_TOL_F32 * torch.abs(ll))
        streak = streak + 1 if small else 0
        last = ll
        iters += 1
    return lam, iters


@pytest.mark.parametrize("check_every", [1, 7, 32, 5000])
def test_device_burnin_stops_where_the_rule_stops(check_every):
    """Reading the stop flag back every ``check_every`` iterations changes
    neither the returned weights nor the iteration count: both are those of
    the rule tested after every iteration."""
    psi = _mixture_psi(np.random.RandomState(21), 300, 64)
    want, want_iters = _burnin_reference(psi)
    assert 3 <= want_iters < weights._BURNIN_MAX_ITERS
    lam, iters = _burnin_device_loop(torch.as_tensor(psi, dtype=torch.float32), check_every)
    assert int(iters) == want_iters
    assert torch.equal(lam, want)


def test_device_burnin_against_the_jax_burnin():
    """The same constants and update as the JAX package's jitted loop: the
    two float32 burn-ins reach the same log-likelihood within the loop's own
    stopping tolerance."""
    psi = _mixture_psi(np.random.RandomState(7), 250, 96)
    lam_j = jax_weights._burnin_device(psi.astype(np.float32), 96)
    lam_t = _burnin_device(torch.as_tensor(psi, dtype=torch.float32))
    assert weights._BURNIN_MAX_ITERS == jax_weights._BURNIN_MAX_ITERS
    assert weights._BURNIN_TOL_F32 == jax_weights._BURNIN_TOL_F32
    assert abs(_ll(psi, lam_t) - _ll(psi, lam_j)) <= 1e-5 * abs(_ll(psi, lam_j))
    np.testing.assert_allclose(lam_t, lam_j, atol=2e-3)


def test_device_burnin_falls_back_to_uniform_on_collapse():
    lam = _burnin_device(torch.full((5, 4), float("nan"), dtype=torch.float32))
    np.testing.assert_array_equal(lam, np.full(4, 0.25))


def test_device_switch_keys_on_cuda_and_the_threshold():
    big = weights._DEVICE_MIN_CELLS
    assert _device_eligible(big, 1, "cuda") and _device_eligible(1, big, torch.device("cuda", 0))
    assert not _device_eligible(big - 1, 1, "cuda")
    assert not _device_eligible(big, 8, "cpu")


def test_a_cpu_psi_f32_takes_the_host_burnin(monkeypatch):
    """``psi_f32`` on the CPU never reaches the torch burn-in, whatever the
    size: the switch asks for a CUDA tensor."""
    monkeypatch.setattr(weights, "_DEVICE_MIN_CELLS", 1)
    psi = _mixture_psi(np.random.RandomState(4), 120, 20)
    reset_stages()
    lam, pyl, ll = solve_weights(psi, psi_f32=torch.as_tensor(psi, dtype=torch.float32))
    assert "npag/weights_device" not in stage_counts()
    lam0, _, ll0 = solve_weights(psi)
    np.testing.assert_array_equal(lam, lam0)
    with pytest.raises(ValueError, match="psi_f32"):
        solve_weights(psi, psi_f32=torch.zeros(3, 3))
