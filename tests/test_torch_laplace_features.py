"""The port's Laplace objective against the JAX package's with the
structural options: full omega (the Cholesky parameterization), a power
covariate effect on V (a fitted beta) and IOV on ke (occasion-level kappa,
unbalanced occasions so that padded slots occur).

As ``test_torch_laplace.py``, through ``_introspect`` with ``_build_only``:
``neg_laplace`` within 1e-10, its gradient within 1e-8 and the inner modes
within 1e-9 (plus each side's remaining Newton step), at ``psi0`` and at a
perturbed psi, on ``test_torch_laplace.py::covariate_population``, float64
on the CPU.
"""

import functools

import pytest

import pharmsol_tpu_torch as pt

from test_torch_laplace import _jax_pieces, check_against_jax


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


def test_full_omega_covariate_effect_and_iov_match_jax():
    check_against_jax("full_covariate_iov", functools.lru_cache(maxsize=None)(_jax_pieces))
