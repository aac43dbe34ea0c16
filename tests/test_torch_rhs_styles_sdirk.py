"""The math model under kvaerno3 (the SDIRK tier) against the JAX package.

``utils/style_cases.py::math_case`` (every operation of the RHS
generator's elementwise set and a state-dependent power, a time-varying
weight and a lag), float64 on the CPU: the port's general engine against
JAX ``engine='xla'`` within 1e-10, and the twin of kernel K2b through the
fused plan against the general engine within the stiff solvers'
controller error (1e-3). The other solvers: ``test_torch_rhs_styles_parity.py``
(the general engine's kvaerno3 takes most of a file's time on this model:
each Newton round differentiates the closure anew).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pharmsol_tpu as pst
from pharmsol_tpu.likelihood.matrix import log_likelihood_matrix as jax_psi

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch.utils import style_cases as sc

from test_torch_rhs_styles_parity import JAX_F, MATH_SHAPE, _plan, _rel


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_math_model_under_kvaerno3_matches_jax_xla_and_its_twin():
    jm, jdata, sp, jems = sc.math_case(lib=pst, F=JAX_F, stack=jnp.stack, solver="kvaerno3",
                                       **MATH_SHAPE)
    tm, tdata, _, tems = sc.math_case(solver="kvaerno3", **MATH_SHAPE)
    want = np.asarray(jax_psi(jm, jdata, sp, jems, engine="xla"))
    general = pt.log_likelihood_matrix(tm, tdata, sp, tems, engine="general").numpy()
    assert np.isfinite(want).all()
    assert _rel(general, want) <= 1e-10
    plan = _plan(tm, tdata, sp, tems)
    assert plan.solver == "kvaerno3" and plan.rhs.jacobian and plan.rhs.style == "lanes"
    assert _rel(plan.run().numpy(), general) <= 1e-3
