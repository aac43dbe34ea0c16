"""``export_psi`` of ODE models under the ESDIRK pairs trbdf2 and kvaerno3:
the 2-state oral model of ``test_torch_export_ode.py``, its artifact (each
Newton stage's Jacobian by symbolic tangents of the traced RHS) held within
1e-10 relative to the port's eager ``engine='general'`` (``jacfwd``) and to
the JAX package's artifact, float64 on the CPU."""

import numpy as np
import pytest
from test_torch_export_ode import _exported, _jax_artifact_psi, _on_the_cpu, _rel  # noqa: F401


@pytest.mark.parametrize("solver", ["trbdf2", "kvaerno3"])
def test_export_esdirk_solver(solver, tmp_path):
    psi, want = _exported(solver, tmp_path)
    assert np.all(np.isfinite(psi.numpy()))
    assert _rel(psi, want) <= 1e-10
    assert _rel(psi, _jax_artifact_psi(solver)) <= 1e-10
