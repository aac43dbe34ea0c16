"""``export_psi`` of an ODE model under bdf, the variable-order BDF (the
difference array carried through the loop, its Newton iteration one nested
loop): the 2-state oral model of ``test_torch_export_ode.py``, its artifact
held within 1e-10 relative to the port's eager ``engine='general'`` and to
the JAX package's artifact, float64 on the CPU."""

import numpy as np
from test_torch_export_ode import _exported, _jax_artifact_psi, _on_the_cpu, _rel  # noqa: F401


def test_export_bdf(tmp_path):
    psi, want = _exported("bdf", tmp_path)
    assert np.all(np.isfinite(psi.numpy()))
    assert _rel(psi, want) <= 1e-10
    assert _rel(psi, _jax_artifact_psi("bdf")) <= 1e-10
