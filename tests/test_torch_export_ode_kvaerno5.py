"""``export_psi`` of an ODE model under kvaerno5, the 7-stage ESDIRK pair:
the 2-state oral model of ``test_torch_export_ode.py``, its artifact held
within 1e-10 relative to the port's eager ``engine='general'`` and to the
JAX package's artifact, float64 on the CPU."""

import numpy as np
from test_torch_export_ode import _exported, _jax_artifact_psi, _on_the_cpu, _rel  # noqa: F401


def test_export_kvaerno5(tmp_path):
    psi, want = _exported("kvaerno5", tmp_path)
    assert np.all(np.isfinite(psi.numpy()))
    assert _rel(psi, want) <= 1e-10
    assert _rel(psi, _jax_artifact_psi("kvaerno5")) <= 1e-10
