"""The float32 accuracy budget of the closed-form structures.

The analytical rows of the JAX package's ``utils/f32_budget.py`` (that
module imports jax), copied as constants: the most a float32 psi may differ
from the float64 psi of the same inputs, as
``max |psi_f32 - psi_f64| / max(|psi_f64|, 1)`` over all cells, on the
budget's own case (:func:`kernel_case`). ``NOMINAL`` are the parameter
centres of those cases (kernel order; the volume column follows).
"""

from __future__ import annotations

from typing import Dict, List

F32_BUDGET: Dict[str, float] = {
    "one_compartment": 3e-5,
    "one_compartment_with_absorption": 3e-5,
    "one_compartment_cl": 3e-5,
    "one_compartment_cl_with_absorption": 3e-5,
    "two_compartments": 5e-5,
    "two_compartments_with_absorption": 5e-5,
    "two_compartments_cl": 5e-5,
    "two_compartments_cl_with_absorption": 5e-5,
    "three_compartments": 1e-4,
    "three_compartments_with_absorption": 1e-4,
    "three_compartments_cl": 1e-4,
    "three_compartments_cl_with_absorption": 1e-4,
}

NOMINAL: Dict[str, List[float]] = {
    "one_compartment": [0.2],
    "one_compartment_with_absorption": [1.1, 0.2],
    "one_compartment_cl": [2.0, 10.0],
    "one_compartment_cl_with_absorption": [1.1, 2.0, 10.0],
    "two_compartments": [0.2, 0.3, 0.25],
    "two_compartments_with_absorption": [0.2, 1.1, 0.3, 0.25],
    "two_compartments_cl": [2.0, 3.0, 10.0, 14.0],
    "two_compartments_cl_with_absorption": [1.1, 2.0, 3.0, 10.0, 14.0],
    "three_compartments": [0.2, 0.3, 0.05, 0.25, 0.07],
    "three_compartments_with_absorption": [1.1, 0.2, 0.3, 0.05, 0.25, 0.07],
    "three_compartments_cl": [2.0, 3.0, 0.6, 10.0, 14.0, 9.0],
    "three_compartments_cl_with_absorption": [
        1.1, 2.0, 3.0, 0.6, 10.0, 14.0, 9.0],
}


def f32_error(got, golden) -> float:
    """The budget's measure: max |got - golden| / max(|golden|, 1)."""
    import numpy as np

    got = np.asarray(got, dtype=np.float64)
    golden = np.asarray(golden, dtype=np.float64)
    return float(np.max(np.abs(got - golden) / np.maximum(np.abs(golden), 1.0)))


def kernel_case(name: str):
    """The budget's case for structure ``name``: (model, data, support, ems).

    The JAX package's ``_kernel_case`` on the same seed: 8 subjects with two
    boluses and an infusion into input 0, 7 observations plus a BLOQ and an
    ALOQ one, 12 support points jittered 15% around ``NOMINAL`` with the
    volume (last column) around 11.
    """
    import numpy as np

    from ..data.error_model import AssayErrorModel, AssayErrorModels, ErrorPoly
    from ..data.event import Censor
    from ..data.structs import Data, Subject
    from ..engine.analytical import KERNELS
    from ..models.equation import Analytical

    rng = np.random.RandomState(97)
    subjects = []
    for i in range(8):
        b = (Subject.builder(f"b{i}").bolus(0.0, 100.0, 0)
             .bolus(12.0, 80.0, 0).infusion(4.0, 120.0, 0, 2.0))
        for t in (1.0, 2.5, 4.0, 6.0, 9.0, 12.0, 24.0):
            b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
        b = b.censored_observation(30.0, 0.1, 0, Censor.BLOQ)
        b = b.censored_observation(0.25, 8.0, 0, Censor.ALOQ)
        subjects.append(b.build())
    fn, nstates, nparams = KERNELS[name]
    central = 1 if name.endswith("_with_absorption") else 0
    model = Analytical(
        fn,
        out=lambda x, p, t, cov, c=central, vcol=nparams: x[c:c + 1] / p[vcol],
        nstates=nstates, ndrugs=1, nout=1,
    )
    support = np.abs(
        np.array(NOMINAL[name] + [11.0])[None, :]
        * (1.0 + 0.15 * rng.randn(12, nparams + 1))
    )
    ems = AssayErrorModels().add(
        0, AssayErrorModel.additive(ErrorPoly(0.4, 0.1), 1.0))
    return model, Data(subjects), support, ems
