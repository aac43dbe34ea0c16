"""The float32 accuracy budget of the ported model classes.

The analytical and explicit-ODE rows of the JAX package's
``utils/f32_budget.py`` (that module imports jax), copied as constants: the
most a float32 psi may differ from the float64 psi of the same inputs, as
``max |psi_f32 - psi_f64| / max(|psi_f64|, 1)`` over all cells, on the
budget's own case (:func:`kernel_case`, :func:`ode_case`). ``NOMINAL`` are
the parameter centres of the closed-form cases (kernel order; the volume
column follows).
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
    # adaptive stepping compounds controller decisions (JAX package :61, :65)
    "ode_dopri5": 2e-4,
    "ode_multi_input": 2e-4,   # per-input bolus/rate streams
}
ODE_CASES = ("ode_dopri5", "ode_multi_input")

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


def ode_case(name: str):
    """The budget's ODE case ``name``: (model, data, support, ems), the JAX
    package's ``_ode_case`` / ``_ode_multi_input_case`` on the same seeds.

    ``ode_dopri5``: a 2-state bolus + infusion RHS on the closed-form cases'
    workload (two boluses, an infusion, 7 observations plus a BLOQ and an
    ALOQ one). ``ode_multi_input``: a 3-state RHS dosed into two inputs (a
    bolus into each, an infusion into input 1), 6 observations.
    """
    import numpy as np
    import torch

    from ..data.error_model import AssayErrorModel, AssayErrorModels, ErrorPoly
    from ..data.event import Censor
    from ..data.structs import Data, Subject
    from ..models.equation import ODE

    ems = AssayErrorModels().add(
        0, AssayErrorModel.additive(ErrorPoly(0.4, 0.1), 1.0))
    if name == "ode_dopri5":
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
        model = ODE(
            lambda x, p, t, b, rateiv, cov: torch.stack([
                -p[0] * x[0] + b[0],
                p[0] * x[0] - p[1] * x[1] + rateiv[0],
            ]),
            out=lambda x, p, t, cov: x[1:2] / p[2],
            nstates=2, ndrugs=1, nout=1,
        )
        support = np.abs(np.array([1.1, 0.2, 11.0])[None, :]
                         * (1.0 + 0.15 * rng.randn(12, 3)))
        return model, Data(subjects), support, ems
    if name == "ode_multi_input":
        rng = np.random.RandomState(47)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"m{i}").bolus(0.0, 100.0, 0)
                 .bolus(1.0, 60.0, 1).infusion(2.0, 40.0, 1, 1.5))
            for t in (0.5, 1.5, 3.0, 5.0, 8.0, 12.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        model = ODE(
            lambda x, p, t, b, rateiv, cov: torch.stack([
                -p[0] * x[0] + b[0] + rateiv[1],
                -p[1] * x[1] + b[1],
                p[0] * x[0] + p[1] * x[1] - p[2] * x[2] + rateiv[0],
            ]),
            out=lambda x, p, t, cov: x[2:3] / p[3],
            nstates=3, ndrugs=2, nout=1,
        )
        support = np.column_stack([
            rng.uniform(0.5, 2.0, 12), rng.uniform(0.3, 1.2, 12),
            rng.uniform(0.05, 0.5, 12), rng.uniform(8, 14, 12),
        ])
        return model, Data(subjects), support, ems
    raise KeyError(f"no ODE budget case `{name}` (have {', '.join(ODE_CASES)})")
