"""The float32 accuracy budget of the ported model classes, and the cases
of the modes of kernels K1b and K2e.

The analytical, analytical-feature and explicit-ODE rows of the JAX
package's ``utils/f32_budget.py`` (that module imports jax), copied as
constants: the most a float32 psi may differ from the float64 psi of the
same inputs, as ``max |psi_f32 - psi_f64| / max(|psi_f64|, 1)`` over all
cells, on the budget's own case (:func:`kernel_case`, :func:`ode_case`,
:func:`feature_budget_case`). ``NOMINAL`` are the parameter centres of the
closed-form cases (kernel order; the volume column follows).

:func:`feature_case` builds one case per mode of K1b (``FEATURE_CASES``:
name -> the budget row its float32 result is held to). Its closures are
plain Python arithmetic on the parameters, so the same function builds the
model in the JAX package too when handed that package (``lib``), for the
parity tests. :func:`ode_feature_case` does the same for K2e's modes
(``ODE_FEATURE_CASES``), and :func:`covariate_model_case` for the reference's
covariate example; their right-hand sides stack with the ``stack`` they are
given (``torch.stack`` by default).
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
    # feature variants on one_compartment_with_absorption (JAX package
    # :49-56, :66): seq factors per row or per segment, segment-indexed
    # planes, per-support initial states
    "seq_multiplier_row": 5e-5,
    "seq_multiplier_segment": 5e-5,
    "seq_segplanes": 5e-5,
    "analytical_init": 5e-5,
    # kernel K1c (JAX package :53, :59): lag with a seq chain deeper than
    # one (the in-kernel depth counter and a split march, two propagates in
    # the segment of a fire), and lag with a time-varying seq (per-column
    # main and post planes, the same split march; the chain is host float64)
    "lag_seq_depth": 1e-4,
    "seq_colplanes": 1e-4,
    # adaptive stepping compounds controller decisions (JAX package :61, :65)
    "ode_dopri5": 2e-4,
    "ode_multi_input": 2e-4,   # per-input bolus/rate streams
    # the feature tier (JAX package :63-64): the lag/fa split march, and a
    # covariate through per-segment affine streams
    "ode_lag_fa": 2e-4,
    "ode_tv_covariate": 2e-4,
    # exact propagation (JAX package :62): no controller, so float32 error is
    # the chain's own rounding
    "ode_expm": 5e-5,
    # variable-order BDF (JAX package :68-73): order and step adaptation
    # compound float32 noise in the difference array. The JAX package has no
    # row for the SDIRK solvers; the port holds them to this one.
    "ode_bdf": 2e-3,
}
ODE_CASES = ("ode_dopri5", "ode_multi_input", "ode_lag_fa", "ode_tv_covariate",
             "ode_expm", "ode_bdf")

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


def ode_case(name: str, lib=None, stack=None):
    """The budget's ODE case ``name``: (model, data, support, ems), the JAX
    package's ``_ode_case`` / ``_ode_multi_input_case`` / ``_ode_lag_fa_case``
    / ``_ode_tv_cov_case`` on the same seeds.

    ``ode_dopri5``: a 2-state bolus + infusion RHS on the closed-form cases'
    workload (two boluses, an infusion, 7 observations plus a BLOQ and an
    ALOQ one). ``ode_multi_input``: a 3-state RHS dosed into two inputs (a
    bolus into each, an infusion into input 1), 6 observations.
    ``ode_lag_fa``: a 2-state oral RHS with lag and fa, two boluses.
    ``ode_tv_covariate``: a 1-state RHS whose elimination follows a weight
    with three knots on observation times. ``ode_expm``: the ``ode_dopri5``
    case with ``.with_solver("expm")``, the exact propagation tier (JAX
    ``_ode_expm_case``). ``ode_bdf``: the same case with
    ``.with_solver("bdf")`` (JAX ``_ode_bdf_case``).

    Built with ``lib`` (default this package) and ``stack`` (default
    ``torch.stack``): ``lib=pharmsol_tpu, stack=jnp.stack`` gives the JAX
    package's model on the same data.
    """
    import numpy as np

    if lib is None:
        import pharmsol_tpu_torch as lib
    if stack is None:
        import torch

        stack = torch.stack
    AssayErrorModel, AssayErrorModels, ErrorPoly = (
        lib.AssayErrorModel, lib.AssayErrorModels, lib.ErrorPoly)
    Censor, Data, Subject, ODE = lib.Censor, lib.Data, lib.Subject, lib.ODE

    if name == "ode_expm":
        model, data, support, ems = ode_case("ode_dopri5", lib, stack)
        return model.with_solver("expm"), data, support, ems
    if name == "ode_bdf":
        model, data, support, ems = ode_case("ode_dopri5", lib, stack)
        return model.with_solver("bdf"), data, support, ems

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
            lambda x, p, t, b, rateiv, cov: stack([
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
            lambda x, p, t, b, rateiv, cov: stack([
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
    if name == "ode_lag_fa":
        rng = np.random.RandomState(41)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"l{i}").bolus(0.0, 100.0, 0)
                 .bolus(12.0, 80.0, 0))
            for t in (1.0, 2.5, 4.0, 6.0, 9.0, 14.0, 24.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        model = ODE(
            lambda x, p, t, b, rateiv, cov: stack([
                -p[0] * x[0] + b[0],
                p[0] * x[0] - p[1] * x[1],
            ]),
            lag=lambda p, t, cov: {0: p[3]},
            fa=lambda p, t, cov: {0: p[4]},
            out=lambda x, p, t, cov: x[1:2] / p[2],
            nstates=2, ndrugs=1, nout=1,
        )
        support = np.column_stack([
            rng.uniform(0.5, 2.0, 12), rng.uniform(0.05, 0.5, 12),
            rng.uniform(8, 14, 12), rng.uniform(0.0, 1.5, 12),
            rng.uniform(0.3, 1.0, 12),
        ])
        return model, Data(subjects), support, ems
    if name == "ode_tv_covariate":
        rng = np.random.RandomState(43)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"v{i}").bolus(0.0, 100.0, 0)
                 .covariate("wt", 0.0, 55.0 + 4.0 * i)
                 .covariate("wt", 2.5, 80.0 - 3.0 * i)
                 .covariate("wt", 9.0, 60.0 + 2.0 * i))
            for t in (1.0, 2.5, 4.0, 9.0, 14.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        model = ODE(
            lambda x, p, t, b, rateiv, cov: stack([
                -p[0] * (cov("wt", t) / 70.0) * x[0] + b[0],
            ]),
            out=lambda x, p, t, cov: x[0:1] / p[1],
            nstates=1, ndrugs=1, nout=1,
        )
        support = np.column_stack([
            rng.uniform(0.1, 0.6, 12), rng.uniform(8, 14, 12),
        ])
        return model, Data(subjects), support, ems
    raise KeyError(f"no ODE budget case `{name}` (have {', '.join(ODE_CASES)})")


def feature_budget_case(name: str):
    """The JAX package's budget case of feature row ``name``
    (``_seq_case``, ``_seq_segplanes_case``, ``_analytical_init_case``) on
    the same seeds: (model, data, support, ems)."""
    import numpy as np

    from ..data.error_model import AssayErrorModel, AssayErrorModels, ErrorPoly
    from ..data.structs import Data, Subject
    from ..engine.analytical import (
        one_compartment_with_absorption, two_compartments,
    )
    from ..models.equation import Analytical

    ems = AssayErrorModels().add(
        0, AssayErrorModel.additive(ErrorPoly(0.4, 0.1), 1.0))
    if name in ("seq_multiplier_row", "seq_multiplier_segment"):
        # allometric scaling through seq; the segment case's infusion
        # regimen forces per-segment factors
        model = Analytical(
            one_compartment_with_absorption,
            out=lambda x, p, t, cov: x[1:2] / p[2],
            seq_eq=lambda p, t, cov: [p[0], p[1] * (cov("wt", t) / 70.0) ** 0.75, p[2]],
            nstates=2, ndrugs=1, nout=1,
        )
        rng = np.random.RandomState(97)
        rng.randn(8 * 7)  # the shared workload's draws
        rng2 = np.random.RandomState(97)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"b{i}").bolus(0.0, 100.0, 0)
                 .covariate("wt", 0.0, 55.0 + 5.0 * i))
            if name == "seq_multiplier_segment":
                b = b.bolus(12.0, 80.0, 0).infusion(4.0, 120.0, 0, 2.0)
            for t in (1.0, 2.5, 4.0, 6.0, 9.0, 12.0, 24.0):
                b = b.observation(float(t), float(np.abs(3 + rng2.randn())), 0)
            subjects.append(b.build())
        sp = np.abs(np.array([1.1, 0.2, 11.0])[None, :]
                    * (1.0 + 0.15 * rng.randn(12, 3)))
        return model, Data(subjects), sp, ems
    if name == "seq_segplanes":
        # time-varying covariate mixed with a parameter: segment-indexed planes
        model = Analytical(
            two_compartments,
            out=lambda x, p, t, cov: x[0:1] / p[3],
            seq_eq=lambda p, t, cov: [p[0] * (cov("wt", t) / 70.0) ** p[2],
                                      p[1], p[2], p[3]],
            nstates=2, ndrugs=1, nout=1,
        )
        rng = np.random.RandomState(53)
        subjects = []
        for i in range(8):
            b = (Subject.builder(f"v{i}").bolus(0.0, 100.0, 0)
                 .covariate("wt", 0.0, 55.0 + 4.0 * i)
                 .covariate("wt", 4.0, 66.0 + 3.0 * i))
            if i % 3 == 0:
                b = b.infusion(2.0, 50.0, 0, 1.5)
            for t in (0.5, 1.5, 3.0, 6.0, 10.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        sp = np.abs(np.column_stack([
            0.2 * (1.0 + 0.15 * rng.randn(12)),
            0.3 * (1.0 + 0.15 * rng.randn(12)),
            rng.uniform(0.5, 1.0, 12),
            11.0 * (1.0 + 0.15 * rng.randn(12)),
        ]))
        return model, Data(subjects), sp, ems
    if name == "analytical_init":
        model = Analytical(
            one_compartment_with_absorption,
            init=lambda p, t, cov: [0.5 * p[2], 2.0 + 0.1 * p[2]],
            out=lambda x, p, t, cov: x[1:2] / p[2],
            nstates=2, ndrugs=1, nout=1,
        )
        rng = np.random.RandomState(53)
        subjects = []
        for i in range(8):
            b = Subject.builder(f"i{i}").bolus(0.0, 100.0, 0)
            for t in (1.0, 2.5, 4.0, 6.0, 9.0, 14.0):
                b = b.observation(float(t), float(np.abs(3 + rng.randn())), 0)
            subjects.append(b.build())
        sp = np.abs(np.array([1.1, 0.2, 11.0])[None, :]
                    * (1.0 + 0.15 * rng.randn(12, 3)))
        return model, Data(subjects), sp, ems
    raise KeyError(f"no feature budget case `{name}` (have {', '.join(FEATURE_BUDGETS)})")


FEATURE_BUDGETS = ("seq_multiplier_row", "seq_multiplier_segment", "seq_segplanes",
                   "analytical_init")


def _wt_allometric(p, t, cov):
    return [p[0], p[1] * (cov("wt", t) / 70.0) ** 0.75, p[2]]


def _wt_additive(p, t, cov):
    return [p[0], p[1] + 0.001 * cov("wt", t), p[2]]


def _mixing(p, t, cov):
    return [p[0] * (1.0 + 0.1 * p[2]), p[1] + 0.02 * p[0], p[2], p[3]]


def _three_cmt(p, t, cov):
    return [p[0] * 1.1, p[1], p[2] * 0.95, p[3], p[4], p[5]]


def _wt_mixing(p, t, cov):
    return [p[0] * (cov("wt", t) / 70.0) ** p[4],
            p[1] / (1.0 + p[2] * cov("wt", t) / 700.0), p[2], p[3], p[4]]


def _wt_short(p, t, cov):
    # (wt / 70) ** 0.75 on the rate constants of the 2-cmt oral structure
    sc = (cov("wt", t) / 70.0) ** 0.75
    return [p[0] * sc, p[1], p[2] * sc, p[3] * sc, p[4], p[5], p[6]]


# name: (structure, closures, regimen, support ranges, mode, budget row).
# Regimens: "bolus" one dose at 0; "infusion" adds an infusion to every third
# subject; "two_doses" doses at 0 and 12 (an infusion on every fourth);
# covariates "wt" constant per subject or "wt_tv" with a second knot at 6 h.
_FEATURES = {
    "row": ("one_compartment_with_absorption", dict(seq_eq=_wt_allometric),
            ("bolus", "wt"), [(0.8, 2.0), (0.1, 0.3), (8, 15)], "row",
            "seq_multiplier_row"),
    "row_offset": ("one_compartment_with_absorption", dict(seq_eq=_wt_additive),
                   ("bolus", "wt"), [(0.8, 2.0), (0.1, 0.3), (8, 15)], "row",
                   "seq_multiplier_row"),
    "segment": ("one_compartment_with_absorption", dict(seq_eq=_wt_allometric),
                ("infusion", "wt"), [(0.8, 2.0), (0.1, 0.3), (8, 15)], "segment",
                "seq_multiplier_segment"),
    "segment_offset": ("one_compartment_with_absorption", dict(seq_eq=_wt_additive),
                       ("infusion", "wt"), [(0.8, 2.0), (0.1, 0.3), (8, 15)],
                       "segment", "seq_multiplier_segment"),
    "segment_tv": ("one_compartment_with_absorption", dict(seq_eq=_wt_allometric),
                   ("bolus", "wt_tv"), [(0.8, 2.0), (0.1, 0.3), (8, 15)], "segment",
                   "seq_multiplier_segment"),
    "levels": ("two_compartments", dict(seq_eq=_mixing), ("infusion", None),
               [(0.1, 0.3), (0.2, 0.4), (0.1, 0.3), (8, 15)], "levels",
               "two_compartments"),
    "levels_3cmt": ("three_compartments", dict(seq_eq=_three_cmt), ("infusion", None),
                    [(0.1, 0.3), (0.15, 0.35), (0.05, 0.2), (0.1, 0.3), (0.05, 0.15),
                     (8, 15)], "levels", "three_compartments"),
    "planes": ("two_compartments", dict(seq_eq=_wt_mixing), ("infusion", "wt"),
               [(0.1, 0.3), (0.2, 0.4), (0.1, 0.3), (8, 15), (0.5, 1.0)], "planes",
               "two_compartments"),
    "segplanes": ("two_compartments", dict(seq_eq=_wt_mixing), ("infusion", "wt_tv"),
                  [(0.1, 0.3), (0.2, 0.4), (0.1, 0.3), (8, 15), (0.5, 1.0)], "planes",
                  "seq_segplanes"),
    "lag_fa": ("two_compartments_with_absorption",
               dict(lag=lambda p, t, cov: {0: p[5]}, fa=lambda p, t, cov: {0: p[6]}),
               ("two_doses", None),
               [(0.1, 0.3), (0.8, 2.0), (0.2, 0.4), (0.1, 0.3), (8, 15), (0.0, 1.2),
                (0.5, 1.0)], None, "two_compartments_with_absorption"),
    "lag_seq_depth1": ("one_compartment",
                       dict(seq_eq=lambda p, t, cov: [p[0] * p[1] * cov("wt", t) / 700.0,
                                                      p[1], p[2]],
                            lag=lambda p, t, cov: {0: p[2]}),
                       ("two_doses_bolus", "wt"), [(0.1, 0.3), (8, 15), (0.0, 1.5)],
                       "planes", "one_compartment"),
    # ka above the weight-scaled decay constants: where ka nears one, the
    # depot term (e_k - e_ka) / (ka - l_k) cancels in float32
    "row_lag_fa": ("two_compartments_with_absorption",
                   dict(seq_eq=_wt_short, lag=lambda p, t, cov: {0: p[5]},
                        fa=lambda p, t, cov: {0: p[6]}),
                   ("two_doses_bolus", "wt"),
                   [(0.1, 0.3), (1.8, 3.0), (0.2, 0.4), (0.1, 0.3), (8, 15), (0.0, 1.2),
                    (0.5, 1.0)], "row", "two_compartments_with_absorption"),
    "init_rows": ("one_compartment_with_absorption",
                  dict(init=lambda p, t, cov: [0.5 * p[2], 2.0 + 0.1 * p[2]]),
                  ("infusion", None), [(0.8, 2.0), (0.1, 0.3), (8, 15)], None,
                  "analytical_init"),
    "init_planes": ("one_compartment",
                    dict(init=lambda p, t, cov: [cov("wt", 0.0) / p[1]]),
                    ("bolus", "wt"), [(0.1, 0.3), (8, 15)], None, "analytical_init"),
}
FEATURE_CASES = {name: row[5] for name, row in _FEATURES.items()}


def feature_case(name: str, n_subjects: int = 8, n_support: int = 12,
                 seed: int = 0, lib=None):
    """K1b's case ``name`` (see ``FEATURE_CASES``): (model, data, support,
    ems, mode), with ``mode`` the parameter mode the fused plan picks.

    ``lib`` is the package that builds the model and the data (default this
    one); the JAX package builds the same case for the parity tests. The
    single output is the central amount over the volume, the support column
    after the kernel's.
    """
    import numpy as np

    from ..engine.analytical import KERNELS

    if lib is None:
        import pharmsol_tpu_torch as lib
    structure, closures, (regimen, cov), ranges, mode, _ = _FEATURES[name]
    _, n_states, vcol = KERNELS[structure]
    central = 1 if structure.endswith("_with_absorption") else 0
    rng = np.random.RandomState(seed)
    sp = np.column_stack([rng.uniform(lo, hi, n_support) for lo, hi in ranges])
    subjects = []
    for i in range(n_subjects):
        b = lib.Subject.builder(f"f{i}").bolus(0.0, 100.0, 0)
        if regimen.startswith("two_doses"):
            b = b.bolus(12.0, 80.0, 0)
            if regimen == "two_doses" and i % 4 == 0:
                b = b.infusion(3.0, 50.0, 0, 1.5)
        if regimen == "infusion" and i % 3 == 0:
            b = b.infusion(2.0, 50.0, 0, 1.0)
        if cov is not None:
            b = b.covariate("wt", 0.0, 40.0 + 80.0 * rng.rand())
            if cov == "wt_tv":
                b = b.covariate("wt", 6.0, 40.0 + 80.0 * rng.rand())
        times = ((0.3, 0.7, 1.5, 2.5, 5.0, 9.0, 12.5, 14.0, 20.0)
                 if regimen.startswith("two_doses") else (0.5, 1.5, 3.0, 6.0, 10.0))
        for t in times:
            b = b.observation(t, float(4.0 * np.exp(-0.2 * t) * np.exp(0.2 * rng.randn())), 0)
        subjects.append(b.build())
    model = lib.Analytical(
        getattr(lib, structure),
        out=lambda x, p, t, cov, c=central, v=vcol: x[c:c + 1] / p[v],
        nstates=n_states, ndrugs=1, nout=1, **closures)
    ems = lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))
    return model, lib.Data(subjects), sp, ems, mode


# ---------------------------------------------------------------------------
# Kernel K1c's cases: lag with a deep or time-varying seq, dynamic lag and fa
# ---------------------------------------------------------------------------


def _depth_seq(p, t, cov):
    return [p[0] * (1.0 + 0.15 * p[2]), p[1], p[2]]


def _wt_power_seq(p, t, cov):
    return [p[0] * (cov("wt", t) / 70.0) ** p[2], p[1], p[2]]


def _tv_seq(p, t, cov):
    # reads t and the time-varying weight: a seq no per-row table holds
    return [p[0] * (1.0 + 0.02 * t) * (cov("wt", t) / 70.0) ** 0.5, p[1], p[2]]


def _three_cmt_lag_seq(p, t, cov):
    return [p[0] * (1.0 + 0.1 * p[6]), p[1], p[2], p[3], p[4], p[5], p[6]]


_K1C_ONE = [(0.1, 0.3), (8, 15)]

# name: (structure, closures, covariate, support ranges, budget row). The
# regimen is test_pallas_psi.py:1304's: a bolus at 0 and a 1.5 h infusion at
# 1 h (whose end compounds the seq chain), a second bolus at 2 h on every
# other subject (its fire can land in the compounded region), observations
# at 0.5, 1.2, 2.1, 3, 4.5, 6 and 10 h; "wt" constant per subject, "wt_tv"
# with a second knot at 3 h. Every lag is below the 2 h dose gap.
_K1C = {
    # lag_depth: the event codes drive the in-kernel depth counter
    "depth_levels": ("one_compartment", dict(seq_eq=_depth_seq,
                                             lag=lambda p, t, cov: {0: p[2]}),
                     "wt", _K1C_ONE + [(0.0, 1.8)], "lag_seq_depth"),
    "depth_planes": ("one_compartment", dict(seq_eq=_wt_power_seq,
                                             lag=lambda p, t, cov: {0: 1.2 * p[2]}),
                     "wt", _K1C_ONE + [(0.2, 1.2)], "lag_seq_depth"),
    # lag zero on some supports: those fire at offset 0 of their column
    "zero_lag": ("one_compartment",
                 dict(seq_eq=_depth_seq,
                      lag=lambda p, t, cov: {0: 0.5 * (p[2] - 0.5 + abs(p[2] - 0.5))}),
                 "wt", _K1C_ONE + [(0.0, 1.9)], "lag_seq_depth"),
    # lag_post: main and post slot streams into one plane tensor
    "post_static_lag": ("one_compartment", dict(seq_eq=_tv_seq,
                                                lag=lambda p, t, cov: {0: p[2]}),
                        "wt_tv", _K1C_ONE + [(0.0, 1.8)], "seq_colplanes"),
    "post_dynamic_lag": ("one_compartment",
                         dict(seq_eq=_tv_seq,
                              lag=lambda p, t, cov: {0: p[2] * cov("wt", t) / 120.0}),
                         "wt_tv", _K1C_ONE + [(0.0, 1.5)], "seq_colplanes"),
    # lag and fa that change with time: per-dose-segment slot tables
    "dynamic_lag_fa": ("one_compartment_with_absorption",
                       dict(lag=lambda p, t, cov: {0: p[3] / (1.0 + 0.1 * t)},
                            fa=lambda p, t, cov: {0: p[4] / (1.0 + 0.05 * t)}),
                       None, [(0.8, 2.0), (0.1, 0.3), (8, 15), (0.0, 1.8), (0.5, 1.0)],
                       "one_compartment_with_absorption"),
    "fa_only": ("one_compartment_with_absorption",
                dict(fa=lambda p, t, cov: {0: p[3] * cov("wt", t) / 70.0}),
                "wt_tv", [(0.8, 2.0), (0.1, 0.3), (8, 15), (0.6, 1.0)],
                "one_compartment_with_absorption"),
    "depth_3cmt": ("three_compartments", dict(seq_eq=_three_cmt_lag_seq,
                                              lag=lambda p, t, cov: {0: p[6]}),
                   "wt", [(0.1, 0.3), (0.15, 0.35), (0.05, 0.2), (0.1, 0.3), (0.05, 0.15),
                          (8, 15), (0.0, 1.8)], "lag_seq_depth"),
}
K1C_CASES = {name: row[4] for name, row in _K1C.items()}


def k1c_case(name: str, n_subjects: int = 8, n_support: int = 12, seed: int = 0,
             lib=None):
    """K1c's case ``name`` (see ``K1C_CASES``: name -> the budget row of its
    float32 result): (model, data, support, ems), built with ``lib``
    (default this package; the JAX package builds the same case). The
    single output is the central amount over the volume, the support column
    after the kernel's."""
    import numpy as np

    from ..engine.analytical import KERNELS

    if lib is None:
        import pharmsol_tpu_torch as lib
    structure, closures, cov, ranges, _ = _K1C[name]
    _, n_states, vcol = KERNELS[structure]
    central = 1 if structure.endswith("_with_absorption") else 0
    rng = np.random.RandomState(seed)
    sp = np.column_stack([rng.uniform(lo, hi, n_support) for lo, hi in ranges])
    subjects = []
    for i in range(n_subjects):
        b = lib.Subject.builder(f"k{i}").bolus(0.0, 100.0, 0).infusion(1.0, 50.0, 0, 1.5)
        if i % 2 == 0:
            b = b.bolus(2.0, 60.0, 0)
        if cov is not None:
            b = b.covariate("wt", 0.0, 55.0 + 4.0 * (i % 16))
            if cov == "wt_tv":
                b = b.covariate("wt", 3.0, 60.0 + 3.0 * (i % 16))
        for t in (0.5, 1.2, 2.1, 3.0, 4.5, 6.0, 10.0):
            b = b.observation(t, float(5.0 * np.exp(-0.2 * t) * np.exp(0.1 * rng.randn())), 0)
        subjects.append(b.build())
    model = lib.Analytical(
        getattr(lib, structure),
        out=lambda x, p, t, cov, c=central, v=vcol: x[c:c + 1] / p[v],
        nstates=n_states, ndrugs=1, nout=1, **closures)
    ems = lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))
    return model, lib.Data(subjects), sp, ems


# ---------------------------------------------------------------------------
# Kernel K2e's modes: ODE models with covariates, lag, fa and init
# ---------------------------------------------------------------------------


def _rhs_oral(stack):
    return lambda x, p, t, b, r, cov: stack([
        -p[0] * x[0] + b[0],
        p[0] * x[0] - p[1] * x[1] + r[0],
    ])


def _rhs_wt(stack):
    # allometric elimination: (wt / 70) ** 0.75
    return lambda x, p, t, b, r, cov: stack([
        -p[0] * x[0] + b[0],
        p[0] * x[0] - p[1] * (cov("wt", t) / 70.0) ** 0.75 * x[1] + r[0],
    ])


def _rhs_two_inputs(stack):
    # JAX tests/test_pallas_ode.py:912: two depots into one central state
    return lambda x, p, t, b, r, cov: stack([
        -p[0] * x[0] + b[0],
        -1.3 * p[0] * x[1] + b[1],
        p[0] * x[0] + 1.3 * p[0] * x[1] - p[1] * x[2],
    ])


_KA, _KE, _V = (0.5, 2.0), (0.05, 0.5), (30.0, 90.0)

# name: (rhs, closures, regimen, covariate, extra support ranges, solver,
#        budget row). Regimens: "bolus" 100 at 0; "two_doses" 100 at 0 and 80
# at 6; "infusion" 50 at 0 and 40 over 2 h from 1 h; "two_inputs" 80 into
# input 0 and 50 into input 1 at 0. Covariates: "wt" constant per subject,
# "wt_tv" knots at 0 and 2 h (interpolated, then carried forward), "wt_fixed"
# a carried-forward ("wt!") step at 4 h. The support is ka, ke, v and then
# the extra columns.
_ODE_FEATURES = {
    "cov_const": (_rhs_wt, {}, "bolus", "wt", [], "dopri5", "ode_tv_covariate"),
    "cov_linear": (_rhs_wt, {}, "bolus", "wt_tv", [], "dopri5", "ode_tv_covariate"),
    "cov_fixed": (_rhs_wt, {}, "bolus", "wt_fixed", [], "dopri5", "ode_tv_covariate"),
    "lag": (_rhs_oral, dict(lag=lambda p, t, cov: {0: p[3]}), "two_doses", None,
            [(0.0, 1.5)], "dopri5", "ode_lag_fa"),
    "fa": (_rhs_oral, dict(fa=lambda p, t, cov: {0: p[3]}), "two_doses", None,
           [(0.3, 1.0)], "dopri5", "ode_lag_fa"),
    "lag_fa": (_rhs_oral, dict(lag=lambda p, t, cov: {0: p[3]}, fa=lambda p, t, cov: {0: p[4]}),
               "two_doses", None, [(0.0, 1.5), (0.3, 1.0)], "dopri5", "ode_lag_fa"),
    "lag_infusion": (_rhs_oral, dict(lag=lambda p, t, cov: {0: p[3]}), "infusion", None,
                     [(0.0, 0.9)], "dopri5", "ode_lag_fa"),
    "two_inputs_lag": (_rhs_two_inputs, dict(lag=lambda p, t, cov: {0: p[3], 1: p[4]}),
                       "two_inputs", None, [(0.1, 2.5), (0.1, 2.5)], "dopri5", "ode_lag_fa"),
    "dyn_time": (_rhs_oral, dict(lag=lambda p, t, cov: {0: p[3] / (1.0 + 0.1 * t)},
                                 fa=lambda p, t, cov: {0: p[4] / (1.0 + 0.05 * t)}),
                 "two_doses", None, [(0.0, 1.4), (0.3, 1.0)], "dopri5", "ode_lag_fa"),
    "dyn_cov_lag": (_rhs_oral, dict(lag=lambda p, t, cov: {0: p[3] * cov("wt", t) / 70.0}),
                    "two_doses", "wt_tv", [(0.0, 1.1)], "dopri5", "ode_lag_fa"),
    "init_rows": (_rhs_oral, dict(init=lambda p, t, cov: [0.0, 0.5 * p[2]]), "bolus", None,
                  [], "dopri5", "ode_dopri5"),
    "init_planes": (_rhs_wt, dict(init=lambda p, t, cov: [0.0, p[2] * cov("wt", t) / 140.0]),
                    "bolus", "wt", [], "dopri5", "ode_dopri5"),
    "tsit5_cov": (_rhs_wt, {}, "bolus", "wt_tv", [], "tsit5", "ode_tv_covariate"),
}
ODE_FEATURE_CASES = {name: row[6] for name, row in _ODE_FEATURES.items()}


def ode_feature_case(name: str, n_subjects: int = 6, n_support: int = 12,
                     seed: int = 0, lib=None, stack=None):
    """K2e's case ``name`` (see ``ODE_FEATURE_CASES``: name -> the budget row
    of its float32 result): (model, data, support, ems), built with ``lib``
    (default this package) and ``stack`` (default ``torch.stack``). The
    single output is the central amount over the volume ``p[2]``."""
    import numpy as np

    if lib is None:
        import pharmsol_tpu_torch as lib
    if stack is None:
        import torch

        stack = torch.stack
    rhs, closures, regimen, cov, extra, solver, _ = _ODE_FEATURES[name]
    rng = np.random.RandomState(seed)
    sp = np.column_stack([rng.uniform(lo, hi, n_support) for lo, hi in [_KA, _KE, _V] + extra])
    central = 2 if regimen == "two_inputs" else 1
    times = {"infusion": (0.5, 1.5, 3.0, 5.0),
             "two_inputs": (1.0, 2.0, 3.0, 4.0, 6.0, 8.0)}.get(
        regimen, (0.5, 1.0, 2.0, 4.0, 7.0, 10.0))
    subjects = []
    for i in range(n_subjects):
        b = lib.Subject.builder(f"k{i}")
        if regimen == "infusion":
            b = b.bolus(0.0, 50.0, 0).infusion(1.0, 40.0, 0, 2.0)
        elif regimen == "two_inputs":
            b = b.bolus(0.0, 80.0, 0).bolus(0.0, 50.0, 1)
        else:
            b = b.bolus(0.0, 100.0, 0)
            if regimen == "two_doses":
                b = b.bolus(6.0, 80.0, 0)
        if cov == "wt":
            b = b.covariate("wt", 0.0, 40.0 + 80.0 * rng.rand())
        elif cov == "wt_tv":
            b = (b.covariate("wt", 0.0, 40.0 + 80.0 * rng.rand())
                 .covariate("wt", 2.0, 40.0 + 80.0 * rng.rand()))
        elif cov == "wt_fixed":
            b = (b.covariate("wt!", 0.0, 40.0 + 80.0 * rng.rand())
                 .covariate("wt!", 4.0, 40.0 + 80.0 * rng.rand()))
        for t in times:
            b = b.observation(t, float(1.5 * np.exp(-0.2 * t) * np.exp(0.2 * rng.randn())), 0)
        subjects.append(b.build())
    n_states = 3 if regimen == "two_inputs" else 2
    model = lib.ODE(rhs(stack), out=lambda x, p, t, cov, c=central: x[c:c + 1] / p[2],
                    nstates=n_states, ndrugs=2 if regimen == "two_inputs" else 1, nout=1,
                    **closures).with_solver(solver)
    ems = lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))
    return model, lib.Data(subjects), sp, ems


COVARIATE_MODEL_CENTRE = (0.8, 0.25, 0.2, 50.0)  # ka, ke, tlag, v


def covariate_model_case(n_subjects: int, n_support: int, seed: int = 0, lib=None,
                         stack=None, named: bool = False):
    """The reference's covariate example (``examples/covariates.py:22-37``)
    as a population: a 1-compartment oral ODE whose elimination is scaled by
    ``(creatinine(t) / 75) ** 0.75 * (age / 25) ** 0.5``, an absorption lag
    ``p[2]``, ``cp = x[1] / p[3]``; 100 mg at 0, 2 and 4 h, observations at
    0.5, 1, 2, 2.5 and 8 h. Per subject: creatinine knots at 0 h (uniform
    40-120) and 1 h (0.5-1.0 times that), a constant age (uniform 20-80).
    Supports jittered 15% around ``COVARIATE_MODEL_CENTRE`` (the lag stays
    below the 2 h dose gap). ``named``: the data's route and output are
    ``oral`` and ``cp`` (the example's labels, for its ``ode_model``), else
    input and output 0. Returns (model, data, support, ems)."""
    import numpy as np

    if lib is None:
        import pharmsol_tpu_torch as lib
    if stack is None:
        import torch

        stack = torch.stack
    rng = np.random.RandomState(seed)
    crcl0 = rng.uniform(40.0, 120.0, n_subjects)
    crcl1 = crcl0 * rng.uniform(0.5, 1.0, n_subjects)
    age = rng.uniform(20.0, 80.0, n_subjects)
    noise = np.exp(0.2 * rng.randn(n_subjects, 5))
    oral, cp = ("oral", "cp") if named else (0, 0)
    subjects = []
    for i in range(n_subjects):
        b = (lib.Subject.builder(f"c{i}").bolus(0.0, 100.0, oral).bolus(2.0, 100.0, oral)
             .bolus(4.0, 100.0, oral)
             .covariate("creatinine", 0.0, float(crcl0[i]))
             .covariate("creatinine", 1.0, float(crcl1[i]))
             .covariate("age", 0.0, float(age[i])))
        for j, t in enumerate((0.5, 1.0, 2.0, 2.5, 8.0)):
            b = b.observation(t, float(2.0 * noise[i, j]), cp)
        subjects.append(b.build())
    model = lib.ODE(
        lambda x, p, t, b, r, cov: stack([
            -p[0] * x[0] + b[0],
            p[0] * x[0] - p[1] * (cov("creatinine", t) / 75.0) ** 0.75
            * (cov("age", t) / 25.0) ** 0.5 * x[1],
        ]),
        lag=lambda p, t, cov: {0: p[2]},
        out=lambda x, p, t, cov: x[1:2] / p[3],
        nstates=2, ndrugs=1, nout=1)
    centre = np.asarray(COVARIATE_MODEL_CENTRE)
    sp = np.abs(centre[None, :] * (1.0 + 0.15 * rng.randn(n_support, 4)))
    ems = lib.AssayErrorModels().add(
        cp, lib.AssayErrorModel.additive(lib.ErrorPoly(0.1, 0.1), 1.0))
    return model, lib.Data(subjects), sp, ems


# ---------------------------------------------------------------------------
# Kernel K2d's cases: linear ODE models with ``.with_solver("expm")``
# ---------------------------------------------------------------------------


def _rhs_transit(stack):
    # examples/expm_linear_ode.py: transit1 -> transit2 -> central <->
    # {periph1, periph2}; p = ktr, ke, k13, k31, k14, k41, v
    return lambda x, p, t, b, r, cov: stack([
        -p[0] * x[0] + b[0],
        p[0] * x[0] - p[0] * x[1],
        p[0] * x[1] - (p[1] + p[2] + p[4]) * x[2] + p[3] * x[3] + p[5] * x[4] + r[0],
        p[2] * x[2] - p[3] * x[3],
        p[4] * x[2] - p[5] * x[4],
    ])


def _rhs_short(stack):
    # 2-cmt oral as an ODE; p = ke, ka, kcp, kpc, v, the closed form's order
    return lambda x, p, t, b, r, cov: stack([
        -p[1] * x[0] + b[0],
        p[1] * x[0] - (p[0] + p[2]) * x[1] + p[3] * x[2] + r[0],
        p[2] * x[1] - p[3] * x[2],
    ])


def _rhs_step(stack):
    # elimination switched by a carried-forward covariate
    return lambda x, p, t, b, r, cov: stack([
        -p[0] * x[0] + b[0],
        p[0] * x[0] - p[1] * (1.0 + 0.5 * cov("phase", t)) * x[1],
    ])


TRANSIT_CENTRE = (2.0, 0.12, 0.25, 0.15, 0.08, 0.05, 15.0)
SHORT_CENTRE = (0.15, 1.2, 0.3, 0.2, 10.0)

# name: what the case holds (the models of the JAX package's
# tests/test_pallas_ode.py:189-292, tests/test_solvers.py:101 and
# examples/expm_linear_ode.py)
EXPM_CASES = {
    "two_cmt": "2-state oral, a bolus and an infusion on every third subject",
    "short": "2-cmt oral as a 3-state ODE, a bolus and an infusion",
    "transit": "5-state transit chain and mammillary model, a bolus and an infusion",
    "lag_fa": "2-state oral with lag and fa, two boluses",
    "step_covariate": "2-state oral, elimination switched by a carried-forward covariate",
    "init_two_outputs": "2-state oral with an initial state and two outputs",
    "poison": "two_cmt with a last segment whose scaled norm passes 2^16 on every "
              "other subject: those rows are -inf",
}


def expm_case(name: str, n_subjects: int = 6, n_support: int = 12, seed: int = 0,
              lib=None, stack=None):
    """K2d's case ``name`` (see ``EXPM_CASES``): (model, data, support, ems)
    with ``.with_solver("expm")``, built with ``lib`` (default this package)
    and ``stack`` (default ``torch.stack``)."""
    import numpy as np

    if lib is None:
        import pharmsol_tpu_torch as lib
    if stack is None:
        import torch

        stack = torch.stack
    rng = np.random.RandomState(seed)
    S = n_support
    ems = lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))
    oral = [rng.uniform(lo, hi, S) for lo, hi in (_KA, _KE, _V)]
    closures, nstates, nout, central, vol = {}, 2, 1, 1, 2
    rhs, sp = _rhs_oral, np.column_stack(oral)
    if name == "short":
        rhs, nstates, vol = _rhs_short, 3, 4
        sp = np.abs(np.asarray(SHORT_CENTRE)[None, :] * (1.0 + 0.2 * rng.randn(S, 5)))
    elif name == "transit":
        rhs, nstates, central, vol = _rhs_transit, 5, 2, 6
        sp = np.abs(np.asarray(TRANSIT_CENTRE)[None, :] * (1.0 + 0.2 * rng.randn(S, 7)))
    elif name == "lag_fa":
        closures = dict(lag=lambda p, t, cov: {0: p[3]}, fa=lambda p, t, cov: {0: p[4]})
        sp = np.column_stack(oral + [rng.uniform(0.0, 1.5, S), rng.uniform(0.3, 1.0, S)])
    elif name == "step_covariate":
        rhs = _rhs_step
    elif name == "init_two_outputs":
        closures = dict(init=lambda p, t, cov: [0.0, p[3]])
        sp = np.column_stack(oral + [rng.uniform(0.0, 10.0, S)])
        nout = 2
        ems = ems.add(1, lib.AssayErrorModel.additive(lib.ErrorPoly(1.0, 0.05), 1.0))
    elif name not in ("two_cmt", "poison"):
        raise KeyError(name)
    subjects = []
    for i in range(n_subjects):
        b = lib.Subject.builder(f"e{i}").bolus(0.0, 100.0, 0)
        if name in ("two_cmt", "poison") and i % 3 == 0:
            b = b.infusion(2.0, 50.0, 0, 1.0)
        if name in ("short", "transit"):
            b = b.infusion(6.0, 50.0, 0, 2.0)
        if name == "lag_fa":
            b = b.bolus(6.0, 80.0, 0)
        if name == "step_covariate":
            b = b.covariate("phase!", 0.0, 0.0).covariate("phase!", 3.0, float(i % 3))
        times = {"transit": (0.5, 1.0, 2.0, 4.0, 8.0, 12.0, 24.0),
                 "short": (0.5, 2.0, 4.0, 7.0, 8.0, 12.0),
                 "lag_fa": (0.5, 1.0, 2.0, 4.0, 7.0, 10.0),
                 "step_covariate": (1.0, 3.0, 5.0, 9.0),
                 "init_two_outputs": (0.5, 2.0, 6.0)}.get(name, (0.5, 1.0, 2.0, 4.0, 8.0))
        for t in times:
            b = b.observation(t, float(3.0 * np.exp(-0.2 * t) * np.exp(0.2 * rng.randn())), 0)
            if nout == 2:
                b = b.observation(t + 0.25, float(30.0 * np.exp(-0.9 * t)
                                                  * np.exp(0.2 * rng.randn())), 1)
        if name == "poison" and i % 2 == 1:
            b = b.observation(3.0e5, 0.1, 0)
        subjects.append(b.build())
    if nout == 2:
        out = lambda x, p, t, cov: stack([x[1] / p[2], x[0]])  # noqa: E731
    else:
        out = lambda x, p, t, cov, c=central, v=vol: x[c:c + 1] / p[v]  # noqa: E731
    model = lib.ODE(rhs(stack), out=out, nstates=nstates, ndrugs=1, nout=nout,
                    **closures).with_solver("expm")
    return model, lib.Data(subjects), sp, ems


# ---------------------------------------------------------------------------
# Kernels K2b and K2c: ODE models with a stiff solver
# ---------------------------------------------------------------------------


def _rhs_binding(stack):
    # a 2-state target-binding model: p = kel, v, kon, ksyn, kdeg
    return lambda x, p, t, b, r, cov: stack([
        -p[0] * x[0] - p[2] * x[0] * x[1] + b[0],
        p[3] - p[4] * x[1] - p[2] * x[0] * x[1],
    ])


def _rhs_michaelis_menten(stack):
    # dx = -vmax x / (km + x): zero order above km, first order below
    return lambda x, p, t, b, r, cov: stack([
        -p[0] * x[0] / (p[1] + x[0]) + b[0] + r[0],
    ])


def _rhs_tmdd(stack):
    # full TMDD: drug L, target R, complex P; p = kel, kon, koff, ksyn, kdeg,
    # kint, v. kon separates the time scales by about 1e3
    def diffeq(x, p, t, b, r, cov):
        bind = p[1] * x[0] * x[1] - p[2] * x[2]
        return stack([
            -p[0] * x[0] - bind + b[0] + r[0],
            p[3] - p[4] * x[1] - bind,
            bind - p[5] * x[2],
        ])
    return diffeq


TMDD_CENTRE = (0.1, 100.0, 0.1, 1.0, 0.1, 0.5, 5.0)  # kel kon koff ksyn kdeg kint v
MM_CENTRE = (80.0, 0.05, 10.0)                       # vmax, km, v
TMDD_TIMES = (0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 24.0, 48.0)

# name: what the case holds (the models of the JAX package's
# tests/test_pallas_ode.py:452-499, :725-774, tests/test_stiff.py:21-83 and
# benches/stiff_bench.py:45-72)
STIFF_CASES = {
    "two_cmt": "2-state oral with a fast absorption, a bolus and an infusion on "
               "every third subject",
    "binding_init": "2-state target binding with the target at steady state (init)",
    "separated_rates": "2-state oral, ka up to 500/h against ke ~ 0.3/h",
    "lag_infusion": "2-state oral with a lag, a bolus and an infusion",
    "michaelis_menten": "saturable elimination, km far below the concentrations, "
                        "a bolus and an infusion",
    "tmdd": "full 3-state TMDD with init: the stiff corpus",
    "cov_affine": "2-state oral, elimination scaled by a weight with knots at 0 and 2 h",
    "two_outputs_cens": "2-state oral with init, two outputs and a BLOQ observation",
    "poison": "tmdd with kon over three decades, every other subject undosed, and a "
              "step budget too small for the dosed subjects' stiffest supports: those "
              "cells are -inf",
}
# trial budgets per segment between what an undosed subject needs to ramp its
# step up from h0 and what the dosed subjects' stiffest supports need
POISON_MAX_STEPS = {"kvaerno5": 32}
POISON_MAX_STEPS_DEFAULT = 48


def stiff_case(name: str, n_subjects: int = 6, n_support: int = 12, seed: int = 0,
               lib=None, stack=None, solver: str = "bdf"):
    """K2b's and K2c's case ``name`` (see ``STIFF_CASES``): (model, data,
    support, ems) with ``.with_solver(solver)``, built with ``lib`` (default
    this package) and ``stack`` (default ``torch.stack``); observed values
    and supports come from ``seed``."""
    import numpy as np

    if lib is None:
        import pharmsol_tpu_torch as lib
    if stack is None:
        import torch

        stack = torch.stack
    if name not in STIFF_CASES:
        raise KeyError(f"no stiff case `{name}` (have {', '.join(STIFF_CASES)})")
    rng = np.random.RandomState(seed)
    S = n_support
    ems = lib.AssayErrorModels().add(
        0, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))
    closures, nstates, nout = {}, 2, 1
    out = lambda x, p, t, cov: x[1:2] / p[2]  # noqa: E731
    rhs = _rhs_oral
    times = (0.5, 1.0, 2.0, 4.0, 8.0)
    if name == "two_cmt":
        sp = np.column_stack([rng.uniform(5.0, 20.0, S), rng.uniform(0.05, 0.5, S),
                              rng.uniform(30, 90, S)])
    elif name == "binding_init":
        rhs = _rhs_binding
        closures = dict(init=lambda p, t, cov: [0.0, p[3] / p[4]])
        out = lambda x, p, t, cov: x[0:1] / p[1]  # noqa: E731
        times = (0.25, 1.0, 4.0, 12.0, 24.0)
        sp = np.column_stack([rng.uniform(0.05, 0.2, S), rng.uniform(3.0, 6.0, S),
                              rng.uniform(1.0, 5.0, S), rng.uniform(1.0, 3.0, S),
                              rng.uniform(0.5, 2.0, S)])
    elif name == "separated_rates":
        out = lambda x, p, t, cov: x[1:2]  # noqa: E731
        times = (0.1, 0.5, 1.0, 3.0, 8.0)
        sp = np.column_stack([np.exp(rng.uniform(np.log(20.0), np.log(500.0), S)),
                              rng.uniform(0.2, 0.5, S)])
    elif name == "lag_infusion":
        rhs = lambda st: (lambda x, p, t, b, r, cov: st([  # noqa: E731
            -p[0] * x[0] + b[0] + r[0], p[0] * x[0] - p[1] * x[1]]))
        closures = dict(lag=lambda p, t, cov: {0: p[3]})
        times = (0.5, 1.0, 2.5, 4.0, 7.0)
        sp = np.column_stack([rng.uniform(0.5, 2.0, S), rng.uniform(0.05, 0.5, S),
                              rng.uniform(30, 90, S), rng.uniform(0.0, 1.2, S)])
    elif name == "michaelis_menten":
        rhs, nstates = _rhs_michaelis_menten, 1
        out = lambda x, p, t, cov: x[0:1] / p[2]  # noqa: E731
        times = (0.5, 1.0, 2.0, 4.0, 8.0, 12.5, 14.0, 20.0, 30.0)
        sp = np.asarray(MM_CENTRE)[None, :] * rng.uniform(0.7, 1.3, (S, 3))
    elif name in ("tmdd", "poison"):
        rhs, nstates = _rhs_tmdd, 3
        closures = dict(init=lambda p, t, cov: [0.0, p[3] / p[4], 0.0])
        out = lambda x, p, t, cov: x[0:1] / p[6]  # noqa: E731
        times = TMDD_TIMES
        sp = np.asarray(TMDD_CENTRE)[None, :] * rng.uniform(0.7, 1.3, (S, 7))
        if name == "poison":
            # binding rates over three decades: the stiffest supports need
            # more trials in a segment than the budget allows
            sp[:, 1] = TMDD_CENTRE[1] * np.exp(rng.uniform(np.log(1e-3), np.log(3.0), S))
    elif name == "cov_affine":
        rhs = _rhs_wt
        times = (0.5, 1.0, 2.0, 4.0, 7.0, 10.0)
        sp = np.column_stack([rng.uniform(lo, hi, S) for lo, hi in (_KA, _KE, _V)])
    else:  # two_outputs_cens
        closures = dict(init=lambda p, t, cov: [0.0, p[3]])
        nout = 2
        out = lambda x, p, t, cov: stack([x[1] / p[2], x[0]])  # noqa: E731
        times = (0.5, 2.0, 6.0)
        sp = np.column_stack([rng.uniform(lo, hi, S) for lo, hi in (_KA, _KE, _V)]
                             + [rng.uniform(0.0, 10.0, S)])
        ems = ems.add(1, lib.AssayErrorModel.additive(lib.ErrorPoly(1.0, 0.05), 1.0))
    subjects = []
    for i in range(n_subjects):
        b = lib.Subject.builder(f"q{i}")
        if name == "michaelis_menten":
            b = b.bolus(0.0, 500.0, 0).infusion(12.0, 300.0, 0, 2.0)
        elif name == "tmdd" or (name == "poison" and i % 2 == 1):
            b = b.bolus(0.0, 100.0 * (1 + 0.1 * (i % 5)), 0)
        elif name == "poison":
            pass  # no dose: the target rests at its steady state, every cell finishes
        elif name == "binding_init":
            b = b.bolus(0.0, 50.0, 0)
        elif name == "separated_rates":
            b = b.bolus(0.0, 50.0, 0)
        elif name == "lag_infusion":
            b = b.bolus(0.0, 100.0, 0).infusion(2.0, 40.0, 0, 1.5)
        else:
            b = b.bolus(0.0, 100.0, 0)
            if name == "two_cmt" and i % 3 == 0:
                b = b.infusion(2.0, 50.0, 0, 1.0)
        if name == "cov_affine":
            b = (b.covariate("wt", 0.0, 40.0 + 80.0 * rng.rand())
                 .covariate("wt", 2.0, 40.0 + 80.0 * rng.rand()))
        for t in times:
            b = b.observation(t, float(3.0 * np.exp(-0.2 * t) * np.exp(0.2 * rng.randn())), 0)
            if nout == 2:
                b = b.observation(t + 0.25, float(30.0 * np.exp(-0.9 * t)
                                                  * np.exp(0.2 * rng.randn())), 1)
        if name == "two_outputs_cens":
            b = b.censored_observation(9.0, 0.2, 0, lib.Censor.BLOQ)
        subjects.append(b.build())
    model = lib.ODE(rhs(stack), out=out, nstates=nstates, ndrugs=1, nout=nout,
                    **closures).with_solver(solver)
    if name == "poison":
        model = model.with_max_steps(POISON_MAX_STEPS.get(solver, POISON_MAX_STEPS_DEFAULT))
    return model, lib.Data(subjects), sp, ems


def population_10k_case(n_subjects: int = 10000, seed: int = 7, lib=None,
                        named: bool = False):
    """The data of the JAX package's population fit
    (``benches/population_10k.py --fit``) rebuilt from numpy alone, in the
    same draw order from ``RandomState(seed)``: a bimodal 1-compartment oral
    population (ke around 0.08 or 0.35, ka around 1.2, v around 30), 100 mg
    at 0, 9 observations over 12 h with 10% proportional and 0.05 additive
    noise, and the proportional error model the fit uses. ``named``: the
    route and output are ``oral`` and ``cp`` (for a model written through
    the authoring surfaces), else input and output 0. Returns (data, ems,
    seconds to build the subjects); the models of the fit are
    :func:`population_models`."""
    import time

    import numpy as np

    if lib is None:
        import pharmsol_tpu_torch as lib
    N = n_subjects
    rng = np.random.RandomState(seed)
    ke = np.where(rng.rand(N) < 0.5, 0.08, 0.35) * np.exp(0.1 * rng.randn(N))
    ka = 1.2 * np.exp(0.1 * rng.randn(N))
    v = 30.0 * np.exp(0.15 * rng.randn(N))
    times = np.array([0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0])
    ka_, ke_, v_, t_ = ka[:, None], ke[:, None], v[:, None], times[None, :]
    conc = 100.0 * ka_ / (ka_ - ke_) * (np.exp(-ke_ * t_) - np.exp(-ka_ * t_)) / v_
    noisy = np.abs(conc * (1.0 + 0.1 * rng.randn(N, len(times)))
                   + 0.05 * rng.randn(N, len(times)))
    oral, cp = ("oral", "cp") if named else (0, 0)
    t0 = time.perf_counter()
    subjects = []
    for i in range(N):
        b = lib.Subject.builder(f"s{i}").bolus(0.0, 100.0, oral)
        for j, t in enumerate(times):
            b = b.observation(float(t), float(noisy[i, j]), cp)
        subjects.append(b.build())
    data = lib.Data(subjects)
    ems = lib.AssayErrorModels().add(
        cp, lib.AssayErrorModel.proportional(lib.ErrorPoly(0.1, 0.1), 1.0))
    return data, ems, time.perf_counter() - t0


POPULATION_RANGES = [(0.3, 4.0), (0.03, 0.8), (8.0, 90.0)]  # ka, ke, v


def population_models(lib=None, stack=None):
    """(closed form, linear ODE with ``expm``) of the population fit: the
    1-compartment oral model with p = ka, ke, v, once as the closed-form
    kernel and once written as an ODE."""
    if lib is None:
        import pharmsol_tpu_torch as lib
    if stack is None:
        import torch

        stack = torch.stack
    out = lambda x, p, t, cov: x[1:2] / p[2]  # noqa: E731
    closed = lib.Analytical(lib.one_compartment_with_absorption, out=out,
                            nstates=2, ndrugs=1, nout=1)
    ode = lib.ODE(_rhs_oral(stack), out=out, nstates=2, ndrugs=1, nout=1).with_solver("expm")
    return closed, ode


# ---------------------------------------------------------------------------
# Kernel K3b's modes: SDE models with covariates, lag, fa and init
# ---------------------------------------------------------------------------


def _drift_oral(stack):
    # depot -> central, elimination ke; p = ka, ke, v, sigma, ...
    return lambda x, p, t, r, cov: stack([-p[0] * x[0], p[0] * x[0] - p[1] * x[1] + r[0]])


def _drift_wt(stack):
    return lambda x, p, t, r, cov: stack([
        -p[0] * x[0], p[0] * x[0] - p[1] * (cov("wt", t) / 70.0) ** 0.75 * x[1]])


def _drift_two_inputs(stack):
    # input 0 doses the depot, input 1 injects into central (its route)
    return lambda x, p, t, r, cov: stack([-p[0] * x[0], p[0] * x[0] - p[1] * x[1]])


_SDE_SIGMA = (0.002, 0.02)

# name: (drift, closures, regimen, covariate, extra support ranges). The
# support is ka, ke, v, sigma (the central state's diffusion, small: before a
# lagged dose fires the state is zero, where the Euler-Maruyama controller
# takes steps of the noise's size), the extra columns, then unused ones up
# to six. Regimens: "bolus" 100 at 0; "two_doses" 100 at 0 and 60 at
# 1 h; "two_inputs" 80 into input 0 at 0 and 50 into input 1 at 0.5 h.
# Covariates: "wt" constant per subject, "wt_tv" knots at 0 and 0.5 h.
# Observations at 0.25, 0.5, 1 and 1.5 h: the twin's masked loop takes as
# many iterations as the slowest cell takes trials, so the spans stay short.
# Every dose time is an observation time too: the fused kernel restarts its
# step controller at a dose's own time and again at its fire, the general
# engine only at the fire, so the two agree at zero diffusion (to rounding,
# in both packages) only where the dose's time is a breakpoint anyway
# (tests/test_torch_sde_features_offgrid.py pins the gap off the grid).
_SDE_FEATURES = {
    "cov_const": (_drift_wt, {}, "bolus", "wt", []),
    "cov_affine": (_drift_wt, {}, "bolus", "wt_tv", []),
    "lag": (_drift_oral, dict(lag=lambda p, t, cov: {0: p[4]}), "two_doses", None,
            [(0.0, 0.6)]),
    "fa": (_drift_oral, dict(fa=lambda p, t, cov: {0: p[4]}), "two_doses", None,
           [(0.3, 1.0)]),
    "lag_fa": (_drift_oral, dict(lag=lambda p, t, cov: {0: p[4]},
                                 fa=lambda p, t, cov: {0: p[5]}),
               "two_doses", None, [(0.0, 0.6), (0.3, 1.0)]),
    "dyn_lag_fa": (_drift_oral, dict(lag=lambda p, t, cov: {0: p[4] / (1.0 + 0.1 * t)},
                                     fa=lambda p, t, cov: {0: p[5] / (1.0 + 0.05 * t)}),
                   "two_doses", None, [(0.0, 0.6), (0.3, 1.0)]),
    "init_rows": (_drift_oral, dict(init=lambda p, t, cov: [0.0, 0.5 * p[2]]), "bolus",
                  None, []),
    "init_planes": (_drift_wt, dict(init=lambda p, t, cov: [0.0, p[2] * cov("wt", t) / 140.0]),
                    "bolus", "wt", []),
    "two_inputs_inject": (_drift_two_inputs,
                          dict(lag=lambda p, t, cov: {0: p[4], 1: p[5]}),
                          "two_inputs", None, [(0.0, 0.4), (0.0, 0.4)]),
}
SDE_FEATURE_CASES = tuple(_SDE_FEATURES)
_SDE_COLUMNS = 6


def sde_feature_case(name: str, n_subjects: int = 4, n_support: int = 8,
                     seed: int = 0, lib=None, stack=None, nparticles: int = 32,
                     sigma: bool = True):
    """K3b's case ``name`` (see ``SDE_FEATURE_CASES``): (model, data,
    support, ems), built with ``lib`` (default this package) and ``stack``
    (default ``torch.stack``). ``sigma=False`` zeroes the diffusion column
    (the engines then agree to rounding). The output is the central amount
    over the volume ``p[2]``."""
    import importlib

    import numpy as np

    if lib is None:
        import pharmsol_tpu_torch as lib
    if stack is None:
        import torch

        stack = torch.stack
    drift, closures, regimen, cov, extra = _SDE_FEATURES[name]
    rng = np.random.RandomState(seed)
    # every case has six columns (unused ones last), so that the cases with
    # one drift share one generated header, hence one library
    ranges = [_KA, _KE, _V, _SDE_SIGMA] + extra
    ranges += [(0.5, 1.0)] * (_SDE_COLUMNS - len(ranges))
    sp = np.column_stack([rng.uniform(lo, hi, n_support) for lo, hi in ranges])
    if not sigma:
        sp[:, 3] = 0.0
    labels = ("oral", "iv") if regimen == "two_inputs" else (0, 0)
    subjects = []
    for i in range(n_subjects):
        b = lib.Subject.builder(f"q{i}").bolus(0.0, 80.0 if regimen == "two_inputs" else 100.0,
                                               labels[0])
        if regimen == "two_doses":
            b = b.bolus(1.0, 60.0, 0)
        elif regimen == "two_inputs":
            b = b.bolus(0.5, 50.0, labels[1])
        if cov == "wt":
            b = b.covariate("wt", 0.0, 40.0 + 80.0 * rng.rand())
        elif cov == "wt_tv":
            b = (b.covariate("wt", 0.0, 40.0 + 80.0 * rng.rand())
                 .covariate("wt", 0.5, 40.0 + 80.0 * rng.rand()))
        for t in (0.25, 0.5, 1.0, 1.5):
            b = b.observation(t, float(1.5 * np.exp(-0.2 * t) * np.exp(0.2 * rng.randn())),
                              "cp" if regimen == "two_inputs" else 0)
        subjects.append(b.build())
    model = lib.SDE(drift(stack), lambda p, t, cov: [0.0, p[3]],
                    out=lambda x, p, t, cov: x[1:2] / p[2], nparticles=nparticles,
                    nstates=2, ndrugs=2 if regimen == "two_inputs" else 1, nout=1,
                    seed=11, **closures)
    label = 0
    if regimen == "two_inputs":
        md = importlib.import_module(lib.__name__ + ".metadata")
        model = model.with_metadata(
            md.new("two_inputs").parameters(["ka", "ke", "v", "sigma", "lag0", "lag1"])
            .states(["depot", "central"]).outputs(["cp"])
            .route(md.Route.bolus("oral").to_state("depot"))
            .route(md.Route.bolus("iv").to_state("central").inject_input_to_destination())
            .particles(nparticles))
        label = "cp"
    ems = lib.AssayErrorModels().add(
        label, lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))
    return model, lib.Data(subjects), sp, ems


SDE_COVARIATE_CENTRE = (0.8, 0.25, 0.2, 50.0)  # ka, ke, tlag, v
SDE_COVARIATE_SIGMA = (0.02, 0.2)


def sde_covariate_model_case(n_subjects: int, n_support: int, seed: int = 0, lib=None,
                             stack=None, nparticles: int = 1000):
    """The reference's covariate example (``examples/covariates.py:22-37``)
    written as an SDE: states gut and central, the drift ``ka`` and ``ke *
    (creatinine(t) / 75) ** 0.75 * (age / 25) ** 0.5``, a lag ``p[2]``, the
    diffusion ``[0, p[4]]`` on central, ``cp = x[1] / p[3]``; the data and
    covariates of :func:`covariate_model_case` (100 mg at 0, 2 and 4 h,
    observations at 0.5, 1, 2, 2.5 and 8 h, creatinine knots at 0 and 1 h, a
    constant age), drawn from ``seed``. Supports jittered 15% around
    ``SDE_COVARIATE_CENTRE`` with sigma uniform in ``SDE_COVARIATE_SIGMA``.
    Returns (model, data, support, ems)."""
    import numpy as np

    if lib is None:
        import pharmsol_tpu_torch as lib
    if stack is None:
        import torch

        stack = torch.stack
    _, data, _, ems = covariate_model_case(n_subjects, 1, seed, lib=lib, stack=stack)
    rng = np.random.RandomState(seed + 1)
    centre = np.asarray(SDE_COVARIATE_CENTRE)
    sp = np.column_stack([np.abs(centre[None, :] * (1.0 + 0.15 * rng.randn(n_support, 4))),
                          rng.uniform(*SDE_COVARIATE_SIGMA, n_support)])
    model = lib.SDE(
        drift=lambda x, p, t, r, cov: stack([
            -p[0] * x[0],
            p[0] * x[0] - p[1] * (cov("creatinine", t) / 75.0) ** 0.75
            * (cov("age", t) / 25.0) ** 0.5 * x[1],
        ]),
        diffusion=lambda p, t, cov: [0.0, p[4]],
        lag=lambda p, t, cov: {0: p[2]},
        out=lambda x, p, t, cov: x[1:2] / p[3],
        nparticles=nparticles, nstates=2, ndrugs=1, nout=1, seed=17)
    return model, data, sp, ems
