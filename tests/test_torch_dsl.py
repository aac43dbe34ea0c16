"""DSL-compiled models of the port against the JAX package's.

The same DSL text goes through ``compile_model`` (or
``compile_module_source_to_runtime``) of both packages; the compiled models'
``info()`` dicts are equal, and their predictions and
``estimate_log_likelihood`` on the same subject agree within 1e-10 relative
(an SDE at zero diffusion within 1e-9), on the CPU in float64. The sources
are the JAX package's DSL tests' (``tests/test_dsl.py``,
``test_dsl_extras.py``), one case each: an analytical model with lag and
fa, one with a derived kernel input, an ODE with a covariate, lag, fa and
an infusion route, an SDE, the canonical syntax, the ``t`` keyword, and
route properties desugared to lag and fa. The statements (``if``, ``for``,
constants, modules, array states) are ``test_torch_dsl_statements.py``'s.
"""

import numpy as np
import pytest

import pharmsol_tpu as pst
import pharmsol_tpu_torch as pt
from pharmsol_tpu.dsl import compile_module_source_to_runtime as jax_compile
from pharmsol_tpu_torch.dsl import compile_module_source_to_runtime as torch_compile

from test_dsl import ANALYTICAL_SRC, ODE_SRC, SDE_SRC


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


DERIVED_SRC = """
name = one_cmt_cl_derived
kind = analytical
params = cl, vol
states = central
derived = ke
outputs = cp
infusion(iv) -> central
ke = cl / vol
structure = one_compartment
out(cp) = central / vol
"""

CANONICAL_SRC = """
model demo {
    kind ode
    parameters { ke, v }
    states { central }
    routes { bolus iv -> central }
    dynamics { dx(central) = -ke * central }
    outputs { out(cp) = central / v }
}
"""

T_KEYWORD_SRC = """
name = clock
kind = ode
params = ke
states = central
outputs = cp

bolus(iv) -> central

dx(central) = -ke * central
out(cp) = t
"""

ROUTE_PROPS_SRC = """
model m {
  kind ode
  parameters { ka, ke, v, tlag }
  states { depot, central }
  routes { bolus oral -> depot { lag = tlag, fa = 0.8 } }
  dynamics {
    dx(depot) = -ka * depot
    dx(central) = ka * depot - ke * central
  }
  outputs { out(cp) = central / v }
}
"""

SDE_ZERO_SRC = SDE_SRC.replace("particles = 64", "particles = 16")


def _regimen(route="oral", infusion=False, covariate=False, times=(1.0, 4.0, 12.0)):
    """(events builder of a package) for one subject: 100 into ``route`` at
    0 (an infusion of 50 over 2 h into ``iv`` at 6 h with ``infusion``, a
    weight with two knots with ``covariate``), observations of ``cp``."""

    def build(lib):
        b = lib.Subject.builder("s1")
        if route == "iv_infusion":
            b = b.infusion(0.0, 100.0, "iv", 2.0)
        else:
            b = b.bolus(0.0, 100.0, route)
        if infusion:
            b = b.infusion(6.0, 50.0, "iv", 2.0)
        if covariate:
            b = b.covariate("wt", 0.0, 80.0).covariate("wt", 12.0, 70.0)
        for i, t in enumerate(times):
            b = b.observation(t, 1.0 + 0.5 * i, "cp")
        return b.build()

    return build


# name: (source, model name in the module, subject builder, parameters)
CASES = {
    "analytical_lag_fa": (ANALYTICAL_SRC, None, _regimen(), [1.0, 0.15, 25.0, 0.5, 0.8]),
    "analytical_derived_kernel_input": (DERIVED_SRC, None, _regimen("iv_infusion", times=(1.0, 3.0)),
                                        [2.0, 20.0]),
    "ode_covariate_lag_fa_infusion": (ODE_SRC, None,
                                      _regimen(infusion=True, covariate=True,
                                               times=(1.0, 4.0, 7.0, 13.0, 24.0)),
                                      [1.2, 5.0, 40.0, 0.5, 0.8]),
    "sde_zero_diffusion": (SDE_ZERO_SRC, "sde_decay", _regimen("iv", times=(1.0, 2.0)),
                           [0.2, 10.0, 0.0]),
    "canonical": (CANONICAL_SRC, None, _regimen("iv", times=(1.0, 3.0)), [0.3, 2.0]),
    "t_keyword": (T_KEYWORD_SRC, None, _regimen("iv", times=(0.25, 1.5, 3.75, 9.0)), [0.3]),
    "route_properties": (ROUTE_PROPS_SRC, None, _regimen(times=(1.0, 4.0)),
                         [1.2, 0.2, 10.0, 0.5]),
}


def _labels(src):
    """The transit sources name their output `y`; the rest `cp`."""
    return src.replace("out(y)", "out(cp)").replace("outputs = y", "outputs = cp")


def check_against_jax(src, name, subject, params):
    """``src`` compiled by both packages: the same ``info()``, predictions
    and log-likelihood of ``subject`` (a builder taking the package)."""
    src = _labels(src)
    want_rt = jax_compile(src, name=name)
    got_rt = torch_compile(src, name=name)
    assert got_rt.info() == want_rt.info()
    assert got_rt.kind == want_rt.kind

    tol = 1e-9 if got_rt.kind == "sde" else 1e-10
    want = np.asarray(want_rt.estimate_predictions(subject(pst), params).flat_predictions())
    got = np.asarray(got_rt.estimate_predictions(subject(pt), params).flat_predictions())
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-13)

    def ems(lib):
        return lib.AssayErrorModels().add(
            "cp", lib.AssayErrorModel.additive(lib.ErrorPoly(0.5, 0.1), 1.0))

    ll_want = want_rt.estimate_log_likelihood(subject(pst), params, ems(pst))
    ll_got = got_rt.estimate_log_likelihood(subject(pt), params, ems(pt))
    np.testing.assert_allclose(ll_got, ll_want, rtol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dsl_model_matches_the_jax_package(case):
    check_against_jax(*CASES[case])
