"""DSL statements in the port against the JAX package: ``if`` (in the
derive block, taken and not taken, and the JAX package's ``if``
Michaelis-Menten model), constants and ``for`` loops, a two-model module,
and array states with transit chains (canonical, flat, mixed), each
compiled by both packages and held as ``test_torch_dsl.py`` holds its cases
(``info()`` equal, predictions and log-likelihood within 1e-10 relative,
float64 on the CPU). The sources are those of ``tests/test_dsl.py``,
``test_dsl_extras.py`` and ``test_dsl_arrays.py``.
"""

import pytest

import pharmsol_tpu_torch as pt

from test_dsl_arrays import TRANSIT_CANONICAL, TRANSIT_FLAT
from test_torch_dsl import _regimen, check_against_jax


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


IF_DERIVE_SRC = """
model cond {
    kind ode
    parameters { ke, switch_t }
    states { central }
    derived { k_eff }
    routes { bolus iv -> central }
    derive {
        k_eff = ke
        if t > switch_t { k_eff = ke * 2.0 }
    }
    dynamics { dx(central) = -k_eff * central }
    outputs { out(cp) = central }
}
"""

IF_MM_SRC = """
model mm {
    kind ode
    parameters { vmax, km, v }
    states { central }
    routes { bolus iv -> central }
    dynamics {
        let conc = central / v
        if conc > km { dx(central) = -vmax * central / (km + conc) }
        else { dx(central) = -0.5 * vmax * central / (km + conc) }
    }
    outputs { out(cp) = central / v }
}
"""

CONSTANTS_FOR_SRC = """
model accum {
    kind ode
    parameters { ke }
    constants { base = 2.0, scale = base * 3.0 }
    states { central }
    derived { boost }
    routes { bolus iv -> central }
    derive {
        boost = 0.0
        for i in 0..3 { boost = boost + scale }
    }
    dynamics { dx(central) = -ke * central * 0.0 }
    outputs { out(cp) = central + boost }
}
"""

TWO_MODELS_SRC = """
model a { kind ode
  parameters { ke } states { c } routes { bolus iv -> c }
  dynamics { dx(c) = -ke * c } outputs { out(cp) = c } }
model b { kind ode
  parameters { ke } states { c } routes { bolus iv -> c }
  dynamics { dx(c) = -2.0 * ke * c } outputs { out(cp) = c } }
"""

MIXED_ARRAY_SRC = """
model mixed {
  kind ode
  parameters { ktr, ke, v }
  states { tr[2], central }
  routes { bolus oral -> tr[0] }
  dynamics {
    dx(tr[0]) = -ktr * tr[0]
    dx(tr[1]) = ktr * (tr[0] - tr[1])
    dx(central) = ktr * tr[1] - ke * central
  }
  outputs { out(cp) = central / v }
}
"""

# name: (source, model name in the module, subject builder, parameters)
CASES = {
    "if_derive_not_taken": (IF_DERIVE_SRC, None, _regimen("iv", times=(1.0, 3.0)),
                            [0.2, 100.0]),
    "if_derive_taken": (IF_DERIVE_SRC, None, _regimen("iv", times=(1.0, 3.0, 5.0)),
                        [0.2, 2.0]),
    "if_michaelis_menten": (IF_MM_SRC, None, _regimen("iv", times=(2.0, 6.0)),
                            [5.0, 2.0, 10.0]),
    "constants_for": (CONSTANTS_FOR_SRC, None, _regimen("iv", times=(1.0,)), [0.1]),
    "two_models_b": (TWO_MODELS_SRC, "b", _regimen("iv", times=(1.0, 2.0)), [0.3]),
    "transit_canonical": (TRANSIT_CANONICAL, None, _regimen(times=(1.0, 2.0, 6.0)),
                          [1.8, 0.3, 25.0]),
    "transit_flat": (TRANSIT_FLAT, None, _regimen(times=(1.0, 2.0, 6.0)), [1.8, 0.3, 25.0]),
    "mixed_array_states": (MIXED_ARRAY_SRC, None, _regimen(times=(1.0, 2.0, 6.0)),
                           [1.8, 0.3, 25.0]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dsl_statements_match_the_jax_package(case):
    check_against_jax(*CASES[case])
