"""The port's general psi engine against the JAX package on the "Repeat"
regimen (100 mg every 12 h x 10), for every closed-form structure.

Float64 on the CPU, relative tolerance 1e-10, as in test_torch_engine.py
(whose helpers build both packages' inputs from one numpy seed). A file of
its own because the JAX engine compiles one long unrolled scan per
structure here.
"""

import pytest

from pharmsol_tpu.engine.analytical import KERNELS

import pharmsol_tpu_torch as pt
from test_torch_engine import _compare


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


@pytest.mark.parametrize("name", list(KERNELS))
def test_general_engine_matches_jax_repeat(name):
    _compare(name, "repeat", seed=len(name) + 1)
