"""The port's ``utils/profiling.py::profile_trace`` and ``config.int_dtype``.

``profile_trace`` is the JAX package's ``jax.profiler.trace`` wrapper as one
``torch.profiler`` capture: on the CPU it writes one Chrome/Perfetto trace
file holding the enclosed work's operators, and it refuses
``create_perfetto_link`` (an upload). ``int_dtype`` is the JAX package's
``config.int_dtype`` (int32), the dtype of the index tables a kernel reads.
"""

import json
import os

import pytest
import torch

import pharmsol_tpu.config as jax_config

from pharmsol_tpu_torch import config
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.utils.profiling import profile_trace, stage


def test_profile_trace_writes_a_trace_file(tmp_path):
    with profile_trace(str(tmp_path)) as capture:
        with stage("traced/stage"):
            torch.ones(64, dtype=torch.float64).cumsum(0)
    assert os.path.dirname(capture.path) == str(tmp_path)
    assert os.listdir(tmp_path) == [os.path.basename(capture.path)]
    with open(capture.path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::cumsum" in names and "traced/stage" in names
    assert any(e.key == "aten::cumsum" for e in capture.profiler.key_averages())
    with profile_trace(str(tmp_path)):
        pass
    assert len(os.listdir(tmp_path)) == 2


def test_profile_trace_refuses_a_perfetto_link(tmp_path):
    with pytest.raises(PharmsolError, match="network"):
        with profile_trace(str(tmp_path), create_perfetto_link=True):
            pass
    assert not os.listdir(tmp_path)


def test_int_dtype_is_the_jax_packages():
    assert config.int_dtype() is torch.int32
    assert str(jax_config.int_dtype().dtype) == "int32"
