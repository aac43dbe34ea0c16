"""The PyTorch port stands alone: no JAX, no Triton at import, explicit device."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pharmsol_tpu_torch as pt
from pharmsol_tpu_torch import config
from pharmsol_tpu_torch.errors import PharmsolError
from pharmsol_tpu_torch.ops import _build


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked: these tests ask
    for the CPU (and restore the default afterwards)."""
    monkeypatch.setattr(pt.config, "_DEVICE", pt.config.device())
    pt.set_device("cpu")


PKG = Path(pt.__file__).resolve().parent
MODULES = sorted(PKG.rglob("*.py"))


def _imports(tree):
    """(module name, is top level) for every import statement."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_module_imports_no_jax_and_no_toplevel_triton(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top in _imports(tree):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "pharmsol_tpu"), (path, name)
        if root == "triton":
            assert not top, f"{path}: triton imported at module level"


def test_package_import_loads_no_jax():
    code = ("import sys, pharmsol_tpu_torch, pharmsol_tpu_torch.ops.fused_psi, "
            "pharmsol_tpu_torch.ops.fused_ode, pharmsol_tpu_torch.ops.rhs_codegen, "
            "pharmsol_tpu_torch.likelihood.plans.ode, pharmsol_tpu_torch.convert, "
            "pharmsol_tpu_torch.ops.fused_sde, pharmsol_tpu_torch.ops.philox, "
            "pharmsol_tpu_torch.likelihood.plans.sde, pharmsol_tpu_torch.engine.sde, "
            "pharmsol_tpu_torch.likelihood.plans.analytical, "
            "pharmsol_tpu_torch.optimize.npag, pharmsol_tpu_torch.optimize.weights, "
            "pharmsol_tpu_torch.parameters, pharmsol_tpu_torch.utils.profiling, "
            "pharmsol_tpu_torch.data.pmetrics, pharmsol_tpu_torch.data.row, "
            "pharmsol_tpu_torch.data.serde, pharmsol_tpu_torch.data.auc, "
            "pharmsol_tpu_torch.likelihood.prediction, pharmsol_tpu_torch.likelihood.progress; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pharmsol_tpu', 'triton')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(PKG.parent))


def test_authoring_surfaces_import_without_jax():
    """The DSL package and the declarative API load no JAX module."""
    code = ("import sys, pharmsol_tpu_torch.dsl, pharmsol_tpu_torch.dsl.interp, "
            "pharmsol_tpu_torch.dsl.runtime, pharmsol_tpu_torch.dsl.pure, "
            "pharmsol_tpu_torch.models.declarative, pharmsol_tpu_torch.utils.authoring_cases; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pharmsol_tpu', 'triton')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(PKG.parent))


@pytest.mark.parametrize("name", [
    "analytical_model", "ode_model", "sde_model", "AnalyticalKernel", "CovariateDecl",
    "metadata_new", "dsl.compile_model", "dsl.compile_module",
    "dsl.compile_module_source_to_runtime", "dsl.load_runtime_artifact",
    "dsl.save_artifact", "dsl.validate_artifact", "dsl.parse_model", "dsl.DslError",
    "metadata.new", "metadata.Route", "metadata.CovariateDecl",
])
def test_authoring_names_match_the_jax_package(name):
    """The JAX package's top-level names for the authoring surfaces exist in
    the port under the same names (its ``__init__.py:38-48, :72-74``)."""
    obj = pt
    for part in name.split("."):
        obj = getattr(obj, part)
    assert obj is not None
    assert pt.metadata.new("m").parameters(["ke"]) is not None


def test_nvcc_command_targets_sm90a():
    cmd = _build.nvcc_command(Path("libfused_psi.so"))
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-O3" in cmd
    assert all((_build.CSRC_DIR / s).exists() for s in _build.SOURCES)
    # the C entry point the wrapper binds, and one instantiation per
    # structure: the dispatch walks every structure code
    src = (_build.CSRC_DIR / "fused_psi.cu").read_text()
    assert 'extern "C" int fused_psi_launch' in src
    from pharmsol_tpu_torch.ops.fused_psi import STRUCTURES

    assert f"if constexpr (CODE < {len(STRUCTURES)})" in src
    assert "dispatch_tier<double, TIER_K1A>" in src and "dispatch_tier<float, TIER_K1A>" in src


def test_ode_nvcc_command_includes_the_generated_rhs():
    from pharmsol_tpu_torch.ops.rhs_codegen import generate_rhs

    rhs = generate_rhs(lambda x, p, t, b, r, cov: [-p[0] * x[0] + b[0]], 1, 2, 1)
    cmd = _build.generated_nvcc_command(_build.ODE, rhs, Path("libfused_ode.so"))
    assert "arch=compute_90a,code=sm_90a" in " ".join(cmd)
    assert f'-DPHARMSOL_ODE_RHS="rhs_{rhs.key}.cuh"' in cmd
    assert cmd[-1] == str(_build.CSRC_DIR / _build.ODE.source)
    # the library name follows the kernel source and the generated header
    other = generate_rhs(lambda x, p, t, b, r, cov: [-p[1] * x[0] + b[0]], 1, 2, 1)
    assert _build.generated_library_path(_build.ODE, rhs) != \
        _build.generated_library_path(_build.ODE, other)
    src = (_build.CSRC_DIR / _build.ODE.source).read_text()
    for name in ("fused_ode_launch", "fused_ode_signature", "fused_ode_error_string"):
        assert 'extern "C"' in src and f" {name}(" in src


def test_sde_nvcc_command_includes_the_generated_closures():
    from pharmsol_tpu_torch.ops.rhs_codegen import generate_sde

    gen = generate_sde(lambda x, p, t, r, cov: [-p[0] * x[0]],
                       lambda p, t, cov: [p[1]], 1, 2, 1)
    cmd = _build.generated_nvcc_command(_build.SDE, gen, Path("libfused_sde.so"))
    assert "arch=compute_90a,code=sm_90a" in " ".join(cmd)
    assert "-fmad=false" in cmd  # rounds as the twin, operation by operation
    assert f'-DPHARMSOL_SDE_RHS="sde_{gen.key}.cuh"' in cmd
    assert cmd[-1] == str(_build.CSRC_DIR / _build.SDE.source)
    other = generate_sde(lambda x, p, t, r, cov: [-p[0] * x[0]],
                         lambda p, t, cov: [2.0 * p[1]], 1, 2, 1)
    assert _build.generated_library_path(_build.SDE, gen) != \
        _build.generated_library_path(_build.SDE, other)
    src = (_build.CSRC_DIR / _build.SDE.source).read_text()
    for name in ("fused_sde_launch", "fused_sde_philox", "fused_sde_signature",
                 "fused_sde_error_string"):
        assert 'extern "C"' in src and f" {name}(" in src
    # one instantiation per particles-per-thread count the wrapper may pick,
    # in each tier (K3a, K3b: the template's last argument)
    from pharmsol_tpu_torch.ops.fused_sde import PARTICLES_PER_THREAD

    for k in PARTICLES_PER_THREAD:
        assert f"launch_ppt<T, {k}, FEAT>" in src


def test_sde_is_exported():
    assert pt.SDE.kind == "sde"
    m = pt.SDE(lambda x, p, t, r, cov: [-p[0] * x[0]], lambda p, t, cov: [p[1]],
               nstates=1, ndrugs=1, nout=1)
    assert m.nparticles() == 1000


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is valid here")
    model = pt.Analytical(
        pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],
        nstates=1, ndrugs=1, nout=1)
    data = pt.Data([pt.Subject.builder("a").bolus(0.0, 100.0, 0)
                    .observation(1.0, 5.0, 0).build()])
    ems = pt.AssayErrorModels().add(
        0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))
    sp = np.array([[0.2, 10.0]])
    for engine in ("auto", "fused", "general"):
        with pytest.raises(PharmsolError, match="cuda"):
            pt.log_likelihood_matrix(model, data, sp, ems, device="cuda",
                                     engine=engine)
    with pytest.raises(PharmsolError):
        config.set_device("cuda")
    assert config.device() == torch.device("cpu")


def test_defaults_are_cpu_and_float64():
    # the CPU asked for by this file's fixture; the default is the card
    # (test_entry_points_default_to_the_card)
    assert config.device() == torch.device("cpu")
    assert config.float_dtype() == torch.float64
    config.set_float_dtype(np.float32)
    try:
        assert config.float_dtype() == torch.float32
    finally:
        config.set_float_dtype(torch.float64)
    with pytest.raises(ValueError):
        config.set_float_dtype(torch.float16)


def test_entry_points_default_to_the_card():
    """With no device= and no set_device the entry points run on the card:
    in a fresh interpreter on a machine without one they raise instead of
    running on the CPU. So do the single-subject API, the per-subject batch
    and population_predictions; with device="cpu" they run."""
    code = (
        "import numpy as np, torch, pharmsol_tpu_torch as pt\n"
        "from pharmsol_tpu_torch.likelihood.prediction import population_predictions\n"
        "assert pt.device() == torch.device('cuda')\n"
        "m = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],\n"
        "                  nstates=1, ndrugs=1, nout=1)\n"
        "s = pt.Subject.builder('a').bolus(0.0, 100.0, 0).observation(1.0, 5.0, 0).build()\n"
        "d = pt.Data([s])\n"
        "ems = pt.AssayErrorModels().add(\n"
        "    0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))\n"
        "rems = pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.combined(0.5, 0.1))\n"
        "sp = np.array([[0.2, 10.0]])\n"
        "calls = [lambda **kw: pt.log_likelihood_matrix(m, d, sp, ems, **kw),\n"
        "         lambda **kw: m.estimate_predictions(s, sp[0], **kw),\n"
        "         lambda **kw: m.estimate_log_likelihood(s, sp[0], ems, **kw),\n"
        "         lambda **kw: pt.log_likelihood_batch(m, d, sp, rems, **kw),\n"
        "         lambda **kw: population_predictions(m, [s], sp, **kw)]\n"
        "if not torch.cuda.is_available():\n"
        "    for call in calls:\n"
        "        try:\n"
        "            call()\n"
        "        except pt.PharmsolError as e:\n"
        "            assert 'cuda' in str(e), e\n"
        "        else:\n"
        "            raise AssertionError('ran on the CPU without being asked')\n"
        "for call in calls:\n"
        "    call(device='cpu')\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(PKG.parent))


def test_fit_population_defaults_to_the_card():
    """``fit_population`` resolves its device like the entry point: the card
    unless the caller asks for the CPU, so in a fresh interpreter on a
    machine without one it raises instead of fitting on the CPU; it has the
    JAX package's keywords plus ``device`` last."""
    import inspect

    names = list(inspect.signature(pt.optimize.fit_population).parameters)
    assert names == ["equation", "data", "error_models", "ranges", "init_points", "max_cycles",
                     "delta", "delta_min", "ll_tol", "weight_floor", "merge_tol", "max_support",
                     "refine", "engine", "mesh", "progress", "device"]
    assert pt.ParameterOptimizer is pt.optimize.ParameterOptimizer
    assert pt.get_e2 is pt.optimize.get_e2 and pt.Parameters and pt.ParameterOrder and pt.dense
    code = (
        "import numpy as np, torch, pharmsol_tpu_torch as pt\n"
        "m = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],\n"
        "                  nstates=1, ndrugs=1, nout=1)\n"
        "d = pt.Data([pt.Subject.builder('a').bolus(0.0, 100.0, 0)\n"
        "             .observation(1.0, 5.0, 0).build()])\n"
        "ems = pt.AssayErrorModels().add(\n"
        "    0, pt.AssayErrorModel.additive(pt.ErrorPoly(0.5, 0.1), 1.0))\n"
        "kw = dict(ranges=[(0.05, 0.8), (5.0, 20.0)], init_points=8, max_cycles=1)\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        pt.optimize.fit_population(m, d, ems, **kw)\n"
        "    except pt.PharmsolError as e:\n"
        "        assert 'cuda' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('fitted on the CPU without being asked')\n"
        "fit = pt.optimize.fit_population(m, d, ems, device='cpu', **kw)\n"
        "assert np.isfinite(fit.log_likelihood)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(PKG.parent))
