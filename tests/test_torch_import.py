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
        assert root not in ("jax", "jaxlib", "optax", "pharmsol_tpu"), (path, name)
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
            "pharmsol_tpu_torch.likelihood.prediction, pharmsol_tpu_torch.likelihood.progress, "
            "pharmsol_tpu_torch.engine.sens, pharmsol_tpu_torch.optimize.map, "
            "pharmsol_tpu_torch.optimize.laplace, pharmsol_tpu_torch.optimize.fim, "
            "pharmsol_tpu_torch.optimize.saem, pharmsol_tpu_torch.optimize._lbfgs, "
            "pharmsol_tpu_torch.optimize._condll, pharmsol_tpu_torch.optimize._coveffects; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'pharmsol_tpu', 'triton')]; "
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
    running on the CPU. So do the single-subject API, the per-subject batch,
    population_predictions, log_likelihood_fn and the estimation layer
    (fit_map, fit_laplace, fit_saem); with device="cpu" they run."""
    import inspect

    for fn in (pt.optimize.fit_map, pt.optimize.fit_laplace, pt.optimize.fit_saem,
               pt.ODE.log_likelihood_fn):
        assert list(inspect.signature(fn).parameters)[-1] == "device", fn
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
        "s2 = pt.Subject.builder('b').bolus(0.0, 90.0, 0).observation(1.0, 6.0, 0).build()\n"
        "d2 = pt.Data([s, s2])\n"
        "opt = pt.optimize\n"
        "calls = [lambda **kw: pt.log_likelihood_matrix(m, d, sp, ems, **kw),\n"
        "         lambda **kw: m.estimate_predictions(s, sp[0], **kw),\n"
        "         lambda **kw: m.estimate_log_likelihood(s, sp[0], ems, **kw),\n"
        "         lambda **kw: pt.log_likelihood_batch(m, d, sp, rems, **kw),\n"
        "         lambda **kw: population_predictions(m, [s], sp, **kw),\n"
        "         lambda **kw: m.log_likelihood_fn(d, ems, **kw)(sp[0]),\n"
        "         lambda **kw: opt.fit_map(m, d, ems, sp[0], max_iters=1, **kw),\n"
        "         lambda **kw: opt.fit_laplace(m, d2, rems, sp[0], max_iters=1,\n"
        "                                      compute_se=False, inner_steps=2, **kw),\n"
        "         lambda **kw: opt.fit_saem(m, d2, rems, sp[0], n_burn=1, n_iters=1,\n"
        "                                   mh_steps=1, **kw)]\n"
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


def test_replicate_layer_and_nca_default_to_the_card():
    """The replicate layer and the device NCA batch take ``device`` and
    resolve it like the other entry points: in a fresh interpreter on a
    machine without a card they raise instead of running on the CPU; with
    device="cpu" the quick ones run. Their modules import no JAX, optax or
    JAX package module (``test_module_imports_no_jax_and_no_toplevel_triton``
    covers every file; here the package's import graph)."""
    import inspect

    opt = pt.optimize
    for fn in (opt.bootstrap_laplace, opt.sse, opt.sse_laplace, opt.llp, opt.scm, opt.vpc,
               opt.npde, opt.gof, pt.nca.batch_nca_device):
        assert "device" in inspect.signature(fn).parameters, fn
    code = (
        "import sys, numpy as np, torch, pharmsol_tpu_torch as pt\n"
        "from types import SimpleNamespace\n"
        "import pharmsol_tpu_torch.optimize.bootstrap, pharmsol_tpu_torch.optimize.sse\n"
        "import pharmsol_tpu_torch.optimize.profile, pharmsol_tpu_torch.optimize.scm\n"
        "import pharmsol_tpu_torch.optimize.diagnostics, pharmsol_tpu_torch.nca.batch_device\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
        "                                                     'pharmsol_tpu')]\n"
        "assert not bad, bad\n"
        "m = pt.Analytical(pt.one_compartment, out=lambda x, p, t, cov: x[0:1] / p[1],\n"
        "                  nstates=1, ndrugs=1, nout=1)\n"
        "subs = [pt.Subject.builder(f's{i}').bolus(0.0, 100.0, 0).covariate('wt', 0.0, 60.0 + i)\n"
        "        .observation(1.0, 8.0 - i, 0).observation(4.0, 5.0 - i, 0).build()\n"
        "        for i in range(3)]\n"
        "d = pt.Data(subs)\n"
        "rems = pt.ResidualErrorModels().add(0, pt.ResidualErrorModel.proportional(0.2))\n"
        "pop = SimpleNamespace(theta=np.array([0.25, 10.0]), omega=np.array([0.2, 0.1]),\n"
        "                      omega_cov=None, transform=('log', 'log'),\n"
        "                      individual_parameters=np.array([[0.25, 10.0]] * 3))\n"
        "opt = pt.optimize\n"
        "fit = dict(max_iters=1, compute_se=False, inner_steps=2)\n"
        "t = np.linspace(0.5, 12.0, 8)\n"
        "prof = 10.0 * np.exp(-0.2 * t)[None, :] * np.ones((4, 1))\n"
        "slow = [lambda **kw: opt.bootstrap_laplace(m, d, rems, [0.25, 10.0], n_boot=2,\n"
        "                                           refit_iters=1, **fit, **kw),\n"
        "        lambda **kw: opt.sse_laplace(m, d, rems, [0.25, 10.0], n_sim=2, refit_iters=1,\n"
        "                                     **fit, **kw),\n"
        "        lambda **kw: opt.llp(m, d, rems, [0.25, 10.0], n_grid=3, refit_iters=1,\n"
        "                             **fit, **kw),\n"
        "        lambda **kw: opt.scm(m, d, rems, [0.25, 10.0], [(0, 'wt', 'power', 70.0)],\n"
        "                             refit_iters=1, **fit, **kw),\n"
        "        lambda **kw: opt.sse(m, d, rems, pop, lambda x: pop, n_sim=2, **kw)]\n"
        "quick = [lambda **kw: opt.vpc(m, d, rems, pop, n_rep=20, **kw),\n"
        "         lambda **kw: opt.npde(m, d, rems, pop, n_rep=100, **kw),\n"
        "         lambda **kw: opt.gof(m, d, rems, pop, **kw),\n"
        "         lambda **kw: pt.nca.batch_nca_device(t, prof, dose=100.0, **kw)]\n"
        "if not torch.cuda.is_available():\n"
        "    for call in slow + quick:\n"
        "        try:\n"
        "            call()\n"
        "        except pt.PharmsolError as e:\n"
        "            assert 'cuda' in str(e), e\n"
        "        else:\n"
        "            raise AssertionError('ran on the CPU without being asked')\n"
        "for call in quick:\n"
        "    call(device='cpu')\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(PKG.parent))


def test_mesh_export_and_native_import_without_jax():
    """The device split, the export module and the native host library load
    no JAX module (nor Triton)."""
    code = ("import sys, pharmsol_tpu_torch.parallel, pharmsol_tpu_torch.parallel.mesh, "
            "pharmsol_tpu_torch.native, pharmsol_tpu_torch.native.loader, "
            "pharmsol_tpu_torch.native.pmetrics, pharmsol_tpu_torch.native.pkm_host, "
            "pharmsol_tpu_torch.ops.export, pharmsol_tpu_torch.likelihood.plans.split; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'pharmsol_tpu', 'triton')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(PKG.parent))


def test_population_mesh_defaults_to_the_card():
    """``population_mesh()`` puts every CUDA device on the subjects axis:
    without a card it raises (no CPU mesh unless the caller names the
    devices), as the other entry points do."""
    from pharmsol_tpu_torch.parallel import population_mesh

    if torch.cuda.is_available():
        mesh = population_mesh()
        assert mesh.shape == {"subjects": torch.cuda.device_count(), "support": 1}
        assert all(d.type == "cuda" for d in mesh.devices.flat)
    else:
        with pytest.raises(PharmsolError, match="cuda"):
            population_mesh()
    assert population_mesh(devices=["cpu"]).first_device == torch.device("cpu")
