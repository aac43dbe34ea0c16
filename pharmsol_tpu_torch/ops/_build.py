"""Build the port's CUDA sources with nvcc and load them with ctypes.

The sources under ``pharmsol_tpu_torch/csrc/`` have a plain C interface, so
they compile in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o libfused_psi_<hash>.so csrc/fused_psi.cu

The ODE kernel ``csrc/fused_ode.cu`` (:data:`ODE`) is built once per model
right-hand side: the header generated from the model's closure
(``ops/rhs_codegen.py``) is written next to the library as ``rhs_<key>.cuh``
and included through ``-DPHARMSOL_ODE_RHS``, giving
``libfused_ode_<hash>.so``. The SDE kernel ``csrc/fused_sde.cu``
(:data:`SDE`) is built the same way once per generated drift and diffusion
(``sde_<key>.cuh``, ``-DPHARMSOL_SDE_RHS``, ``libfused_sde_<hash>.so``), one
library for its base tier (K3a) and one for its feature tier (K3b,
``-DPHARMSOL_SDE_FEAT=1``, :func:`sde_kind`).

Libraries are built at first use into ``pharmsol_tpu_torch/_build/`` (listed
in ``.gitignore``), named by a hash of the sources, the generated header and
the flags, so an edited source rebuilds and an unchanged one loads at once.
:func:`build_many` runs several nvcc processes at once. Nothing here runs
when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_psi.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


class Generated(NamedTuple):
    """A kernel built once per header generated from a model's closures.

    ``source`` lies in ``csrc/`` and names the library and its C functions
    (``<stem>_launch``, ``<stem>_error_string``, ``<stem>_signature``, and
    ``functions``: name -> (argtypes, restype)); the header is
    ``<header_prefix>_<key>.cuh``, included through ``-D<macro>``; ``flags``
    are nvcc flags of this kernel alone.
    """

    source: str
    header_prefix: str
    macro: str
    flags: tuple
    functions: dict


_vp, _ci, _cu, _cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_double
# K2a's launch takes its 13 data pointers one by one; K2e's takes them and
# its 7 feature pointers as two arrays, then the slot-table plane counts;
# both end with max_iters, newton_iters, bdf_max_order, the implicit tiers'
# grid blocks and the stream
ODE = Generated("fused_ode.cu", "rhs", "PHARMSOL_ODE_RHS", (), {
    "launch": ([_ci, _ci] + [_vp] * 15 + [_ci] * 7 + [_cd] * 3 + [_ci] * 4 + [_vp], _ci),
    "feature_launch": ([_ci, _ci] + [_vp] * 4 + [_ci] * 9 + [_cd] * 3 + [_ci] * 4 + [_vp],
                       _ci),
    # the generated rhs and rhs_jvp on n samples (checks against the closure)
    "jvp_probe": ([_ci, _ci] + [_vp] * 10, _ci),
})
# The tiers of the ODE kernel, one library each per generated header: a
# header without rhs_jvp builds the explicit tier (K2a, K2e: dopri5 and
# tsit5), one with it the exact propagation tier (K2d), unless
# PHARMSOL_ODE_SOLVER names one implicit solver by its code (3 trbdf2,
# 4 kvaerno3 = esdirk34, 5 kvaerno5: K2b; 6 bdf: K2c): then the library
# holds that solver's four instantiations and no other. The implicit tiers
# round every multiply and add on their own (-fmad=false), as their plain
# PyTorch twin does op by op, so that kernel and twin take the same step
# decisions.
_ODE_STIFF_CODES = {"trbdf2": 3, "kvaerno3": 4, "esdirk34": 4, "kvaerno5": 5, "bdf": 6}


def ode_kind(solver: str) -> Generated:
    """The build of ``csrc/fused_ode.cu`` that holds ``solver``'s tier."""
    code = _ODE_STIFF_CODES.get(solver)
    if code is None:
        return ODE
    return ODE._replace(flags=(f"-DPHARMSOL_ODE_SOLVER={code}", "-fmad=false"))


# The SDE kernel rounds every multiply and add on its own (-fmad=false), as
# its plain PyTorch twin does op by op: the two then draw the same particles,
# and the card check holds them to 1e-9 in float64 and 1e-4 in float32.
# K3a's launch takes its 16 pointers one by one; K3b's takes the 14 data
# pointers and its 5 feature pointers as two arrays, then the slot-table plane
# counts.
SDE = Generated("fused_sde.cu", "sde", "PHARMSOL_SDE_RHS", ("-fmad=false",), {
    "launch": ([_ci] + [_vp] * 16 + [_ci] * 8 + [_cu, _cu, _vp], _ci),
    "feature_launch": ([_ci] + [_vp] * 4 + [_ci] * 10 + [_cu, _cu, _vp], _ci),
    "philox": ([_ci, _vp, _cu, _cu, _vp, _vp], _ci),
    # resident blocks per SM of the tier's kernel for P particles
    "occupancy": ([_ci, _ci, _vp], _ci),
})



def sde_kind(feature: bool) -> Generated:
    """The build of ``csrc/fused_sde.cu`` that holds the base tier (K3a) or,
    with ``feature``, the feature tier (K3b): each holds its own ten
    instantiations (two dtypes, five particle counts per thread), so a model
    builds only the tier it runs."""
    return SDE._replace(flags=SDE.flags + ("-DPHARMSOL_SDE_FEAT=1",)) if feature else SDE


_LIB: Optional[ctypes.CDLL] = None
_GENERATED_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc of ``$CUDA_HOME`` (default /usr/local/cuda), else on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the fused "
            "psi kernels are built from source at first use"
        )
    return found


def nvcc_command(output: Path, extra: Sequence[str] = (),
                 nvcc: str = "nvcc") -> List[str]:
    """The nvcc command line that builds the closed-form kernel into ``output``."""
    return [nvcc, *NVCC_FLAGS, *extra, "-o", str(output),
            *(str(CSRC_DIR / s) for s in SOURCES)]


def header_name(kind: Generated, gen) -> str:
    return f"{kind.header_prefix}_{gen.key}.cuh"


def generated_nvcc_command(kind: Generated, gen, output: Path,
                           extra: Sequence[str] = (), nvcc: str = "nvcc") -> List[str]:
    """The nvcc command line that builds ``kind``'s kernel for the generated
    header ``gen`` (in BUILD_DIR) into ``output``."""
    return [nvcc, *NVCC_FLAGS, *kind.flags, *extra, f"-I{BUILD_DIR}",
            f'-D{kind.macro}="{header_name(kind, gen)}"',
            "-o", str(output), str(CSRC_DIR / kind.source)]


def source_hash() -> str:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((CSRC_DIR / s).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libfused_psi_{source_hash()}.so"


def generated_library_path(kind: Generated, gen) -> Path:
    h = hashlib.sha256()
    h.update((CSRC_DIR / kind.source).read_bytes())
    h.update(gen.source.encode())
    h.update(" ".join(NVCC_FLAGS + kind.flags).encode())
    return BUILD_DIR / f"lib{Path(kind.source).stem}_{h.hexdigest()[:16]}.so"


class Target(NamedTuple):
    """One library to build: its path and its nvcc command for an output."""

    name: str
    path: Path
    command: Callable[[Path, Sequence[str], str], List[str]]


def psi_target() -> Target:
    return Target("fused_psi", library_path(),
                  lambda out, extra, nvcc: nvcc_command(out, extra, nvcc))


def _write_header(name: str, source: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    header = BUILD_DIR / name
    if not header.exists() or header.read_text() != source:
        fd, tmp = tempfile.mkstemp(suffix=".cuh", dir=BUILD_DIR)
        with os.fdopen(fd, "w") as fh:
            fh.write(source)
        os.replace(tmp, header)


def generated_target(kind: Generated, gen) -> Target:
    """The library of ``kind``'s kernel for the generated header ``gen``;
    writes the header."""
    _write_header(header_name(kind, gen), gen.source)
    tier = "".join(f.split("=")[1] for f in kind.flags if f.startswith("-DPHARMSOL_ODE_SOLVER="))
    feat = ":features" if "-DPHARMSOL_SDE_FEAT=1" in kind.flags else ""
    name = f"{Path(kind.source).stem}[{gen.key}{':solver' + tier if tier else ''}{feat}]"
    return Target(name, generated_library_path(kind, gen),
                  lambda out, extra, nvcc: generated_nvcc_command(kind, gen, out, extra, nvcc))


def _compile(target: Target, verbose: bool) -> tuple:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = target.command(Path(tmp), ("-Xptxas", "-v") if verbose else (),
                         nvcc_path())
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {target.name}: "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target.path)
    return target.path, seconds, proc.stdout + proc.stderr


def build_many(targets: Sequence[Target], force: bool = False,
               verbose: bool = False) -> List[tuple]:
    """Compile the targets, one nvcc process each, all at once.

    Returns ``(path, seconds, compiler_output)`` per target (0 s and no
    output for a library already built). ``verbose`` adds ``-Xptxas -v``
    (registers, spills per kernel); the library is the same. Raises
    RuntimeError with nvcc's output if a build fails.
    """
    todo = list({t.path: t for t in targets
                 if force or not t.path.exists()}.values())
    done = {t.path: (t.path, 0.0, "") for t in targets}
    if todo:
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            for t, res in zip(todo, pool.map(lambda t: _compile(t, verbose), todo)):
                done[t.path] = res
    return [done[t.path] for t in targets]


def build(force: bool = False, verbose: bool = False) -> tuple:
    """Compile the closed-form kernel; returns ``(path, seconds, output)``."""
    return build_many([psi_target()], force, verbose)[0]


def bind_psi_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a build of ``csrc/fused_psi.cu``
    (the package's, or another build of the same source)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # K1a: the stream pointers, psi and the observation terms the launch
    # fills; R, S, M, n_out, the grid's blocks
    lib.fused_psi_launch.argtypes = [ci, ci] + [vp] * 13 + [ci] * 5 + [vp]
    lib.fused_psi_launch.restype = ci
    # K1b and K1c: K1a's stream pointers and psi, the level table, the
    # observation terms, an array of the feature pointers and one of 4 ints
    # (mode, levels, lag and fa row strides), R, S, M, n_out, the grid's
    # blocks
    lib.fused_psi_feature_launch.argtypes = [ci, ci] + [vp] * 16 + [ci] * 5 + [vp]
    lib.fused_psi_feature_launch.restype = ci
    # the launch's scratch (values) for is_f64, tier, R, M
    lib.fused_psi_terms_size.argtypes = [ci] * 4
    lib.fused_psi_terms_size.restype = ctypes.c_longlong
    # resident blocks an SM: is_f64, code, tier (0 K1a, 1 K1b, 2 K1c)
    lib.fused_psi_occupancy.argtypes = [ci] * 3 + [vp]
    lib.fused_psi_occupancy.restype = ci
    lib.fused_psi_prep_fields.argtypes = [ci]
    lib.fused_psi_prep_fields.restype = ci
    lib.fused_psi_error_string.argtypes = [ci]
    lib.fused_psi_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The built closed-form kernel library (building it first if needed)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path, _, _ = build()
    _LIB = bind_psi_library(ctypes.CDLL(str(path)))
    return _LIB


def load_generated_library(kind: Generated, gen) -> ctypes.CDLL:
    """The library of ``kind``'s kernel for the generated header ``gen``
    (built first if needed); checks that it was built for the same state,
    parameter and input counts."""
    target = generated_target(kind, gen)
    key = str(target.path)
    lib = _GENERATED_LIBS.get(key)
    if lib is not None:
        return lib
    build_many([target])
    lib = ctypes.CDLL(key)
    stem = Path(kind.source).stem
    for name, (argtypes, restype) in dict(
            kind.functions, error_string=([_ci], ctypes.c_char_p)).items():
        fn = getattr(lib, f"{stem}_{name}")
        fn.argtypes, fn.restype = argtypes, restype
    sig = (ctypes.c_int * 3)()
    getattr(lib, f"{stem}_signature")(sig)
    if tuple(sig) != (gen.n_states, gen.n_params, gen.ninput):
        raise RuntimeError(
            f"{target.path.name} was built for (states, params, inputs) = "
            f"{tuple(sig)}, not {(gen.n_states, gen.n_params, gen.ninput)}"
        )
    _GENERATED_LIBS[key] = lib
    return lib
