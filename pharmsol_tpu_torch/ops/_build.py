"""Build the port's CUDA sources with nvcc and load them with ctypes.

The sources under ``pharmsol_tpu_torch/csrc/`` have a plain C interface, so
they compile in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o libfused_psi_<hash>.so csrc/fused_psi.cu

The ODE kernel ``csrc/fused_ode.cu`` is built once per model right-hand side:
the header generated from the model's closure (``ops/rhs_codegen.py``) is
written next to the library as ``rhs_<key>.cuh`` and included through
``-DPHARMSOL_ODE_RHS``, giving ``libfused_ode_<hash>.so``.

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
ODE_SOURCE = "fused_ode.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIB: Optional[ctypes.CDLL] = None
_ODE_LIBS: Dict[str, ctypes.CDLL] = {}


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


def ode_header_name(rhs) -> str:
    return f"rhs_{rhs.key}.cuh"


def ode_nvcc_command(rhs, output: Path, extra: Sequence[str] = (),
                     nvcc: str = "nvcc") -> List[str]:
    """The nvcc command line that builds the ODE kernel for the generated
    ``rhs`` (its header in BUILD_DIR) into ``output``."""
    return [nvcc, *NVCC_FLAGS, *extra, f"-I{BUILD_DIR}",
            f'-DPHARMSOL_ODE_RHS="{ode_header_name(rhs)}"',
            "-o", str(output), str(CSRC_DIR / ODE_SOURCE)]


def source_hash() -> str:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((CSRC_DIR / s).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libfused_psi_{source_hash()}.so"


def ode_library_path(rhs) -> Path:
    h = hashlib.sha256()
    h.update((CSRC_DIR / ODE_SOURCE).read_bytes())
    h.update(rhs.source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfused_ode_{h.hexdigest()[:16]}.so"


class Target(NamedTuple):
    """One library to build: its path and its nvcc command for an output."""

    name: str
    path: Path
    command: Callable[[Path, Sequence[str], str], List[str]]


def psi_target() -> Target:
    return Target("fused_psi", library_path(),
                  lambda out, extra, nvcc: nvcc_command(out, extra, nvcc))


def ode_target(rhs) -> Target:
    """The ODE library of ``rhs``; writes its generated header."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    header = BUILD_DIR / ode_header_name(rhs)
    if not header.exists() or header.read_text() != rhs.source:
        fd, tmp = tempfile.mkstemp(suffix=".cuh", dir=BUILD_DIR)
        with os.fdopen(fd, "w") as fh:
            fh.write(rhs.source)
        os.replace(tmp, header)
    return Target(f"fused_ode[{rhs.key}]", ode_library_path(rhs),
                  lambda out, extra, nvcc: ode_nvcc_command(rhs, out, extra, nvcc))


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


def load_library() -> ctypes.CDLL:
    """The built closed-form kernel library (building it first if needed)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_psi_launch.argtypes = [ci, ci] + [vp] * 12 + [ci] * 4 + [vp]
    lib.fused_psi_launch.restype = ci
    lib.fused_psi_error_string.argtypes = [ci]
    lib.fused_psi_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def load_ode_library(rhs) -> ctypes.CDLL:
    """The ODE kernel library of the generated ``rhs`` (built first if
    needed); checks that it was built for the same state, parameter and
    input counts."""
    target = ode_target(rhs)
    key = str(target.path)
    lib = _ODE_LIBS.get(key)
    if lib is not None:
        return lib
    build_many([target])
    lib = ctypes.CDLL(key)
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.fused_ode_launch.argtypes = ([ci, ci] + [vp] * 15 + [ci] * 7
                                     + [cd] * 3 + [ci, vp])
    lib.fused_ode_launch.restype = ci
    lib.fused_ode_error_string.argtypes = [ci]
    lib.fused_ode_error_string.restype = ctypes.c_char_p
    sig = (ctypes.c_int * 3)()
    lib.fused_ode_signature(sig)
    if tuple(sig) != (rhs.n_states, rhs.n_params, rhs.ninput):
        raise RuntimeError(
            f"{target.path.name} was built for (states, params, inputs) = "
            f"{tuple(sig)}, not {(rhs.n_states, rhs.n_params, rhs.ninput)}"
        )
    _ODE_LIBS[key] = lib
    return lib
