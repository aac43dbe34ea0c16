"""Build the port's CUDA sources with nvcc and load them with ctypes.

The sources under ``pharmsol_tpu_torch/csrc/`` have a plain C interface, so
they compile in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o libfused_psi_<hash>.so csrc/fused_psi.cu

The library is built at first use into ``pharmsol_tpu_torch/_build/`` (listed
in ``.gitignore``), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. Nothing here runs when
the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_psi.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIB: Optional[ctypes.CDLL] = None


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
            "psi kernel is built from source at first use"
        )
    return found


def nvcc_command(output: Path, extra: Sequence[str] = (),
                 nvcc: str = "nvcc") -> List[str]:
    """The nvcc command line that builds every source into ``output``."""
    return [nvcc, *NVCC_FLAGS, *extra, "-o", str(output),
            *(str(CSRC_DIR / s) for s in SOURCES)]


def source_hash() -> str:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((CSRC_DIR / s).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libfused_psi_{source_hash()}.so"


def build(force: bool = False, verbose: bool = False) -> tuple:
    """Compile the sources; returns ``(path, seconds, compiler_output)``.

    ``verbose`` adds ``-Xptxas -v`` (registers, spills per kernel) to the
    command; the library is the same. Raises RuntimeError with nvcc's output
    if the build fails.
    """
    out = library_path()
    if out.exists() and not force:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = nvcc_command(Path(tmp), ("-Xptxas", "-v") if verbose else (),
                       nvcc=nvcc_path())
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """The built kernel library (building it first if needed)."""
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
