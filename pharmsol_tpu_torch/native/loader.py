"""ctypes bindings and on-demand build of the native runtime library.

The counterpart of the JAX package's ``native/loader.py``: the shared
library is compiled once (g++ -O3) from ``src/pharmsol_native.cpp`` into
``pharmsol_tpu_torch/_build/``, named by a hash of its source. If no
toolchain is available, callers fall back to the pure-Python paths
(``native_available()`` gates).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Sequence

_HERE = Path(__file__).parent
_SRC = _HERE / "src" / "pharmsol_native.cpp"
BUILD_DIR = _HERE.parent / "_build"

_lock = threading.Lock()
_lib = None
_tried = False


def source_hash(src: Path) -> str:
    return hashlib.sha256(src.read_bytes()).hexdigest()[:16]


def native_disabled() -> bool:
    return os.environ.get("PHARMSOL_TPU_NO_NATIVE") == "1"


def compile_cpp(src: Path, out: Path, flags: Sequence[Sequence[str]],
                timeout: float) -> Optional[Path]:
    """Build ``src`` into ``out`` with ``$CXX`` (default g++), trying each
    flag set in turn; None when no set builds. The build writes a file of
    its own and renames it into place, so processes that build at once never
    read a partial file."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = None
    for extra in flags:
        try:
            proc = subprocess.run([cxx, *extra, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True, timeout=timeout)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
    sys.stderr.write(f"pharmsol-tpu native build of {src.name} failed:\n{proc.stderr}\n")
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.psn_parse.restype = c.c_void_p
    lib.psn_parse.argtypes = [c.c_char_p, c.c_long]
    lib.psn_error.restype = c.c_char_p
    lib.psn_error.argtypes = [c.c_void_p]
    lib.psn_nrows.restype = c.c_long
    lib.psn_nrows.argtypes = [c.c_void_p]
    lib.psn_ncov.restype = c.c_long
    lib.psn_ncov.argtypes = [c.c_void_p]
    lib.psn_numeric.restype = c.c_int
    lib.psn_numeric.argtypes = [c.c_void_p, c.c_char_p, c.POINTER(c.c_double)]
    lib.psn_interned.restype = c.c_int
    lib.psn_interned.argtypes = [c.c_void_p, c.c_char_p, c.POINTER(c.c_long)]
    lib.psn_cov_column.restype = c.c_int
    lib.psn_cov_column.argtypes = [c.c_void_p, c.c_long, c.POINTER(c.c_double)]
    lib.psn_table_len.restype = c.c_long
    lib.psn_table_len.argtypes = [c.c_void_p, c.c_char_p]
    lib.psn_table_get.restype = c.c_long
    lib.psn_table_get.argtypes = [c.c_void_p, c.c_char_p, c.c_long, c.c_char_p, c.c_long]
    lib.psn_cov_name.restype = c.c_long
    lib.psn_cov_name.argtypes = [c.c_void_p, c.c_long, c.c_char_p, c.c_long]
    lib.psn_free.restype = None
    lib.psn_free.argtypes = [c.c_void_p]
    lib.psn_version.restype = c.c_char_p
    return lib


def get_library() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if native_disabled():
            return None
        base = ["-O3", "-shared", "-fPIC", "-std=c++17"]
        so = compile_cpp(_SRC, BUILD_DIR / f"libpharmsol_native_{source_hash(_SRC)}.so",
                         [base[:1] + ["-march=native"] + base[1:], base], timeout=120)
        if so is None:
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(so)))
        except OSError:
            _lib = None
        return _lib


def native_available() -> bool:
    return get_library() is not None
