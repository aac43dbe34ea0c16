"""Drive the standalone C++ ``.pkm`` host (``src/pkm_host.cpp``).

The counterpart of the JAX package's ``native/pkm_host.py``. The reference
proves its portable tier by executing models in a non-Rust host (WASM in a
browser); this module builds the C++ host binary on demand (g++, named by a
hash of its source like ``loader.py``) and runs ``.pkm`` artifacts saved by
the port's DSL through it.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .loader import BUILD_DIR, compile_cpp, native_disabled, source_hash

_SRC = Path(__file__).parent / "src" / "pkm_host.cpp"

_lock = threading.Lock()
_binary: Optional[Path] = None
_tried = False


def get_host_binary() -> Optional[Path]:
    """Path to the pkm_host binary, building on first use; None if no g++."""
    global _binary, _tried
    with _lock:
        if _binary is not None or _tried:
            return _binary
        _tried = True
        if native_disabled():
            return None
        _binary = compile_cpp(_SRC, BUILD_DIR / f"pkm_host_{source_hash(_SRC)}",
                              [["-O2", "-std=c++17"]], timeout=180)
        return _binary


def pkm_host_available() -> bool:
    return get_host_binary() is not None


def _covariate_json(cov) -> dict:
    out = {}
    for name, c in (cov or {}).items():
        if isinstance(c, dict):
            out[name] = {"fixed": bool(c.get("fixed", False)),
                         "knots": [[float(t), float(v)] for t, v in c["knots"]]}
        else:  # PureCovariate-shaped: .knots / .fixed
            out[name] = {"fixed": bool(getattr(c, "fixed", False)),
                         "knots": [[float(t), float(v)] for t, v in c.knots]}
    return out


def run_pkm_host(
    model_path: str,
    params: Sequence[float],
    boluses: Sequence[Tuple[float, float, int]],
    obs_times: Sequence[float],
    cov: Optional[Dict] = None,
    dt: float = 0.01,
    nparticles: Optional[int] = None,
    seed: int = 0,
) -> List[List[float]]:
    """Simulate a ``.pkm`` artifact in the C++ host; returns per-observation
    outputs.

    The scenario mirrors :meth:`~pharmsol_tpu_torch.dsl.pure.PureModel.simulate`'s
    signature; ``cov`` maps names to PureCovariate instances or ``{"fixed":
    bool, "knots": [(t, v), ...]}`` dicts.
    """
    binary = get_host_binary()
    if binary is None:
        raise RuntimeError(
            "the pkm_host binary is unavailable (no C++ toolchain, or "
            "PHARMSOL_TPU_NO_NATIVE=1)"
        )
    scenario = {
        "params": [float(p) for p in params],
        "boluses": [[float(t), float(a), int(i)] for t, a, i in boluses],
        "obs_times": [float(t) for t in obs_times],
        "covariates": _covariate_json(cov),
        "dt": float(dt),
        "nparticles": None if nparticles is None else int(nparticles),
        "seed": int(seed),
    }
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(scenario, f)
        sc_path = f.name
    try:
        proc = subprocess.run([str(binary), str(model_path), sc_path],
                              capture_output=True, text=True, timeout=300)
    finally:
        os.unlink(sc_path)
    if proc.returncode != 0:
        raise RuntimeError(f"pkm_host failed: {proc.stderr.strip()}")
    return json.loads(proc.stdout)
