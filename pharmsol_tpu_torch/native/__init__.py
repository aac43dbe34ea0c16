"""Native (C++) host components: the columnar Pmetrics CSV parser and the
standalone ``.pkm`` host.

Copies of the JAX package's ``native/src`` sources, built on first use with
g++ into ``pharmsol_tpu_torch/_build/``; every entry point falls back to the
pure-Python path when no toolchain is present (``PHARMSOL_TPU_NO_NATIVE=1``
forces the fallback), as the JAX package's do. These run on the host: no
device is involved.
"""

from .loader import get_library, native_available  # noqa: F401
from .pkm_host import pkm_host_available, run_pkm_host  # noqa: F401
from .pmetrics import read_pmetrics_native  # noqa: F401
