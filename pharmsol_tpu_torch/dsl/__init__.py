"""Runtime model DSL: parse -> analyze -> torch runtime.

The counterpart of the JAX package's ``dsl`` (itself the rebuild of
pharmsol-dsl, the frontend, and src/dsl, the backends): canonical
``model { ... }`` and flat authoring shorthand both compile to an analyzed
IR whose role closures the port's engines run, the general engine on
tensors and the fused CUDA kernels through the code generated from the same
closures. Artifacts (.pkm JSON, the JAX package's format) replace the
reference's cdylib/WASM bundles; ``dsl/pure.py`` runs them with the Python
standard library alone.
"""

from .analyze import AnalyzedModel, analyze_model, analyze_module  # noqa: F401
from .ast import DslModel, DslModelKind, DslModule, DslRouteKind, Expr, Stmt  # noqa: F401
from .diagnostic import Diagnostic, DiagnosticReport, DslError, Span  # noqa: F401
from .parser import parse_model, parse_module  # noqa: F401
from .runtime import (  # noqa: F401
    ARTIFACT_FORMAT,
    ARTIFACT_VERSION,
    CompiledRuntimeModel,
    build_runtime_model,
    compile_model,
    compile_module,
    compile_module_source_to_runtime,
    artifact_schema,
    load_runtime_artifact,
    save_artifact,
    validate_artifact,
)
