"""Ahead-of-time psi programs through ``torch.export``.

The counterpart of the JAX package's ``ops/export.py`` (StableHLO through
``jax.export``), itself the reference's cargo-AOT cdylib path
(src/dsl/aot.rs): a population program is traced once at fixed padded shapes
and serialized (``torch.export.save``); the artifact reloads
(``torch.export.load``) and runs without the model's Python.

- :func:`export_function` exports any ``fn(*args)`` of tensors and tuples of
  tensors (the engine's ``OccasionArrays``) at the example arguments'
  shapes, dtypes and devices;
- :func:`load_exported` turns an artifact (a path or its bytes) back into a
  callable taking the same argument structure;
- :func:`export_psi` exports the general engine's psi program of a lowered
  population grid: ``(rows, row_subject, support, em_kind, em_factor,
  em_poly) -> psi [n_subjects, n_support]``.

The tuples are flattened into positional tensors before tracing, so no
NamedTuple needs a serialization registration (the JAX package registers
``OccasionArrays``, ``Segments`` and ``OccasionSim``).

What exports: the closed forms (with every feature of the general engine),
ODE models under every solver, and SDE models. The adaptive marches (dopri5,
tsit5, the ESDIRK pairs and BDF, the particle filter's Euler-Maruyama) trace
as one ``while_loop`` per segment (``engine/lanes.py::march``), the RHS, the
implicit solvers' Jacobian and the SDE's drift and diffusion as the
closures' traced lane programs (``engine/lanes.py``), covariate reads
included; the SDE draws from the Philox counters of the model's seed, fixed
at export time as the JAX package fixes ``PRNGKey(seed)``. A closure the RHS
tracer cannot express (a Python ``if`` or ``math.*`` on a traced value,
data-dependent indexing, an operation it lacks) is refused with
PharmsolError naming the construct, where the JAX package may trace it.
"""

from __future__ import annotations

import io
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import float_dtype, resolve_device
from ..errors import PharmsolError
from ..utils.tree import flatten


def _is_leaf(x) -> bool:
    return not isinstance(x, (tuple, list, dict))


def _tensors(args) -> list:
    """The leaves of nested tuples and lists, in order, as tensors (numpy
    arrays and numbers converted)."""
    leaves, _ = flatten(args, _is_leaf)
    return [a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
            for a in leaves]


class _Program(torch.nn.Module):
    def __init__(self, fn: Callable, like):
        super().__init__()
        self.fn, self.rebuild = fn, flatten(like, _is_leaf)[1]

    def forward(self, *leaves):
        return self.fn(*self.rebuild(leaves))


def export_function(fn: Callable, example_args: Sequence, path: Optional[str] = None) -> bytes:
    """Serialize ``fn`` traced by ``torch.export`` at the example arguments'
    shapes; returns the artifact's bytes (also written to ``path``)."""
    leaves = tuple(_tensors(example_args))
    try:
        ep = torch.export.export(_Program(fn, example_args), leaves)
    except Exception as e:
        raise PharmsolError(f"torch.export could not trace the program: "
                            f"{type(e).__name__}: {str(e).splitlines()[0]}") from e
    # the ATen graph: PyTorch versions whose export keeps torch.func.vmap
    # as pre-dispatch calls (which torch.export.save cannot serialize) trace
    # through them here; no operator is decomposed
    ep = ep.run_decompositions({})
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(source) -> Callable:
    """Load an artifact (a path or its bytes) into a callable taking the
    exported function's arguments (tuples of tensors or numpy arrays, each
    converted to the dtype and device the artifact was traced at)."""
    if isinstance(source, str):
        with open(source, "rb") as f:
            blob = f.read()
    else:
        blob = bytes(source)
    ep = torch.export.load(io.BytesIO(blob))
    user = set(ep.graph_signature.user_inputs)
    vals = [n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder" and n.name in user]
    module = ep.module()

    def call(*args):
        leaves = _tensors(args)
        if len(leaves) != len(vals):
            raise PharmsolError(f"the exported program takes {len(vals)} tensors, got "
                                f"{len(leaves)}")
        return module(*(t.to(dtype=v.dtype, device=v.device) for t, v in zip(leaves, vals)))

    return call


def _check_exportable(equation, n_params: int, cov_names) -> None:
    """Trace the closures that the exported marches run as lane programs;
    raise PharmsolError naming the construct where the tracer cannot
    express one."""
    from ..engine.ode import EXPM_SOLVERS

    kind = getattr(equation, "kind", None)
    try:
        # traced here, before torch.export (whose fake tensors the tracer's
        # check against the closure cannot read); the marches reuse them
        if kind == "ode" and equation._opts.solver not in EXPM_SOLVERS:
            equation.spec.propagate_carry.lanes(n_params, equation._ndrugs, cov_names)
        elif kind == "sde":
            equation._export_lanes(n_params, cov_names)
    except PharmsolError as e:
        raise PharmsolError(f"export_psi: {e}") from None


def export_psi(equation, grid, support_shape: Sequence[int], lowered_em,
               path: Optional[str] = None, device=None) -> bytes:
    """Export the general engine's psi program for a lowered population grid
    (its padded shapes become the artifact's static shapes) with
    ``support_shape`` = (n_support, n_params), traced on ``device`` (default:
    the card) in the working dtype. The program takes ``(rows, row_subject,
    support, em_kind, em_factor, em_poly)`` and returns psi [n_subjects,
    n_support], as the JAX package's artifact. Closed forms, ODE models
    under every solver and SDE models export (an SDE's draws fixed by its
    seed); a closure the RHS tracer cannot express raises PharmsolError
    naming the construct."""
    from ..engine.grid import to_tensors
    from ..likelihood.matrix import lowered_tensors

    names = tuple(grid.cov_names)
    _check_exportable(equation, int(support_shape[-1]), names)
    dev, fd = resolve_device(device), float_dtype()
    n_subjects = grid.n_subjects

    def psi(rows, row_subject, support, em_kind, em_factor, em_poly):
        ll = equation._ll_rows(rows, support, em_kind, em_factor, em_poly, names)
        out = torch.zeros((n_subjects, support.shape[0]), dtype=support.dtype,
                          device=support.device)
        return out.index_add(0, row_subject, ll.t())

    example = (
        to_tensors(grid.rows, dev, fd),
        torch.as_tensor(np.asarray(grid.row_subject, dtype=np.int64), device=dev),
        torch.zeros(tuple(support_shape), dtype=fd, device=dev),
        *lowered_tensors(lowered_em, dev, fd),
    )
    return export_function(psi, example, path)
