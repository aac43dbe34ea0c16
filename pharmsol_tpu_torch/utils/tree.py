"""Nested arguments as flat lists of leaves: the row split's launch
arguments (``likelihood/plans/split.py``), the device moves of the mesh
(``parallel/mesh.py``) and the exported programs' inputs
(``ops/export.py``)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def flatten(value, is_leaf: Callable = _is_tensor) -> Tuple[list, Callable]:
    """(the leaves inside ``value`` in order, ``rebuild``): lists, tuples
    (NamedTuples among them) and dicts are walked, a leaf is what
    ``is_leaf`` accepts (default: a tensor), and anything else is kept as
    it is. ``rebuild(new_leaves)`` returns ``value`` with its leaves
    replaced, in the same order."""

    def walk(v):
        if is_leaf(v):
            return [v], lambda it: next(it)
        if isinstance(v, (list, tuple)):
            cls, parts = type(v), [walk(x) for x in v]
            leaves = [t for ts, _ in parts for t in ts]
            if hasattr(v, "_fields"):
                return leaves, lambda it: cls(*(rb(it) for _, rb in parts))
            return leaves, lambda it: cls(rb(it) for _, rb in parts)
        if isinstance(v, dict):
            parts = {k: walk(x) for k, x in v.items()}
            return ([t for ts, _ in parts.values() for t in ts],
                    lambda it: {k: rb(it) for k, (_, rb) in parts.items()})
        return [], lambda it: v

    leaves, build = walk(value)
    return leaves, lambda new: build(iter(new))


def map_tensors(fn: Callable, value):
    """``value`` with ``fn`` applied to every tensor inside it."""
    leaves, rebuild = flatten(value)
    return rebuild(fn(t) for t in leaves)
