"""The fused plans' row split: a block of occasion rows launched on a device.

The counterpart of the JAX plans' ``stream_args()`` / ``rep_args()`` /
``runner()`` (``plans/analytical.py:686-752``, ``plans/ode.py:794-828``,
``plans/sde.py:502-534``), which ``parallel/mesh.py`` hands to
``shard_map``. A plan is built once on the host (the costly part of a call)
and :meth:`RowSplit.run_block` launches its kernel on any block of its rows.

Every tensor argument of the launch declares its row axis, or None for a
tensor that every block shares: K2e's and K3b's lag/fa planes ``[n, R, S]``
and the init planes ``[N, R, S]`` carry their rows on axis 1, K1b's
parameter planes ``[L, n_micro, R, S]`` on axis 2, the other streams on
axis 0; the support, the output coefficients, level tables, init rows and a
lag/fa row per support ``[1, S]`` are shared. Slot tables, merge spans and
the generated RHS hold no tensor: they are per segment column or per model,
never per row, and every block shares them unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ...errors import PharmsolError
from ...utils.tree import flatten

Key = Union[int, str]


class RowSplit:
    """Mixin of the fused plans. A plan implements :meth:`launch_spec`;
    ``R`` is its number of occasion rows."""

    def launch_spec(self) -> Tuple[Callable, tuple, dict, Dict[Key, Optional[int]]]:
        """(kernel wrapper, positional arguments, keyword arguments, row
        axes): for every positional (by index) or keyword (by name) argument
        that holds a tensor, the row axis of each tensor inside it, or None
        where every block shares it."""
        raise NotImplementedError

    def run_block(self, rows: torch.Tensor, device) -> torch.Tensor:
        """psi rows ``[len(rows), S]`` of the occasion rows ``rows`` (int64
        indices, repeats allowed), launched on ``device``: each argument's
        tensors are taken at ``rows`` along their row axis and moved to
        ``device``. Raises PharmsolError for a tensor argument without a
        declared axis, or one whose row axis does not hold ``R`` rows."""
        fn, args, kwargs, axes = self.launch_spec()

        def take(key, value):
            leaves, rebuild = flatten(value)
            if not leaves:
                return value
            if key not in axes:
                raise PharmsolError(f"the launch argument {key!r} holds tensors but "
                                    f"declares no row axis")
            axis, out = axes[key], []
            for t in leaves:
                if axis is not None:
                    if t.dim() <= axis or t.shape[axis] != self.R:
                        raise PharmsolError(
                            f"the launch argument {key!r} has shape {tuple(t.shape)}: "
                            f"no {self.R} rows on its axis {axis}")
                    t = t.index_select(axis, rows.to(t.device))
                out.append(t.to(device))
            return rebuild(out)

        return fn(*(take(i, a) for i, a in enumerate(args)),
                  **{k: take(k, v) for k, v in kwargs.items()})

    def run_rows(self) -> torch.Tensor:
        """psi rows [R, S]: one launch over every row."""
        fn, args, kwargs, _ = self.launch_spec()
        return fn(*args, **kwargs)
