"""Device split for population workloads.

The counterpart of the JAX package's ``parallel/mesh.py``. The reference
spreads psi-matrix rows over rayon threads (matrix.rs:79-98); the JAX package
puts occasion rows and support points on a 2-D ``jax.sharding.Mesh`` with
axes ``("subjects", "support")``. The port keeps its shape: one process holds
a 2-D grid of ``torch.device``s (:class:`Mesh`), occasion rows split over the
subjects axis and support points over the support axis. Every cell is
independent, so the only traffic is the gather of each shard's block to the
mesh's first device, where the rows are summed into subjects.

A device may appear more than once: ``population_mesh(devices=["cpu"] * 8)``
is the counterpart of the JAX tests' eight virtual CPU devices, and
``["cuda:0"] * 8`` runs the eight-way split on one card. No process group is
started: the JAX mesh has one controller, and so does this one.

Padding, as in the JAX package: the general engine pads rows with inert rows
(every event at ``BIG_TIME``, no valid observation, so their log-likelihood
is 0; mapped to subject 0) and the support by repeating its last point; the
fused path repeats the last occasion row up to equal blocks. The padding is
sliced off the result.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import BIG_TIME, float_dtype, resolve_device
from ..engine.grid import OccasionArrays, PopulationGrid, to_tensors
from ..errors import PharmsolError
from ..utils.tree import map_tensors


class Mesh:
    """A 2-D grid of devices with named axes (the JAX ``Mesh``'s role):
    ``devices`` an object array of ``torch.device``, ``shape`` a dict from
    axis name to its size. The first axis holds the subjects, the second the
    support, whatever their names."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str]):
        if devices.ndim != len(axis_names):
            raise PharmsolError(
                f"a mesh of {devices.ndim} axes needs as many names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.subjects_axis, self.support_axis = self.axis_names

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]


def population_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
    axis_names: Tuple[str, str] = ("subjects", "support"),
) -> Mesh:
    """Build a 2-D population mesh. Default: every CUDA device on the
    subjects axis (PharmsolError without a card, as the other entry points).
    ``devices`` may repeat a device."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise PharmsolError("a mesh needs at least one device")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    if shape is None:
        shape = (len(devs), 1)
    if int(np.prod(shape)) != len(devs):
        raise PharmsolError(f"mesh shape {tuple(shape)} does not hold {len(devs)} devices")
    return Mesh(arr.reshape(shape), axis_names)


def _pad_rows(rows: OccasionArrays, row_subject: np.ndarray, target: int):
    """Pad stacked occasion rows with inert rows up to ``target``."""
    r = row_subject.shape[0]
    if r == target:
        return rows, row_subject
    padn = target - r

    def pad(x):
        x = np.asarray(x)
        return np.concatenate([x, np.zeros((padn,) + x.shape[1:], dtype=x.dtype)])

    padded = OccasionArrays(*(pad(x) for x in rows))
    # inert rows: every event at BIG_TIME, no valid observation
    for name in ("bolus_t", "inf_t", "obs_t"):
        getattr(padded, name)[r:] = BIG_TIME
    padded.inf_dur[r:] = 1.0
    row_subject = np.concatenate([row_subject, np.zeros((padn,), dtype=row_subject.dtype)])
    return padded, row_subject


def _blocks(n: int, parts: int) -> list:
    size = n // parts
    return [slice(i * size, (i + 1) * size) for i in range(parts)]


def shard_population(grid: PopulationGrid, mesh: Mesh, subjects_axis: Optional[str] = None,
                     dtype=None) -> tuple:
    """Pad a PopulationGrid's rows and place one block on each index of the
    subjects axis (default: the mesh's first axis), on its first device.

    Returns (one OccasionArrays of tensors per shard, the padded row ->
    subject map [Rp], Rp)."""
    dtype = float_dtype() if dtype is None else dtype
    subjects_axis = subjects_axis or mesh.subjects_axis
    n_shards = mesh.shape[subjects_axis]
    target = -(-grid.n_rows // n_shards) * n_shards
    rows, row_subject = _pad_rows(grid.rows, np.asarray(grid.row_subject), target)
    devs = _shard_devices(mesh, subjects_axis)
    blocks = [to_tensors(OccasionArrays(*(np.asarray(x)[sl] for x in rows)), d, dtype)
              for sl, d in zip(_blocks(target, n_shards), devs)]
    return blocks, row_subject, target


def shard_support(support: np.ndarray, mesh: Mesh, support_axis: Optional[str] = None,
                  dtype=None) -> tuple:
    """Pad the support-point matrix by repeating its last point and split it
    over the support axis (default: the mesh's second axis). Returns (one
    block [S_pad / n, P] per shard on the first device of each index along
    that axis, the real point count)."""
    dtype = float_dtype() if dtype is None else dtype
    support_axis = support_axis or mesh.support_axis
    n_shards = mesh.shape[support_axis]
    support = np.asarray(support, dtype=np.float64)
    n = support.shape[0]
    target = -(-n // n_shards) * n_shards
    if target != n:
        support = np.concatenate([support, np.repeat(support[-1:], target - n, axis=0)])
    devs = _shard_devices(mesh, support_axis)
    return [torch.as_tensor(support[sl], dtype=dtype, device=d)
            for sl, d in zip(_blocks(target, n_shards), devs)], n


def _shard_devices(mesh: Mesh, axis_name: str) -> list:
    """The first device of each index along ``axis_name``."""
    axis = mesh.axis_names.index(axis_name)
    return list(np.moveaxis(mesh.devices, axis, 0).reshape(mesh.shape[axis_name], -1)[:, 0])


def log_likelihood_matrix_sharded(
    equation,
    subjects,
    support_points,
    error_models,
    mesh: Optional[Mesh] = None,
    progress: bool = False,
    engine: str = "general",
) -> torch.Tensor:
    """psi [n_subjects, n_support] split over the devices of ``mesh``; the
    same cells as :func:`~pharmsol_tpu_torch.likelihood.matrix.log_likelihood_matrix`,
    returned on the mesh's first device (non-finite cells as -inf).

    ``engine``: ``general`` splits rows over the subjects axis and supports
    over the support axis; ``fused`` builds the model's fused plan once (it
    validates as the unsharded call does) and launches its kernel once per
    subjects shard, on the shard's device, with the support shared (the JAX
    package's ``shard_map`` of its Pallas kernel); ``auto`` picks as the
    unsharded call does on the mesh's first device. Every launch is issued
    before any block is gathered. A failed launch raises: no shard falls
    back to another engine. ``progress`` is accepted for the JAX signature
    and prints nothing.
    """
    from ..likelihood.matrix import (
        _as_data, _auto_engine, _fused_plan, check_error_model_coverage,
        lowered_tensors,
    )

    if engine not in ("auto", "general", "fused"):
        raise PharmsolError(f"unknown psi engine `{engine}` (auto, general or fused)")
    data = _as_data(subjects)
    if mesh is None:
        mesh = population_mesh()
    dev0, dtype = mesh.first_device, float_dtype()
    if isinstance(support_points, torch.Tensor):
        support_points = support_points.detach().cpu().numpy()
    sp = np.asarray(support_points, dtype=np.float64)
    if sp.ndim != 2:
        raise PharmsolError("support_points must be 2D [n_support, n_params]")
    grid = equation.lower(data.subjects())
    lowered = error_models.lower(equation.resolve_output_label, equation.nouteqs())
    check_error_model_coverage(grid, lowered)

    plan = None
    if engine == "auto":
        engine, reason = _auto_engine(dev0)
        if engine == "fused":
            try:
                plan = _fused_plan(equation, grid, sp, lowered, dev0, dtype)
            except PharmsolError as e:
                engine, reason = "general", f"fused plan rejected the model: {e}"
        equation._last_engine_decision = {"engine": engine, "reason": reason}
    elif engine == "fused":
        plan = _fused_plan(equation, grid, sp, lowered, dev0, dtype)

    if plan is not None:
        psi = _fused_psi_sharded(plan, mesh)
    else:
        blocks, row_subject, target = shard_population(grid, mesh, dtype=dtype)
        sp_blocks, n_real = shard_support(sp, mesh, dtype=dtype)
        lls = []
        for i, rows in enumerate(blocks):
            for j, p in enumerate(sp_blocks):
                d = mesh.devices[i, j]
                lls.append(equation._ll_rows(map_tensors(lambda t: t.to(d), rows), p.to(d),
                                             *lowered_tensors(lowered, d, dtype),
                                             grid.cov_names))  # [S_j, R_i]
        n_sup = len(sp_blocks)
        ll = torch.cat([torch.cat([b.to(dev0) for b in lls[i * n_sup:(i + 1) * n_sup]])
                        for i in range(len(blocks))], dim=1)  # [S_pad, Rp]
        psi = torch.zeros((grid.n_subjects, ll.shape[0]), dtype=dtype, device=dev0)
        psi = psi.index_add_(0, torch.as_tensor(row_subject.astype(np.int64), device=dev0),
                             ll.t())[:, :n_real]
    return torch.where(torch.isfinite(psi), psi, torch.full_like(psi, -float("inf")))


def _fused_psi_sharded(plan, mesh: Mesh) -> torch.Tensor:
    """The plan's kernel launched once per subjects shard on the shard's
    device, over equal row blocks (the last occasion row repeated to fill
    them), the support shared; the blocks gathered to the mesh's first
    device and summed into subjects by the plan's ``finalize``."""
    devs = _shard_devices(mesh, mesh.subjects_axis)
    dev0 = mesh.first_device
    R = plan.R
    size = -(-R // len(devs))
    order = torch.arange(size * len(devs), device=dev0).clamp_(max=R - 1)
    outs = [plan.run_block(order[i * size:(i + 1) * size], d) for i, d in enumerate(devs)]
    psi_rows = torch.cat([o.to(dev0) for o in outs])[:R]
    return plan.finalize(psi_rows)


def log_likelihood_batch_sharded(
    equation,
    subjects,
    parameters,
    residual_error_models,
    mesh: Optional[Mesh] = None,
    subjects_axis: Optional[str] = None,
) -> torch.Tensor:
    """The per-subject batch log-likelihood (the SAEM/FOCE surface) split over
    the subjects axis: each shard marches its occasion rows
    (``SegmentMarch(per_row=True)``) under the replicated ``[n_subjects,
    n_params]`` matrix's rows, and the row totals are summed into subjects on
    the mesh's first device. The same values as
    :func:`~pharmsol_tpu_torch.likelihood.matrix.log_likelihood_batch`."""
    from ..likelihood.matrix import _as_data, _batch_row_totals

    data = _as_data(subjects)
    if mesh is None:
        mesh = population_mesh()
    dev0, dtype = mesh.first_device, float_dtype()
    if isinstance(parameters, torch.Tensor):
        parameters = parameters.detach().cpu().numpy()
    p = np.asarray(parameters, dtype=np.float64)
    if p.ndim != 2 or p.shape[0] != len(data):
        raise PharmsolError(
            f"parameters has {p.shape[0] if p.ndim == 2 else '?'} rows but "
            f"there are {len(data)} subjects"
        )
    grid = equation.lower(data.subjects())
    lowered = residual_error_models.lower(equation.resolve_output_label,
                                          equation.nouteqs())
    subjects_axis = subjects_axis or mesh.subjects_axis
    blocks, row_subject, target = shard_population(grid, mesh, subjects_axis, dtype)
    devs = _shard_devices(mesh, subjects_axis)
    size = target // len(devs)
    totals = []
    for i, (rows, d) in enumerate(zip(blocks, devs)):
        rs = torch.as_tensor(row_subject[i * size:(i + 1) * size].astype(np.int64), device=d)
        p_rows = torch.as_tensor(p, dtype=dtype, device=d)[rs]
        totals.append(_batch_row_totals(equation, rows, p_rows, grid.cov_names, lowered,
                                        d, dtype))
    total = torch.cat([t.to(dev0) for t in totals])
    out = torch.zeros((grid.n_subjects,), dtype=dtype, device=dev0)
    out = out.index_add_(0, torch.as_tensor(row_subject.astype(np.int64), device=dev0), total)
    return torch.where(torch.isfinite(out) | torch.isneginf(out), out,
                       torch.full_like(out, -float("inf")))
