"""The device split of population workloads (``mesh.py``)."""

from .mesh import (  # noqa: F401
    Mesh,
    log_likelihood_batch_sharded,
    log_likelihood_matrix_sharded,
    population_mesh,
    shard_population,
    shard_support,
)
