"""Batch and mesh-sharded solving of the port (``lexls_tpu/parallel``):
the exact tier over a batch, and the factories of solvers that split a batch over the
ranks of a ``torch.distributed`` device mesh, each rank solving its own
shard and only the summary metrics crossing ranks."""

from .batch import (
    batched_initial_arrays,
    make_host_mesh,
    make_sharded_solver,
    make_sharded_solver_2d,
    solve_batched,
)

__all__ = [
    "batched_initial_arrays",
    "make_host_mesh",
    "make_sharded_solver",
    "make_sharded_solver_2d",
    "solve_batched",
]
