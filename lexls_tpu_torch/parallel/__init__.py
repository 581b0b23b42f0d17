"""Batch helpers of the port (``lexls_tpu/parallel``)."""

from .batch import batched_initial_arrays, solve_batched

__all__ = ["batched_initial_arrays", "solve_batched"]
