"""Batch helpers of the port (``lexls_tpu/parallel``)."""

from .batch import batched_initial_arrays

__all__ = ["batched_initial_arrays"]
