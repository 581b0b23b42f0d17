"""Inversion of small upper-triangular matrices.

Counterpart of ``lexls_tpu/ops/tri.py::tri_inv_upper`` (``tri.py:25-49``),
which inverts by Newton-Schulz doubling because a triangular solve lowers
poorly on a TPU.  On a GPU the batched triangular solve against the
identity is the direct way to the same matrix.
"""

from __future__ import annotations

import torch


def tri_inv_upper(R: torch.Tensor) -> torch.Tensor:
    """Inverse of an upper-triangular matrix (batched over leading
    dimensions); strictly-lower entries of ``R`` are ignored."""
    K = R.shape[-1]
    eye = torch.eye(K, dtype=R.dtype, device=R.device).expand(R.shape)
    return torch.linalg.solve_triangular(torch.triu(R), eye, upper=True)
