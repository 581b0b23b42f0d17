"""Batched solving: the cold batch entry's initial arrays.

Counterpart of ``lexls_tpu/parallel/batch.py:26-39``.  The batched
solvers themselves are :func:`lexls_tpu_torch.solve_core_batched` and
:func:`lexls_tpu_torch.solve_core_fused`: every tensor of the port carries
its batch axis, so there is no ``vmap`` wrapper to port.
"""

from __future__ import annotations

import torch

from ..lexlsi import initial_activation


def batched_initial_arrays(prob, batch: int, device):
    """Initial (ctr_type, stamp, next_stamp, x0, v0) of a cold start,
    broadcast to ``batch`` instances, as tensors on ``device`` (int32 and
    float64, as the NumPy arrays they come from).  The
    activation is the same for every instance (equality rows activate);
    a warm start replaces these with carried state."""
    ctr0, stamp0, next0 = initial_activation(prob)
    m, n = len(ctr0), int(prob.n_var)
    return (
        torch.as_tensor(ctr0, device=device).expand(batch, m).contiguous(),
        torch.as_tensor(stamp0, device=device).expand(batch, m).contiguous(),
        torch.full((batch,), int(next0), dtype=torch.int32, device=device),
        torch.zeros(batch, n, dtype=torch.float64, device=device),
        torch.zeros(batch, m, dtype=torch.float64, device=device),
    )
