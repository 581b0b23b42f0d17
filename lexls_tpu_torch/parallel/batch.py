"""Batched solving: the cold batch entry's initial arrays and
``solve_batched``.

Counterpart of ``lexls_tpu/parallel/batch.py:26-61``.  Every tensor of
the port carries its batch axis, so ``solve_batched``, the JAX package's
``vmap`` of its single-instance solver, is the exact tier itself.
"""

from __future__ import annotations

import torch

from ..lexlsi import LexLSIState, Structure, initial_activation, solve_core_batched
from ..types import ParametersLexLSI


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


def solve_batched(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, reg,
                  struct: Structure, params: ParametersLexLSI,
                  x_guess_specified: bool = False, v0_specified: bool = False) -> LexLSIState:
    """The whole solver over a batch (``parallel/batch.py:42-61``): every
    array carries a leading batch axis except ``reg``, the per-level
    regularization factors shared by the batch.  Runs the exact tier,
    :func:`lexls_tpu_torch.solve_core_batched`, every regularization type
    included."""
    return solve_core_batched(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, reg,
                              struct=struct, params=params, x_guess_specified=x_guess_specified,
                              v0_specified=v0_specified)
