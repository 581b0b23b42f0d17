"""The l-QR factorization's result and its basic solve, batched.

Counterpart of the parts of ``lexls_tpu/lexlse.py`` that the fused
sequence needs: the ``LexQR`` fields that
:func:`lexls_tpu_torch.ops.factorize_fast_batched` fills, and the basic
solve (``lexlse.py:816-836``, reference ``lexlse.h:1015-1045``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LexQR:
    """Batched l-QR (leading B on every tensor).

    lod        (B, m, n+1) in-place l-QR storage, rhs in the last column
    hh         (B, m)      Householder scalars (one per processed row)
    perm       (B, n)      position q holds variable perm[q]
    rank_row   (B, n)      row of the pivot occupying position q
    ranks      (B, p)      discovered rank per level
    first_col  (B, p)      first position of each level's pivot block
    total_rank (B,)        sum of ranks
    fixed_mask (B, n)      bool, variables fixed by active simple bounds
    fixed_val  (B, n)      their values (zero elsewhere)
    """

    lod: torch.Tensor
    hh: torch.Tensor
    perm: torch.Tensor
    rank_row: torch.Tensor
    ranks: torch.Tensor
    first_col: torch.Tensor
    total_rank: torch.Tensor
    fixed_mask: torch.Tensor
    fixed_val: torch.Tensor
    dims: Tuple[int, ...]
    n_var: int


def solve(f: LexQR) -> torch.Tensor:
    """Basic solution (free variables = 0, fixed variables at their
    values), batched: one gathered n x n upper-triangular solve per
    instance, whose row q is the pivot row occupying position q (identity
    rows beyond ``total_rank``)."""
    B, m, np1 = f.lod.shape
    n = f.n_var
    if m == 0:  # bounds-only hierarchy: x is the fixed values
        return f.fixed_val.clone()
    q = torch.arange(n, device=f.lod.device)
    U = f.lod.gather(1, f.rank_row.long()[:, :, None].expand(B, n, np1))
    live = q[None, :] < f.total_rank[:, None]
    eye = torch.eye(n, dtype=f.lod.dtype, device=f.lod.device)
    Utri = torch.where(live[:, :, None], torch.triu(U[:, :, :n]), eye)
    rhs = torch.where(live, U[:, :, n], 0.0)
    x_pos = torch.linalg.solve_triangular(Utri, rhs[:, :, None], upper=True)[:, :, 0]
    x = torch.zeros_like(x_pos).scatter(1, f.perm.long(), x_pos)
    return torch.where(f.fixed_mask, f.fixed_val, x)
