"""The l-QR factorization's result and its basic solve, batched.

Counterpart of the parts of ``lexls_tpu/lexlse.py`` that the ported
tiers need: the ``LexQR`` fields that
:func:`lexls_tpu_torch.ops.factorize_fast_batched` fills, the basic
solve (``lexlse.py:816-836``, reference ``lexlse.h:1015-1045``) and every
objective's Lagrange multipliers (``lexlse.py:1115-1175``).
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


def _level_wy(f: LexQR, k: int, fr: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact WY factors (V, W), each (B, dim, K), of level ``k``'s
    Householder sequence, Q_k = H_0 ... H_{K-1} = I - W V^T
    (``lexlse.py:991-1032``): V is the unit lower trapezoid of reflection
    vectors read from the level's pivot columns, and W = V T with
    T^{-1} = diag(1/tau) + striu(V^T V).  Dead reflections (tau = 0,
    beyond the rank) have a zero column in V and a unit diagonal in
    T^{-1}.  Two batched products apply Q_k to all objectives at once,
    where a sequential replay takes K dependent steps for each level: on
    the card each step is several launches, so the replay is kept for the
    plain version of kernel B2, which mirrors the kernel's own order."""
    B, _, np1 = f.lod.shape
    n, dim = f.n_var, f.dims[k]
    K = min(dim, n)
    dev, dtype = f.lod.device, f.lod.dtype
    jj = torch.arange(K, device=dev)
    cols = (f.first_col[:, k, None] + jj).clamp(max=n).long()
    M = f.lod[:, fr:fr + dim].gather(2, cols[:, None, :].expand(B, dim, K))
    rloc = torch.arange(dim, device=dev)[:, None]
    tau = f.hh[:, fr:fr + K]
    live = tau != 0
    V = torch.where(rloc > jj, M, (rloc == jj).to(dtype)) * live[:, None, :].to(dtype)
    Tinv = torch.triu(V.transpose(1, 2) @ V, 1) + torch.diag_embed(
        torch.where(live, 1.0 / torch.where(live, tau, 1.0), 1.0))
    W = torch.linalg.solve_triangular(Tinv, V, upper=True, left=False)
    return V, W


def sensitivities_all(f: LexQR) -> torch.Tensor:
    """All objectives' multipliers at once, batched: lam_all (B, p, m),
    row j the multipliers of objective j (``lexlse.py:1115-1175``,
    reference ``ObjectiveSensitivity``, ``lexlse.h:611-762``).

    One pass per level k, descending: objective k's residual segment and
    every lower-priority objective's back-substitution segment go through
    Q_k together (compact WY, :func:`_level_wy`), then propagate into the
    columns of the levels above.  The fixed variables' multipliers,
    -A_fix^T lam, are formed where they are used
    (``lexlsi._select_removal``)."""
    B, m, _ = f.lod.shape
    n, p = f.n_var, len(f.dims)
    dev, dtype = f.lod.device, f.lod.dtype
    col_pos = torch.arange(n, device=dev)
    j_idx = torch.arange(p, device=dev)[None, :, None]
    lam_all = torch.zeros(B, p, m, dtype=dtype, device=dev)
    rhs_all = torch.zeros(B, p, n, dtype=dtype, device=dev)
    offsets = [sum(f.dims[:k]) for k in range(p)]
    for k in range(p - 1, -1, -1):
        fr, dim = offsets[k], f.dims[k]
        if dim == 0:
            continue
        K = min(dim, n)
        rows = torch.arange(dim, device=dev)
        rank = f.ranks[:, k, None]
        V, W = _level_wy(f, k, fr)
        # objective k's own segment, Q_k [0; -rhs tail], and the lower
        # objectives' back-propagation segments, Q_k [z_j; 0]
        seg_top = torch.where(rows >= rank, -f.lod[:, fr:fr + dim, n], 0.0)
        cols = (f.first_col[:, k, None] + torch.arange(K, device=dev)).clamp(max=n - 1).long()
        segs = torch.zeros(B, p, dim, dtype=dtype, device=dev)
        segs[:, :, :K] = rhs_all.gather(2, cols[:, None, :].expand(B, p, K))
        segs = torch.where(rows < rank[:, :, None], segs, 0.0)
        seg_k = torch.where(j_idx == k, seg_top[:, None, :], segs)
        # (Q z)^T = z^T - (z^T V) W^T for every objective's row
        seg_k = seg_k - (seg_k @ V) @ W.transpose(1, 2)
        valid = j_idx >= k
        seg_k = torch.where(valid, seg_k, 0.0)
        lam_all[:, :, fr:fr + dim] = seg_k
        contrib = seg_k @ f.lod[:, fr:fr + dim, :n]
        above = (col_pos < f.first_col[:, k, None])[:, None, :]
        rhs_all = torch.where(valid & above, rhs_all - contrib, rhs_all)
    return lam_all
