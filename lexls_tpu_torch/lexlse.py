"""The l-QR factorization's result and its basic solve, batched.

Counterpart of the parts of ``lexls_tpu/lexlse.py`` that the ported
tiers need: the ``LexQR`` fields that
:func:`lexls_tpu_torch.ops.factorize_fast_batched` fills, the basic
solve (``lexlse.py:816-836``, reference ``lexlse.h:1015-1045``), every
objective's Lagrange multipliers (``lexlse.py:1115-1175``), and the
regularized multipliers of a TIKHONOV_1 factorization
(``lexlse.py:365-507``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .regularization import _staircase_R


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
    null_space (B, n, n+1) accumulated null-space basis of a regularized
                           factorization, position space (zero otherwise)
    X_mu       (B, n, p)   TIKHONOV_1: each objective's damped solution
    residual_mu (B, m)     TIKHONOV_1: the damped residuals
    reg_factors (B, p)     TIKHONOV_1: the levels' damping factors
    (the last three have a zero-sized axis for the other types)
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
    null_space: torch.Tensor
    X_mu: torch.Tensor
    residual_mu: torch.Tensor
    reg_factors: torch.Tensor
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
    (``lexlse.py:991-1032``), read from the level's pivot columns of the
    physicalized factorization.  Two batched products apply Q_k to all
    objectives at once, where a sequential replay takes K dependent steps
    for each level: on the card each step is several launches, so the
    replay is kept for the plain version of kernel B2, which mirrors the
    kernel's own order."""
    n, dim = f.n_var, f.dims[k]
    K = min(dim, n)
    cols = (f.first_col[:, k, None] + torch.arange(K, device=f.lod.device)).clamp(max=n)
    return _wy_raw(f.lod, f.hh, fr, dim, cols)


def _wy_raw(lod, hh, fr: int, dim: int, cols) -> Tuple[torch.Tensor, torch.Tensor]:
    """WY factors from raw factorization storage, usable in the middle of
    a factorization (``lexlse.py:1010-1032``): ``cols`` (B, K) are the
    level's pivot columns in ``lod``.  V is the unit lower trapezoid of
    reflection vectors and W = V T with T^{-1} = diag(1/tau) +
    striu(V^T V); dead reflections (tau = 0, beyond the rank) have a zero
    column in V and a unit diagonal in T^{-1}."""
    B = lod.shape[0]
    K = cols.shape[1]
    dev, dtype = lod.device, lod.dtype
    jj = torch.arange(K, device=dev)
    M = lod[:, fr:fr + dim].gather(2, cols.long()[:, None, :].expand(B, dim, K))
    rloc = torch.arange(dim, device=dev)[:, None]
    tau = hh[:, fr:fr + K]
    live = tau != 0
    V = torch.where(rloc > jj, M, (rloc == jj).to(dtype)) * live[:, None, :].to(dtype)
    Tinv = torch.triu(V.transpose(1, 2) @ V, 1) + torch.diag_embed(
        torch.where(live, 1.0 / torch.where(live, tau, 1.0), 1.0))
    W = torch.linalg.solve_triangular(Tinv, V, upper=True, left=False)
    return V, W


def _apply_wy(V, W, seg):
    """Q seg = seg - W (V^T seg), batched over (B, dim) segments."""
    return seg - (W @ (seg[:, None, :] @ V).transpose(1, 2))[:, :, 0]


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


# ---------------------------------------------------------------------------
# Regularized multipliers (TIKHONOV_1)
# ---------------------------------------------------------------------------


def _offsets(dims):
    return [sum(dims[:k]) for k in range(len(dims))]


def _scatter_level(X, z, fc, r, K: int):
    """X with positions [fc, fc + r) replaced by z[q - fc], batched."""
    q = torch.arange(X.shape[1], device=X.device)
    in_lvl = (q >= fc[:, None]) & (q < (fc + r)[:, None])
    return torch.where(in_lvl, z.gather(1, (q - fc[:, None]).clamp(0, K - 1)), X)


def _intermediate_x(lod, dims, first_cols, ranks, obj: int, fcol_obj, X_pos, n: int):
    """``get_intermediate_x`` (``lexlse.py:365-408``, reference
    ``lexlse.h:2010-2071``), batched: given X_pos (B, n) holding the
    current level's damped solution on positions >= fcol_obj, fill the
    rank positions of earlier levels by back-substitution through the
    staircase.  ``lod`` holds the levels above in position space;
    ``first_cols``/``ranks`` are lists of (B,) tensors."""
    if obj == 0:
        return X_pos
    offsets = _offsets(dims)
    q = torch.arange(n, device=lod.device)
    tail_mask = (q >= fcol_obj[:, None]).to(lod.dtype)
    rows_of = lambda i: torch.arange(min(dims[i], n), device=lod.device)  # noqa: E731
    for i in range(obj):
        K_i = min(dims[i], n)
        if K_i == 0:
            continue
        fr = offsets[i]
        contrib = (lod[:, fr:fr + K_i, :n] @ (X_pos * tail_mask)[:, :, None])[:, :, 0]
        vec = torch.where(rows_of(i) < ranks[i][:, None], lod[:, fr:fr + K_i, n] - contrib, 0.0)
        X_pos = _scatter_level(X_pos, vec, first_cols[i], ranks[i], K_i)
    for k in range(obj - 1, -1, -1):
        K_k = min(dims[k], n)
        if K_k == 0:
            continue
        fr = offsets[k]
        rows_k = lod[:, fr:fr + K_k, :n]
        mid = ((q >= first_cols[k + 1][:, None]) & (q < fcol_obj[:, None])).to(lod.dtype)
        coupling = (rows_k @ (X_pos * mid)[:, :, None])[:, :, 0]
        Rm, cols = _staircase_R(rows_k, first_cols[k], ranks[k])
        live = rows_of(k) < ranks[k][:, None]
        seg = torch.where(live, X_pos.gather(1, cols) - coupling, 0.0)
        z = torch.linalg.solve_triangular(Rm, seg[:, :, None], upper=True)[:, :, 0]
        X_pos = _scatter_level(X_pos, torch.where(live, z, 0.0), first_cols[k], ranks[k], K_k)
    return X_pos


def initialize_rhs_regularized(f: LexQR, obj_index: int) -> torch.Tensor:
    """Seed of the regularized multipliers' back-propagation
    (``lexlse.py:411-451``, reference ``initialize_rhs``,
    ``lexlse.h:1920-1959``): forward substitution of -mu^2 X_mu through
    the transposed staircase.  Returns (B, n) in position space."""
    n = f.n_var
    offsets = _offsets(f.dims)
    q = torch.arange(n, device=f.lod.device)
    mu2 = f.reg_factors[:, obj_index, None] ** 2
    X = -mu2 * f.X_mu[:, :, obj_index].gather(1, f.perm.long())
    last_col = (f.first_col[:, obj_index] + f.ranks[:, obj_index])[:, None]
    for k in range(obj_index + 1):
        K_k = min(f.dims[k], n)
        fc_k, r_k = f.first_col[:, k], f.ranks[:, k]
        if k > 0 and f.dims[k - 1]:
            K_p = min(f.dims[k - 1], n)
            fc_p, r_p = f.first_col[:, k - 1], f.ranks[:, k - 1]
            cols_p = (fc_p[:, None] + torch.arange(K_p, device=q.device)).clamp(max=n - 1)
            xp = torch.where(torch.arange(K_p, device=q.device) < r_p[:, None],
                             X.gather(1, cols_p.long()), 0.0)
            fr_p = offsets[k - 1]
            contrib = (xp[:, None, :] @ f.lod[:, fr_p:fr_p + K_p, :n])[:, 0]
            X = torch.where((q >= fc_k[:, None]) & (q < last_col), X - contrib, X)
        if K_k == 0:
            continue
        fr = offsets[k]
        Rm, cols = _staircase_R(f.lod[:, fr:fr + K_k, :n], fc_k, r_k)
        live = torch.arange(K_k, device=q.device) < r_k[:, None]
        seg = torch.where(live, X.gather(1, cols), 0.0)
        z = torch.linalg.solve_triangular(Rm.transpose(1, 2), seg[:, :, None],
                                          upper=False)[:, :, 0]
        X = _scatter_level(X, torch.where(live, z, 0.0), fc_k, r_k, K_k)
    return X


def x_mu_rhs(f: LexQR) -> torch.Tensor:
    """Column j holds the seed of objective j's regularized-multiplier
    back-propagation, (B, n, p) (``lexlse.py:454-463``, reference
    ``get_X_mu_rhs``).  Needs a TIKHONOV_1 factorization."""
    if f.X_mu.numel() == 0:
        raise ValueError("x_mu_rhs requires a TIKHONOV_1 factorization")
    return torch.stack([initialize_rhs_regularized(f, j) for j in range(len(f.dims))], 2)


def objective_sensitivity_regularized(f: LexQR, obj_index: int) -> torch.Tensor:
    """Regularized multipliers of objective ``obj_index`` (TIKHONOV_1),
    (B, m) (``lexlse.py:466-506``): the top segment is the damped residual
    ``residual_mu`` and the back-propagation is seeded by
    :func:`initialize_rhs_regularized` (reference ``ObjectiveSensitivity``
    with ``compute_residual_from_factorization = false``).  The fixed
    variables' multipliers are formed where they are used
    (``lexlsi._select_removal``)."""
    B, m, _ = f.lod.shape
    n = f.n_var
    dev = f.lod.device
    offsets = _offsets(f.dims)
    col_pos = torch.arange(n, device=dev)
    lam = torch.zeros(B, m, dtype=f.lod.dtype, device=dev)
    rhs = initialize_rhs_regularized(f, obj_index)
    above = col_pos < f.first_col[:, obj_index, None]
    rhs = torch.where(above, rhs, 0.0)
    fr, dim = offsets[obj_index], f.dims[obj_index]
    seg = f.residual_mu[:, fr:fr + dim]
    lam[:, fr:fr + dim] = seg
    if obj_index > 0:
        rhs = rhs - torch.where(above, (seg[:, None, :] @ f.lod[:, fr:fr + dim, :n])[:, 0], 0.0)
        for k in range(obj_index - 1, -1, -1):
            frk, dimk = offsets[k], f.dims[k]
            if dimk == 0:
                continue
            K = min(dimk, n)
            cols = (f.first_col[:, k, None] + torch.arange(K, device=dev)).clamp(max=n - 1)
            segk = torch.zeros(B, dimk, dtype=f.lod.dtype, device=dev)
            segk[:, :K] = rhs.gather(1, cols.long())
            segk = torch.where(torch.arange(dimk, device=dev) < f.ranks[:, k, None], segk, 0.0)
            segk = _apply_wy(*_level_wy(f, k, frk), segk)
            lam[:, frk:frk + dimk] = segk
            contrib = (segk[:, None, :] @ f.lod[:, frk:frk + dimk, :n])[:, 0]
            rhs = rhs - torch.where(col_pos < f.first_col[:, k, None], contrib, 0.0)
    return lam
