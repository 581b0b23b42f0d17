"""The l-QR factorization's result and the equality solves, batched.

Counterpart of ``lexls_tpu/lexlse.py`` past the factorization (which is
:func:`lexls_tpu_torch.ops.factorize_fast_batched`): the ``LexQR``
fields, the basic solve (``lexlse.py:816-836``, reference
``lexlse.h:1015-1045``), the least-norm and general-norm solves
(``lexlse.py:838-983``), the residual and every objective's Lagrange
multipliers (``lexlse.py:1035-1186``), and the regularized multipliers of
a TIKHONOV_1 factorization (``lexlse.py:365-507``).
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


def _gathered_staircase(f: LexQR):
    """(Utri, rhs, live, U), batched: the n x n gathered position-space
    staircase (``lexlse.py:880-897``).  Row q of U (B, n, n+1) is the pivot
    row occupying position q; Utri is its upper triangle with identity rows
    beyond ``total_rank``, rhs its last column on the rank positions, and
    ``live`` (B, n) marks the rank positions.  A bounds-only hierarchy (no
    rows) gives the identity."""
    B, m, np1 = f.lod.shape
    n = f.n_var
    dev, dtype = f.lod.device, f.lod.dtype
    live = torch.arange(n, device=dev)[None, :] < f.total_rank[:, None]
    eye = torch.eye(n, dtype=dtype, device=dev)
    if m == 0:
        return (eye.expand(B, n, n), torch.zeros(B, n, dtype=dtype, device=dev), live,
                torch.zeros(B, n, np1, dtype=dtype, device=dev))
    U = f.lod.gather(1, f.rank_row.long()[:, :, None].expand(B, n, np1))
    Utri = torch.where(live[:, :, None], torch.triu(U[:, :, :n]), eye)
    rhs = torch.where(live, U[:, :, n], 0.0)
    return Utri, rhs, live, U


def _coupling(U, live):
    """T (B, n, n): the rank rows' entries in the columns beyond the rank
    (the T block of [R | T])."""
    n = U.shape[1]
    return torch.where(live[:, :, None] & ~live[:, None, :], U[:, :, :n], 0.0)


def _free(f: LexQR, live):
    """(B, n) positions of the free variables: beyond the rank, not fixed."""
    return ~live & ~f.fixed_mask.gather(1, f.perm.long())


def _utri_solve(Utri, rhs):
    return torch.linalg.solve_triangular(Utri, rhs[:, :, None], upper=True)[:, :, 0]


def _to_variables(f: LexQR, x_pos):
    """Positions to user variables, the fixed variables at their values."""
    x = torch.zeros_like(x_pos).scatter(1, f.perm.long(), x_pos)
    return torch.where(f.fixed_mask, f.fixed_val, x)


def _complete(f: LexQR, Utri, rhs, live, T, x_free):
    """x from the free part: x_rank = R^{-1}(rhs - T x_free) on the rank
    positions."""
    x_rank = _utri_solve(Utri, rhs - (T @ x_free[:, :, None])[:, :, 0]) * live
    return _to_variables(f, x_rank + x_free)


def solve(f: LexQR) -> torch.Tensor:
    """Basic solution (free variables = 0, fixed variables at their
    values), batched: one gathered n x n upper-triangular solve per
    instance, whose row q is the pivot row occupying position q (identity
    rows beyond ``total_rank``)."""
    Utri, rhs, _, _ = _gathered_staircase(f)
    return _to_variables(f, _utri_solve(Utri, rhs))


def _reduced(Utri, rhs, T):
    """(T_hat, t_hat) = R^{-1} [T | rhs] through the identity-extended R."""
    n = T.shape[2]
    W = torch.linalg.solve_triangular(Utri, torch.cat([T, rhs[:, :, None]], 2), upper=True)
    return W[:, :, :n], W[:, :, n]


def _normal_free(T_hat, t_hat, free):
    """x_free of min ||y||^2 + ||t_hat - T_hat y||^2 over the free
    positions: (T_hat^T T_hat + I) y = T_hat^T t_hat."""
    n = T_hat.shape[2]
    Tf = torch.where(free[:, None, :], T_hat, 0.0)
    D = Tf.transpose(1, 2) @ Tf + torch.eye(n, dtype=Tf.dtype, device=Tf.device)
    return torch.linalg.solve(D, (Tf.transpose(1, 2) @ t_hat[:, :, None])[:, :, 0]) * free


def solve_least_norm(f: LexQR) -> torch.Tensor:
    """Least-norm completion via the normal equations on the free block
    (``lexlse.py:838-877``, reference ``solveLeastNorm_2``,
    ``lexlse.h:1138-1213``), batched: with T_hat = R^{-1} T and t_hat =
    R^{-1} rhs, the free part solves (T_hat^T T_hat + I) x_free = T_hat^T
    t_hat; fixed variables are not free."""
    Utri, rhs, live, U = _gathered_staircase(f)
    T = _coupling(U, live)
    x_free = _normal_free(*_reduced(Utri, rhs, T), _free(f, live))
    return _complete(f, Utri, rhs, live, T, x_free)


def solve_least_norm_1(f: LexQR) -> torch.Tensor:
    """Least-norm completion via an orthogonal factorization
    (``lexlse.py:900-931``; the reference's Givens sequence,
    ``solveLeastNorm_1``, ``lexlse.h:1052-1131``): the same problem as
    :func:`solve_least_norm` by one QR of the stacked [T_hat; I] (B, 2n, n)
    per instance, without squaring its condition."""
    Utri, rhs, live, U = _gathered_staircase(f)
    n = f.n_var
    T = _coupling(U, live)
    T_hat, t_hat = _reduced(Utri, rhs, T)
    free = _free(f, live)
    # non-free columns are unit columns against a zero target: they solve to 0
    eye = torch.eye(n, dtype=T.dtype, device=T.device).expand_as(T_hat)
    S = torch.cat([torch.where(free[:, None, :], T_hat, 0.0), eye], 1)
    Q, Rq = torch.linalg.qr(S)
    # the target is [t_hat; 0], so Q^T b reads only Q's top n rows
    y = _utri_solve(Rq, (Q[:, :n].transpose(1, 2) @ t_hat[:, :, None])[:, :, 0])
    return _complete(f, Utri, rhs, live, T, y * free)


def solve_least_norm_3(f: LexQR) -> torch.Tensor:
    """Least-norm completion from the accumulated Tikhonov null-space
    basis (``lexlse.py:934-951``, reference ``solveLeastNorm_3``,
    ``lexlse.h:1222-1277``): needs a TIKHONOV factorization with zero
    factors, whose ``null_space`` holds -R^{-1}T in its free columns and
    -R^{-1}rhs in its last."""
    n = f.n_var
    live = torch.arange(n, device=f.lod.device)[None, :] < f.total_rank[:, None]
    free = _free(f, live)
    T_hat = torch.where(live[:, :, None] & free[:, None, :], -f.null_space[:, :, :n], 0.0)
    t_hat = torch.where(live, -f.null_space[:, :, n], 0.0)
    x_free = _normal_free(T_hat, t_hat, free)
    x_rank = (t_hat - (T_hat @ x_free[:, :, None])[:, :, 0]) * live
    return _to_variables(f, x_rank + x_free)


def solve_general_norm(f: LexQR, M: torch.Tensor, m_rhs: torch.Tensor) -> torch.Tensor:
    """The solution minimizing ||M x - m_rhs||^2 over the solution set
    (``lexlse.py:954-983``, reference ``solveGeneralNorm``,
    ``lexlse.h:1286-1363``), batched.  ``M`` is (r, n) shared or (B, r, n)
    in user variable order, ``m_rhs`` (r,) or (B, r).  The columns go to
    position space, the rank block is eliminated through R, and the free
    part solves the projected normal equations, identity-extended where an
    instance has fewer free positions than n."""
    Utri, rhs, live, U = _gathered_staircase(f)
    B, n = live.shape
    T = _coupling(U, live)
    M = M.to(U).expand(B, *M.shape[-2:])
    m_rhs = m_rhs.to(U).expand(B, M.shape[1])
    Mp = M.gather(2, f.perm.long()[:, None, :].expand_as(M))
    # LB = M_rank R^{-1}, a solve on the right through the identity-extended R
    LB = torch.linalg.solve_triangular(Utri, torch.where(live[:, None, :], Mp, 0.0),
                                       upper=True, left=False)
    LB = torch.where(live[:, None, :], LB, 0.0)
    TBaug = torch.cat([torch.where(~live[:, None, :], Mp, 0.0), m_rhs[:, :, None]], 2) \
        - LB @ torch.cat([T, rhs[:, :, None]], 2)
    free = _free(f, live)
    TB = torch.where(free[:, None, :], TBaug[:, :, :n], 0.0)
    D = TB.transpose(1, 2) @ TB
    eye = torch.eye(n, dtype=D.dtype, device=D.device)
    D = torch.where(free[:, :, None] & free[:, None, :], D, eye)
    d = (TB.transpose(1, 2) @ TBaug[:, :, n:])[:, :, 0] * free
    return _complete(f, Utri, rhs, live, T, torch.linalg.solve(D, d) * free)


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
    columns of the levels above.  The fixed variables' multipliers are
    :func:`fixed_multipliers` of the result."""
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


def residual(f: LexQR) -> torch.Tensor:
    """v = A x* - b (B, m), reconstructed level by level through the
    Householder sequence (``lexlse.py:1045-1057``, reference ``get_v``,
    ``lexlse.h:1560-1582``): Q_k applied to [0; -rhs tail] of level k."""
    B, m, _ = f.lod.shape
    n = f.n_var
    v = torch.zeros(B, m, dtype=f.lod.dtype, device=f.lod.device)
    for k, fr in enumerate(_offsets(f.dims)):
        dim = f.dims[k]
        if dim == 0:
            continue
        rows = torch.arange(dim, device=f.lod.device)
        seg = torch.where(rows >= f.ranks[:, k, None], -f.lod[:, fr:fr + dim, n], 0.0)
        v[:, fr:fr + dim] = _apply_wy(*_level_wy(f, k, fr), seg)
    return v


def fixed_multipliers(lam_all, A_fixed_cols, fixed_mask):
    """The fixed variables' multipliers, -A_fix^T lam, (B, p, n) from the
    multipliers ``lam_all`` (B, p, m) and the original columns
    ``A_fixed_cols`` ((m, n) or (B, m, n)); zero where a variable is not
    fixed (``lexlse.py:1109-1111, 1171-1174``)."""
    return torch.where(fixed_mask[:, None, :], -(lam_all @ A_fixed_cols), 0.0)


def lambda_matrix(f: LexQR, A_fixed_cols=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """All multipliers, (lam_fixed (B, n, p), lam (B, m, p)): column k
    holds objective k's (``lexlse.py:1178-1186``), from
    :func:`sensitivities_all`.  ``lam_fixed`` is zero without
    ``A_fixed_cols``."""
    lam_all = sensitivities_all(f)
    if A_fixed_cols is None:
        lam_fixed = lam_all.new_zeros(lam_all.shape[0], len(f.dims), f.n_var)
    else:
        lam_fixed = fixed_multipliers(lam_all, A_fixed_cols.to(lam_all), f.fixed_mask)
    return lam_fixed.transpose(1, 2), lam_all.transpose(1, 2)


def objective_sensitivity(f: LexQR, obj_index: int,
                          A_fixed_cols=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lagrange multipliers of objective ``obj_index``, (lam_fixed (B, n),
    lam (B, m)) (``lexlse.py:1060-1112``, reference
    ``ObjectiveSensitivity``, ``lexlse.h:611-762``): column ``obj_index``
    of :func:`lambda_matrix`."""
    lam_fixed, lam = lambda_matrix(f, A_fixed_cols)
    return lam_fixed[:, :, obj_index], lam[:, :, obj_index]


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
