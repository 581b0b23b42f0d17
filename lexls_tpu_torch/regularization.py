"""Per-level regularization of the l-QR, batched.

Counterpart of ``lexls_tpu/regularization.py`` (reference
``lexlse.h:1700-2694``): each variant replaces the rhs segment of the
current level by [R_k, T_k] y* where y* solves a damped subproblem over
the remaining variables (optionally coupled through the accumulated
null-space basis S_{k-1}).

Every function takes a batch: ``level_rows`` (B, K, n+1) is the
POSITION-SPACE view of each instance's level rows ([R | T | rhs] with
Householder essentials below the staircase), ``null_space`` (B, n, n+1)
the accumulated basis in position space, and ``first_col``, ``rank``,
``col_index`` and ``factor`` are (B,) tensors (``factor`` may also be a
0-dim tensor shared by the batch).  Subproblems are padded to n x n and
solved with one batched Cholesky (or CGLS with a fixed trip count); masks
realize the data-dependent split into rank and remaining columns.  These
are torch ops: the JAX package computes them in plain XLA, outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .types import ParametersLexLSE, RegularizationType

# the variants whose damped problem couples through the accumulated null space
_NULL_SPACE_TYPES = frozenset({
    RegularizationType.TIKHONOV, RegularizationType.TIKHONOV_1,
    RegularizationType.TIKHONOV_2, RegularizationType.TIKHONOV_CG, RegularizationType.R,
})


def _col(t: torch.Tensor) -> torch.Tensor:
    """A (B,) or 0-dim per-instance scalar as a column that broadcasts
    against (B, ...) rows."""
    return t.reshape(-1, 1)


def _staircase_R(rows, first_col, rank):
    """(B, K, K) upper-triangular R of each level from its (B, K, c)
    position-space rows, gathered at the dynamic offset ``first_col``
    (columns clamped to c - 1) and padded with the identity at and beyond
    the rank, and the gather's column indices (B, K)."""
    B, K, c = rows.shape
    ar = torch.arange(K, device=rows.device)
    cols_k = (first_col[:, None] + ar).clamp(max=c - 1).long()
    Rpad = rows.gather(2, cols_k[:, None, :].expand(B, K, K))
    r3 = rank[:, None, None]
    in_rank = (ar[:, None] < r3) & (ar[None, :] < r3) & (ar[None, :] >= ar[:, None])
    eye = torch.eye(K, dtype=rows.dtype, device=rows.device)
    return torch.where(in_rank, Rpad, eye), cols_k


def variable_factor(level_rows, eps, first_col, rank, n, factor):
    """Conditioning-driven damping (``regularization.py:51-72``, reference
    ``lexlse.h:277-312``, Chiaverini's formula): ce = |rhs| / |R^-1 rhs|;
    damp by factor * sqrt(1 - ce^2/eps^2) where ce < eps.  Returns (B,)."""
    K = level_rows.shape[1]
    Rm, _ = _staircase_R(level_rows, first_col, rank)
    rows = torch.arange(K, device=level_rows.device)
    rhs_seg = torch.where(rows < rank[:, None], level_rows[:, :, n], 0.0)
    y = torch.linalg.solve_triangular(Rm, rhs_seg[:, :, None], upper=True)[:, :, 0]
    num = (rhs_seg * rhs_seg).sum(1)
    den = (y * y).sum(1)
    ce = num / torch.where(den > 0, den, 1.0)
    damp = torch.sqrt(torch.clamp(1.0 - (ce * ce) / (eps * eps), min=0.0))
    return torch.where((rank > 0) & (ce < eps), damp * factor, 0.0)


def apply_level_regularization(params: ParametersLexLSE, level_rows, null_space, first_col,
                               rank, col_index, factor, n: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Regularize the rhs segment of the current level, then accumulate
    the null-space basis for the variants that need it
    (``regularization.py:75-140``).  Returns (rhs (B, K), null_space); the
    caller writes the rhs back into its own layout."""
    rt = params.regularization_type
    K = level_rows.shape[1]
    do_reg = (factor != 0.0) & (rank > 0)
    if rt in (RegularizationType.TIKHONOV, RegularizationType.TIKHONOV_1,
              RegularizationType.TIKHONOV_2):
        new_rhs = _tikhonov_full(level_rows, null_space, first_col, rank, factor, n)
    elif rt == RegularizationType.TIKHONOV_CG:
        new_rhs = _tikhonov_cg(params, level_rows, null_space, first_col, rank, factor, n)
    elif rt == RegularizationType.R:
        new_rhs = _reg_R(level_rows, null_space, first_col, rank, factor, n)
    elif rt == RegularizationType.R_NO_Z:
        new_rhs = _reg_R_no_z(level_rows, first_col, rank, factor, n)
    elif rt == RegularizationType.RT_NO_Z:
        new_rhs = _reg_RT_no_z(level_rows, first_col, rank, factor, n)
    elif rt == RegularizationType.RT_NO_Z_CG:
        new_rhs = _rt_no_z_cg(params, level_rows, first_col, rank, factor, n)
    elif rt == RegularizationType.TEST:
        new_rhs = level_rows[:, :, n] * _col(factor)
    else:
        new_rhs = level_rows[:, :, n]
    rows = torch.arange(K, device=level_rows.device)
    keep = _col(do_reg) & (rows < rank[:, None])
    rhs_out = torch.where(keep, new_rhs, level_rows[:, :, n])
    if rt in _NULL_SPACE_TYPES:
        # uses the REGULARIZED rhs (lexlse.h:2592-2625)
        lv = torch.cat([level_rows[:, :, :n], rhs_out[:, :, None]], 2)
        null_space = _accumulate_nullspace(lv, null_space, first_col, rank, col_index, n)
    return rhs_out, null_space


def _level_RT(level_rows, first_col, rank, n):
    """The level's [R, T] (B, K, n): the entries of its first ``rank`` rows
    on and right of the staircase (row i starts at column first_col + i;
    the strictly lower entries hold Householder essentials), and the rhs of
    those rows (B, K)."""
    K = level_rows.shape[1]
    rows = torch.arange(K, device=level_rows.device)
    pos = torch.arange(n, device=level_rows.device)
    live = (rows < rank[:, None])[:, :, None]
    stair = pos[None, None, :] >= (first_col[:, None] + rows)[:, :, None]
    RT = torch.where(live & stair, level_rows[:, :, :n], 0.0)
    return RT, torch.where(rows < rank[:, None], level_rows[:, :, n], 0.0)


def _level_blocks(level_rows, null_space, first_col, rank, n):
    """The level's masked blocks, padded to static shapes
    (``regularization.py:143-163``): [R, T] and its rhs (:func:`_level_RT`),
    S (B, n, n) the accumulated null-space rows above the level restricted
    to the remaining columns, and s (B, n) their rhs."""
    RT, rhs_k = _level_RT(level_rows, first_col, rank, n)
    fc = first_col[:, None]
    above = torch.arange(null_space.shape[1], device=RT.device) < fc          # (B, n)
    remaining = torch.arange(n, device=RT.device) >= fc
    S = torch.where(above[:, :, None] & remaining[:, None, :], null_space[:, :, :n], 0.0)
    s = torch.where(above, null_space[:, :, n], 0.0)
    return RT, rhs_k, S, s


def _masked_chol_solve(D, d, active):
    """Solve D y = d on the active coordinates, the identity elsewhere,
    batched (``regularization.py:166-174``).  ``torch.linalg.cholesky_ex``
    neither raises nor synchronises with the host; a matrix that is not
    positive definite gives NaN, as ``jnp.linalg.cholesky`` does."""
    nn = D.shape[-1]
    eye = torch.eye(nn, dtype=D.dtype, device=D.device)
    Dm = torch.where(active[:, :, None] & active[:, None, :], D, eye)
    dm = torch.where(active, d, 0.0)
    L, info = torch.linalg.cholesky_ex(Dm)
    L = torch.where((info != 0)[:, None, None], torch.nan, L)
    return torch.cholesky_solve(dm[:, :, None], L)[:, :, 0] * active.to(D.dtype)


def _gram(X):
    return X.transpose(1, 2) @ X


def _tvec(X, v):
    """X^T v, batched: (B, r, c), (B, r) -> (B, c)."""
    return (v[:, None, :] @ X)[:, 0]


def _mvec(X, v):
    """X v, batched: (B, r, c), (B, c) -> (B, r)."""
    return (X @ v[:, :, None])[:, :, 0]


def _tikhonov_full(level_rows, null_space, first_col, rank, factor, n, return_y: bool = False):
    """min ||[R,T] y - rhs||^2 + mu^2 ||S y - s||^2 + mu^2 ||y||^2 over the
    remaining variables (positions >= first_col), by the primal normal
    equations (``regularization.py:177-196``, reference
    ``regularize_tikhonov_1``, ``lexlse.h:1700-1763``)."""
    mu = _col(factor * factor)[:, :, None]
    A1, rhs_k, S, s = _level_blocks(level_rows, null_space, first_col, rank, n)
    active = torch.arange(n, device=level_rows.device) >= first_col[:, None]
    eye = torch.eye(n, dtype=level_rows.dtype, device=level_rows.device)
    D = _gram(A1) + mu * _gram(S) + mu * eye
    d = _tvec(A1, rhs_k) + mu[:, :, 0] * _tvec(S, s)
    y = _masked_chol_solve(D, d, active)
    new_rhs = _mvec(A1, y)
    return (new_rhs, y) if return_y else new_rhs


def _basic_R(level_rows, first_col, rank, n):
    """The level's R restricted to its basic columns [first_col,
    first_col + rank), the rhs of its rank rows, and the basic-column mask."""
    K = level_rows.shape[1]
    dev = level_rows.device
    rows = torch.arange(K, device=dev)
    pos = torch.arange(n, device=dev)
    fc = first_col[:, None]
    basic = (pos >= fc) & (pos < fc + rank[:, None])                 # (B, n)
    stair = (pos[None, None, :] >= (fc + rows)[:, :, None]) & basic[:, None, :]
    R = torch.where((rows < rank[:, None])[:, :, None] & stair, level_rows[:, :, :n], 0.0)
    rhs_k = torch.where(rows < rank[:, None], level_rows[:, :, n], 0.0)
    return R, rhs_k, basic


def _reg_R(level_rows, null_space, first_col, rank, factor, n):
    """Tikhonov on the basic variables only (``regularization.py:199-222``,
    ``lexlse.h:2138-2170``)."""
    mu = _col(factor * factor)[:, :, None]
    R, rhs_k, basic = _basic_R(level_rows, first_col, rank, n)
    above = torch.arange(null_space.shape[1], device=R.device) < first_col[:, None]
    up = torch.where(above[:, :, None] & basic[:, None, :], null_space[:, :, :n], 0.0)
    s = torch.where(above, null_space[:, :, n], 0.0)
    eye = torch.eye(n, dtype=R.dtype, device=R.device)
    D = _gram(R) + mu * _gram(up) + mu * eye
    d = mu[:, :, 0] * _tvec(up, s) + _tvec(R, rhs_k)
    return _mvec(R, _masked_chol_solve(D, d, basic))


def _reg_R_no_z(level_rows, first_col, rank, factor, n):
    """``regularization.py:225-243`` (``lexlse.h:2175-2202``)."""
    mu = _col(factor * factor)[:, :, None]
    R, rhs_k, basic = _basic_R(level_rows, first_col, rank, n)
    eye = torch.eye(n, dtype=R.dtype, device=R.device)
    y = _masked_chol_solve(_gram(R) + mu * eye, _tvec(R, rhs_k), basic)
    return _mvec(R, y)


def _reg_RT_no_z(level_rows, first_col, rank, factor, n):
    """Dual form on [R, T] only (``regularization.py:246-262``,
    ``lexlse.h:2207-2242``): rhs <- (D - mu I) d with D = [R,T][R,T]' +
    mu I and D d = rhs."""
    K = level_rows.shape[1]
    mu = _col(factor * factor)[:, :, None]
    A1, rhs_k = _level_RT(level_rows, first_col, rank, n)
    active = torch.arange(K, device=A1.device) < rank[:, None]
    eye = torch.eye(K, dtype=A1.dtype, device=A1.device)
    d = _masked_chol_solve(A1 @ A1.transpose(1, 2) + mu * eye, rhs_k, active)
    return _mvec(A1, _tvec(A1, d)) * active.to(A1.dtype)


def _cgls(matvec, rmatvec, b, x0, iters: int, tol: float):
    """Fixed-trip-count CGLS with convergence masking, batched
    (``regularization.py:265-290``, reference ``cg_tikhonov`` /
    ``cg_RT``, ``lexlse.h:2367-2554``).  Vectors of the residual space are
    tuples of (B, r_i) parts, and every inner product sums part by part,
    as the JAX tracker's hand-batched CGLS does."""
    def sq(parts):
        return sum((q * q).sum(1) for q in parts)

    x = x0
    r = tuple(bi - qi for bi, qi in zip(b, matvec(x0)))
    s = rmatvec(r)
    p = s
    gamma = sq((s,))
    for _ in range(iters):
        live = torch.sqrt(gamma) > tol
        q = matvec(p)
        qq = sq(q)
        alpha = torch.where((qq > 0) & live, gamma / qq, 0.0)[:, None]
        x = x + alpha * p
        r = tuple(ri - alpha * qi for ri, qi in zip(r, q))
        s = rmatvec(r)
        gamma_new = sq((s,))
        beta = torch.where(gamma > 0, gamma_new / gamma, 0.0)[:, None]
        p = torch.where(live[:, None], s + beta * p, p)
        gamma = torch.where(live, gamma_new, gamma)
    return x


def cgls_tikhonov(A1, S1: Optional[torch.Tensor], s_vec, c, factor, active, iters: int,
                  tol: float = 1e-12):
    """y minimizing ||A1 y - c||^2 + f^2 ||S1 y - s||^2 + f^2 ||y||^2 over
    the ``active`` coordinates by ``iters`` trips of CGLS (reference
    ``cg_tikhonov``, ``lexlse.h:2367-2430``); ``S1 = None`` drops the
    null-space term (``cg_RT``).  A1 (B, K, n), S1 (B, r, n), active
    (B, n) float or bool.  The iterates touch the data only through
    A_aug^T A_aug products and norms, so they do not depend on the
    orthonormal frame of A1's rows: the tracker runs this same iteration
    in its own frame (``tracker.py:337-392``)."""
    f = _col(factor)
    act = active.to(A1.dtype)

    def matvec(y):
        parts = (_mvec(A1, y),)
        if S1 is not None:
            parts += (f * _mvec(S1, y),)
        return parts + (f * y,)

    def rmatvec(r):
        g = _tvec(A1, r[0]) + f * r[-1]
        if S1 is not None:
            g = g + f * _tvec(S1, r[1])
        return g * act

    b = (c,) + ((f * s_vec,) if S1 is not None else ()) + (torch.zeros_like(act),)
    return _cgls(matvec, rmatvec, b, torch.zeros_like(act), iters, tol) * act


def _tikhonov_cg(params, level_rows, null_space, first_col, rank, factor, n):
    """CGLS on the stacked damped system (``regularization.py:293-316``,
    ``lexlse.h:2256-2279``)."""
    A1, rhs_k, S, s = _level_blocks(level_rows, null_space, first_col, rank, n)
    active = torch.arange(n, device=A1.device) >= first_col[:, None]
    y = cgls_tikhonov(A1, S, s, rhs_k, factor, active, params.max_number_of_CG_iterations)
    return _mvec(A1, y)


def _rt_no_z_cg(params, level_rows, first_col, rank, factor, n):
    """CGLS without the null-space coupling (``regularization.py:319-343``,
    ``lexlse.h:2333-2356``)."""
    A1, rhs_k = _level_RT(level_rows, first_col, rank, n)
    active = torch.arange(n, device=A1.device) >= first_col[:, None]
    y = cgls_tikhonov(A1, None, None, rhs_k, factor, active, params.max_number_of_CG_iterations)
    return _mvec(A1, y)


def _accumulate_nullspace(level_rows, null_space, first_col, rank, col_index, n):
    """Accumulate Z_1 ... Z_k, Z_j = [-inv(R_j) T_j; I] with the identity
    implicit (``regularization.py:346-395``, reference
    ``lexlse.h:2592-2625``).  Rows < first_col hold S_{k-1}; the update
    writes left = [S_prev restricted to the level's pivot columns; I] R^-1
    into columns [first_col, first_col + rank) and subtracts left [T_k |
    rhs_k] from the trailing columns.  Instances of rank 0 keep theirs."""
    B, K, np1 = level_rows.shape
    dev = level_rows.device
    rows_n = torch.arange(null_space.shape[1], device=dev)[None, :, None]
    pos = torch.arange(np1, device=dev)
    fc, rk = first_col[:, None, None], rank[:, None, None]
    jj = torch.arange(K, device=dev)
    Rm, cols_k = _staircase_R(level_rows, first_col, rank)
    Sleft = null_space.gather(2, cols_k[:, None, :].expand(B, null_space.shape[1], K))
    Sleft = torch.where(rows_n < fc, Sleft, 0.0)
    eye_rows = ((rows_n >= fc) & (rows_n < fc + rk) & (rows_n - fc == jj)).to(level_rows.dtype)
    left = torch.linalg.solve_triangular(Rm, Sleft + eye_rows, upper=True, left=False)
    left = torch.where(jj < rk, left, 0.0)
    Up = torch.where((jj[None, :, None] < rk) & (pos >= col_index[:, None, None]),
                     level_rows, 0.0)
    new_ns = null_space - torch.where(pos >= col_index[:, None, None], left @ Up, 0.0)
    rel = (pos - first_col[:, None]).clamp(0, K - 1)
    left_full = left.gather(2, rel[:, None, :].expand(B, null_space.shape[1], np1))
    write = (pos >= first_col[:, None]) & (pos < (first_col + rank)[:, None])
    new_ns = torch.where(write[:, None, :], left_full, new_ns)
    return torch.where((rank == 0)[:, None, None], null_space, new_ns)
