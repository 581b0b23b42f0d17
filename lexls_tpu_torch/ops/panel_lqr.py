"""Kernel B1: the level-panel factorization, and the batched l-QR over it.

``panel_factorize`` runs the whole pivot loop of one level's
column-pivoted Householder factorization (reference ``lexlse.h:182-268``)
for every instance of a batch.  It replaces the Pallas TPU kernel
``lexls_tpu/ops/pallas_lqr.py::panel_factorize`` (``pl.pallas_call`` at
``pallas_lqr.py:238``).  On a CUDA tensor it launches the hand-written
kernel in ``csrc/panel_lqr.cu`` (one thread block per instance); on a CPU
tensor it runs ``panel_factorize_ref``, the plain batched version of the
same steps.  ``_panel_step`` is the plain step that both plain versions
(this one and ``ops/fused.py``'s) share, as the CUDA kernels share
``csrc/panel_step.cuh``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..types import LexLSError, ParametersLexLSE, RegularizationType
from . import _build

INT_MAX = torch.iinfo(torch.int32).max


def _panel_step(counter, block, cn, pos, col_at, ci, stopped, rank_row, hh,
                *, fr, tol, lean=False):
    """One pivot step on a (B, dim, n+1) level block, virtual permutation
    (``pallas_lqr.py:46-156``).  ``ci`` (B,) is the next free position and
    ``stopped`` (B,) bool the sticky rank cutoff.  ``lean=True`` skips the
    ``col_at``/``rank_row`` bookkeeping (inputs returned unchanged).
    Returns the updated state and ``u_live``, the reflection vector of
    the step (zero when the step is dead)."""
    B, dim, np1 = block.shape
    n = np1 - 1
    dev = block.device
    phys = torch.arange(n, device=dev)
    rows = torch.arange(dim, device=dev)
    ci2 = ci[:, None]

    # pivot: max column norm among remaining positions, ties to the
    # smallest position
    remaining = pos >= ci2
    masked = torch.where(remaining, cn, -1.0)
    mx = masked.amax(1, keepdim=True)
    cand = remaining & (masked == mx)
    qmin = torch.where(cand, pos, INT_MAX).amin(1)  # (B,)
    piv_hot = cand & (pos == qmin[:, None])
    has = piv_hot.any(1)
    piv = piv_hot.to(torch.int32).argmax(1)  # physical pivot column
    colv = block[:, :, :n].gather(2, piv[:, None, None].expand(B, dim, 1))[:, :, 0]
    colv = torch.where(has[:, None], colv, 0.0)

    # stability recomputation over the remaining rows (lexlse.h:208)
    row_live = rows >= counter
    max_val = torch.where(row_live, colv * colv, 0.0).sum(1)
    cn = torch.where(piv_hot, max_val[:, None], cn)

    ok = max_val >= tol
    accept = ok & ~stopped & (ci < n)
    stopped = stopped | ~ok
    acc2 = accept[:, None]

    # virtual swap: position of the pivot <-> position ci
    q2 = qmin[:, None]
    if lean:
        pos = torch.where(acc2 & (pos == ci2), q2,
                          torch.where(acc2 & piv_hot, ci2, pos))
    else:
        c1 = col_at.gather(1, ci.clamp(max=n - 1).long()[:, None])
        pos = torch.where(acc2 & (phys == c1), q2,
                          torch.where(acc2 & piv_hot, ci2, pos))
        col_at = torch.where(acc2 & (phys == ci2), piv[:, None].to(col_at.dtype),
                             torch.where(acc2 & (phys == q2), c1, col_at))

    # Householder reflection of the remaining rows
    seg = torch.where(row_live, colv, 0.0)
    c0 = seg[:, counter]
    s_tail = torch.where(rows > counter, seg * seg, 0.0).sum(1)
    nonzero_tail = s_tail > 0
    beta = torch.sqrt(c0 * c0 + s_tail)
    beta = torch.where(c0 >= 0, -beta, beta)
    beta = torch.where(nonzero_tail, beta, c0)
    denom = torch.where(nonzero_tail, c0 - beta, torch.ones_like(c0))
    tau = torch.where(nonzero_tail, (beta - c0) / beta, torch.zeros_like(c0))
    essential = seg / denom[:, None]
    u = torch.where(rows == counter, 1.0, torch.where(rows > counter, essential, 0.0))

    w = (u[:, :, None] * block).sum(1)  # (B, n+1)
    trailing = torch.cat([pos > ci2, torch.ones(B, 1, dtype=torch.bool, device=dev)], 1)
    wmask = torch.where(trailing, w, 0.0)
    newcol = torch.where(rows == counter, beta[:, None],
                         torch.where(rows > counter, essential, colv))
    newcol = torch.where(acc2, newcol, colv)
    hot_p1 = torch.cat([piv_hot, torch.zeros(B, 1, dtype=torch.bool, device=dev)], 1)
    upd = (tau * accept.to(block.dtype))[:, None, None] * u[:, :, None] * wmask[:, None, :]
    block = torch.where(hot_p1[:, None, :], newcol[:, :, None], block - upd)

    hh = torch.where((rows == counter) & acc2, tau[:, None], hh)
    if not lean:
        rank_row = torch.where(acc2 & (phys == ci2), fr + counter, rank_row)

    # downdate of the column norms by the updated pivot row
    prow = block[:, counter, :n]
    dd = torch.where(pos > ci2, prow * prow, 0.0)
    cn = torch.where(acc2, cn - dd, cn)

    u_live = u * (accept & (tau != 0))[:, None].to(u.dtype)
    ci = ci + accept.to(ci.dtype)
    return block, cn, pos, col_at, ci, stopped, rank_row, hh, u_live


def panel_factorize_ref(block, pos, col_at, col_index, rank_row, *, fr, tol):
    """Plain version of :func:`panel_factorize`: ``_panel_loop``
    (``pallas_lqr.py:159-175``) in torch, every one of the dim steps."""
    B, dim, np1 = block.shape
    n = np1 - 1
    cn = (block[:, :, :n] * block[:, :, :n]).sum(1)
    hh = torch.zeros(B, dim, dtype=block.dtype, device=block.device)
    stopped = torch.zeros(B, dtype=torch.bool, device=block.device)
    ci = col_index
    for counter in range(dim):
        block, cn, pos, col_at, ci, stopped, rank_row, hh, _ = _panel_step(
            counter, block, cn, pos, col_at, ci, stopped, rank_row, hh, fr=fr, tol=tol)
    return block, pos, col_at, ci, rank_row, hh


_P = ctypes.c_void_p
_PANEL_ARGS = [_P] * 7 + [ctypes.c_int] * 4
_SUFFIX = {torch.float32: ("f32", ctypes.c_float), torch.float64: ("f64", ctypes.c_double)}


def _check_cuda_args(floats, ints, dtype):
    if dtype not in _SUFFIX:
        raise TypeError(f"kernel takes float32 or float64, got {dtype}")
    dev = floats[0].device
    for t in floats + ints:
        if t.device != dev:
            raise ValueError("all kernel arguments must lie on one device")
        if not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous")
    for t in floats:
        if t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32, got {t.dtype}")


def panel_factorize(block, pos, col_at, col_index, rank_row, *, fr: int, tol: float):
    """Level-panel factorization of a batch.

    block (B, dim, n+1), pos/col_at/rank_row (B, n) int32, col_index (B,)
    int32.  Returns (block, pos, col_at, col_index, rank_row, hh (B, dim)).
    Launches the CUDA kernel for CUDA tensors, runs the plain version for
    CPU tensors, and raises otherwise.
    """
    if block.device.type == "cpu":
        return panel_factorize_ref(block, pos, col_at, col_index, rank_row, fr=fr, tol=tol)
    if block.device.type != "cuda":
        raise ValueError(f"panel_factorize: unsupported device {block.device}")
    B, dim, np1 = block.shape
    n = np1 - 1
    if pos.shape != (B, n) or col_at.shape != (B, n) or rank_row.shape != (B, n) \
            or col_index.shape != (B,):
        raise ValueError("panel_factorize: inconsistent shapes")
    _check_cuda_args([block], [pos, col_at, col_index, rank_row], block.dtype)
    suffix, c_real = _SUFFIX[block.dtype]
    block, pos, col_at = block.clone(), pos.clone(), col_at.clone()
    col_index, rank_row = col_index.clone(), rank_row.clone()
    hh = torch.empty(B, dim, dtype=block.dtype, device=block.device)
    scratch = torch.empty(B, n + dim, dtype=block.dtype, device=block.device)
    name = f"lexls_panel_factorize_{suffix}"
    fn = _build.bind(name, (*_PANEL_ARGS, c_real, _P))
    err = fn(block.data_ptr(), pos.data_ptr(), col_at.data_ptr(), col_index.data_ptr(),
             rank_row.data_ptr(), hh.data_ptr(), scratch.data_ptr(), B, dim, n, fr,
             tol, torch.cuda.current_stream(block.device).cuda_stream)
    _build.check(err, name)
    panel_factorize.launches += 1
    return block, pos, col_at, col_index, rank_row, hh


panel_factorize.launches = 0


# ---------------------------------------------------------------------------
# Batched factorization (panel kernel + torch inter-level steps)
# ---------------------------------------------------------------------------


def _gauss_level(lod, pos, col_at, first_col, col_index, rank, *, fr, dim, K):
    """Gauss elimination of the rows below one level, virtual layout
    (``pallas_lqr.py:267-299``), batched.  Returns the new lod."""
    B, m, np1 = lod.shape
    n = np1 - 1
    dev, dtype = lod.device, lod.dtype
    below_fr = fr + dim
    Mb = m - below_fr
    ar = torch.arange(K, device=dev)
    cols_k = col_at.gather(1, (first_col[:, None] + ar).clamp(max=n - 1).long()).long()
    Rpad = lod[:, fr:fr + K, :n].gather(2, cols_k[:, None, :].expand(B, K, K))
    i_idx, j_idx = ar[:, None], ar[None, :]
    r3 = rank[:, None, None]
    in_rank = (i_idx < r3) & (j_idx < r3) & (j_idx >= i_idx)
    eye = torch.eye(K, dtype=dtype, device=dev).expand(B, K, K)
    Rm = torch.where(in_rank, Rpad, eye)
    Bpad = lod[:, below_fr:, :n].gather(2, cols_k[:, None, :].expand(B, Mb, K))
    L = torch.linalg.solve_triangular(Rm, Bpad, upper=True, left=False)
    Lm = torch.where(ar[None, None, :] < r3, L, 0.0)
    Up = torch.where(ar[None, :, None] < r3, lod[:, fr:fr + K, :], 0.0)
    ones = torch.ones(B, 1, dtype=torch.bool, device=dev)
    posmask_p1 = torch.cat([pos >= col_index[:, None], ones], 1)
    Up = torch.where(posmask_p1[:, None, :], Up, 0.0)
    new_below = lod[:, below_fr:, :] - Lm @ Up
    rel = (pos - first_col[:, None]).clamp(0, K - 1).long()
    L_full = Lm.gather(2, rel[:, None, :].expand(B, Mb, n))
    L_full = torch.cat([L_full, torch.zeros(B, Mb, 1, dtype=dtype, device=dev)], 2)
    store = torch.cat([(pos >= first_col[:, None]) & (pos < col_index[:, None]), ~ones], 1)
    new_below = torch.where(store[:, None, :], L_full, new_below)
    return torch.cat([lod[:, :below_fr], new_below], 1)


def factorize_fast_batched(
    A: torch.Tensor,
    b: torch.Tensor,
    dims: Tuple[int, ...],
    params: ParametersLexLSE = ParametersLexLSE(),
    fixed_mask: Optional[torch.Tensor] = None,
    fixed_val: Optional[torch.Tensor] = None,
):
    """Batched l-QR (``pallas_lqr.py:302-387``): the level panels run
    through :func:`panel_factorize` (kernel B1), the inter-level Gauss
    elimination and the final physicalization as torch ops.

    ``A`` is (B, m, n), ``b`` (B, m).  ``fixed_mask`` (B, n) bool marks the
    variables held at ``fixed_val`` (simple bounds): their columns are
    zeroed and their values folded into the rhs (``lexlse.h:132-156``).
    Returns a batched :class:`lexls_tpu_torch.lexlse.LexQR`.
    Regularization is not ported.
    """
    from ..lexlse import LexQR
    from ..lexlsi import full_fp32

    if params.regularization_type != RegularizationType.NONE:
        raise LexLSError("factorize_fast_batched does not support regularization")
    full_fp32()
    B, m, n = A.shape
    dtype, dev = A.dtype, A.device
    if sum(dims) != m:
        raise LexLSError(f"dims {dims} do not sum to the row count {m}")

    if fixed_mask is None:
        fixed_mask = torch.zeros(B, n, dtype=torch.bool, device=dev)
        fixed_val = torch.zeros(B, n, dtype=dtype, device=dev)
    fixed_val = torch.where(fixed_mask, fixed_val, 0.0)
    rhs = b - (A @ fixed_val[:, :, None])[:, :, 0]
    lod = torch.cat([torch.where(fixed_mask[:, None, :], 0.0, A), rhs[:, :, None]], 2).contiguous()

    hh = torch.zeros(B, m, dtype=dtype, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n).contiguous()
    col_at = pos.clone()
    rank_row = torch.zeros(B, n, dtype=torch.int32, device=dev)
    col_index = torch.zeros(B, dtype=torch.int32, device=dev)
    tol = float(params.tol_linear_dependence)

    ranks, first_cols = [], []
    fr = 0
    for obj, dim in enumerate(dims):
        first_col = col_index
        first_cols.append(first_col)
        if dim == 0:
            ranks.append(torch.zeros(B, dtype=torch.int32, device=dev))
            continue
        block = lod[:, fr:fr + dim, :].contiguous()
        block, pos, col_at, col_index, rank_row, hh_lvl = panel_factorize(
            block, pos, col_at, col_index, rank_row, fr=fr, tol=tol)
        lod = torch.cat([lod[:, :fr], block, lod[:, fr + dim:]], 1)
        hh[:, fr:fr + dim] = hh_lvl
        rank = col_index - first_col
        ranks.append(rank)
        if obj < len(dims) - 1:
            lod = _gauss_level(lod, pos, col_at, first_col, col_index, rank,
                               fr=fr, dim=dim, K=min(dim, n))
        fr += dim

    # physicalize: position q holds column col_at[q]
    lod_phys = torch.cat(
        [lod[:, :, :n].gather(2, col_at.long()[:, None, :].expand(B, m, n)), lod[:, :, n:]], 2)
    return LexQR(
        lod=lod_phys, hh=hh, perm=col_at, rank_row=rank_row,
        ranks=torch.stack(ranks, 1), first_col=torch.stack(first_cols, 1),
        total_rank=col_index, fixed_mask=fixed_mask, fixed_val=fixed_val,
        dims=tuple(dims), n_var=n)
