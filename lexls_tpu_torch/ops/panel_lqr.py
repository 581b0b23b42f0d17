"""Kernel B1: the level-panel factorization, and the batched l-QR over it.

``panel_factorize`` runs the whole pivot loop of one level's
column-pivoted Householder factorization (reference ``lexlse.h:182-268``)
for every instance of a batch.  It replaces the Pallas TPU kernel
``lexls_tpu/ops/pallas_lqr.py::panel_factorize`` (``pl.pallas_call`` at
``pallas_lqr.py:238``).  On a CUDA tensor it launches the hand-written
kernel in ``csrc/panel_lqr.cu`` (one thread block per instance, the level
block in shared memory where :func:`panel_layout` says it fits); on a CPU
tensor it runs ``panel_factorize_ref``, the plain batched version of the
same steps.  ``_panel_step`` is the plain step that both plain versions
(this one and ``ops/fused.py``'s) share, as the CUDA kernels share
``csrc/panel_step.cuh``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import regularization as reg
from ..active_set import INT_MAX, full_fp32
from ..lexlse import LexQR, _apply_wy, _intermediate_x, _wy_raw
from ..types import LexLSError, ParametersLexLSE, RegularizationType
from . import _build


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
_I = ctypes.c_int
_SUFFIX = {torch.float32: ("f32", ctypes.c_float), torch.float64: ("f64", ctypes.c_double)}

# Shared memory of an H100 SM: what one thread block may use (227 KB), and
# what the SM has (228 KB), of which every resident block reserves 1 KB.
SMEM_BLOCK_LIMIT = 232448
SMEM_SM_BYTES = 233472
SMEM_BLOCK_RESERVED = 1024
MAX_BLOCKS_PER_SM = 16  # 2048 threads an SM over the kernels' 128 a block


class SharedLayout(NamedTuple):
    """Where a kernel keeps one instance's state.  ``in_shared``: the big
    array (B1's level block, B2's LOD) lives in shared memory at row stride
    ``ld``; otherwise it stays in device memory and only the small vectors
    are in shared memory.  ``offsets`` are the byte offsets of the regions
    (in the order of the kernel's enum) inside the ``nbytes`` of dynamic
    shared memory a block asks for; ``sizes`` their bytes;
    ``nbytes_all_shared`` is what the block would need with the big array
    in shared memory, the number the rule looks at."""

    in_shared: bool
    ld: int
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    nbytes: int
    nbytes_all_shared: int

    @property
    def blocks_per_sm(self) -> int:
        """Resident blocks an SM's shared memory allows."""
        return min(MAX_BLOCKS_PER_SM, SMEM_SM_BYTES // (self.nbytes + SMEM_BLOCK_RESERVED))


def odd_stride(n: int) -> int:
    """Row stride of an (rows, n + 1) array in shared memory: the smallest
    odd number that holds n + 1 entries, so that a gather down a column
    hits a different bank in every row."""
    return n + 1 if n % 2 == 0 else n + 2


def pack_regions(sizes, big: int, in_shared):
    """Lay regions of ``sizes`` bytes out one after another, each aligned
    to 8 bytes; region ``big`` is left out (size 0) when the whole does not
    fit a block's shared memory, or as ``in_shared`` forces.  Returns
    (in_shared, offsets, sizes, nbytes, nbytes_all_shared)."""
    def pack(szs):
        offsets, at = [], 0
        for sz in szs:
            offsets.append(at)
            at += -(-sz // 8) * 8
        return tuple(offsets), at

    _, all_shared = pack(sizes)
    if in_shared is None:
        in_shared = all_shared <= SMEM_BLOCK_LIMIT
    sizes = tuple(sz if in_shared or i != big else 0 for i, sz in enumerate(sizes))
    offsets, nbytes = pack(sizes)
    return bool(in_shared), offsets, sizes, nbytes, all_shared


def _step_bytes(es: int) -> int:
    """Bytes of ``csrc/panel_step.cuh::StepScratch<T>`` for a T of ``es``
    bytes: the candidates of even and of odd steps, one a warp of the
    kernels' four, each four reals and two ints."""
    return 2 * 4 * (4 * es + 2 * 4)

# csrc/panel_lqr.cu::PanelRegion, in order
PANEL_REGIONS = ("blk", "cn", "hh", "den", "pos", "col_at", "rank_row", "step")


@functools.lru_cache(maxsize=256)
def panel_layout(dim: int, n: int, dtype, blk_shared: Optional[bool] = None) -> SharedLayout:
    """Kernel B1's shared memory for a (dim, n + 1) level block: the block
    at an odd row stride, the column norms, the taus, the steps'
    denominators, the permutation and its inverse, the pivot rows, the
    step's scratch.  The block stays in device memory when all of it exceeds what
    a thread block may use (``blk_shared`` forces either)."""
    es = torch.empty(0, dtype=dtype).element_size()
    ld = odd_stride(n)
    sizes = (dim * ld * es, n * es, dim * es, dim * es, n * 4, n * 4, n * 4, _step_bytes(es))
    shared, offsets, sizes, nbytes, all_shared = pack_regions(sizes, 0, blk_shared)
    return SharedLayout(shared, ld, offsets, sizes, nbytes, all_shared)


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


@functools.lru_cache(maxsize=1024)
def _int_array(values: tuple):
    """A C int array of ``values`` (kept: a layout's offsets go to every
    launch)."""
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=None)
def _panel_entry(dtype):
    suffix, c_real = _SUFFIX[dtype]
    name = f"lexls_panel_factorize_{suffix}"
    return name, _build.bind(name, (_P,) * 12 + (_I,) * 8 + (c_real, _P))


def panel_occupancy(lay: SharedLayout, dtype) -> int:
    """Resident blocks per SM that the card reports for kernel B1 at this
    layout's shared-memory size (needs the card)."""
    name, fn = _panel_entry(dtype)
    got = fn(*(None,) * 11, _int_array(lay.offsets), 0, 0, 0, 0, int(lay.in_shared), lay.ld,
             lay.nbytes, 1, 0.0, None)
    if got < 0:
        raise RuntimeError(f"{name}: CUDA error {-got} at {lay.nbytes} bytes of shared memory")
    return got


def panel_factorize(block, pos, col_at, col_index, rank_row, *, fr: int, tol: float,
                    blk_shared: Optional[bool] = None):
    """Level-panel factorization of a batch.

    block (B, dim, n+1), pos/col_at/rank_row (B, n) int32, col_index (B,)
    int32.  Returns (block, pos, col_at, col_index, rank_row, hh (B, dim)),
    all new tensors: no input is written.  Launches the CUDA kernel for
    CUDA tensors, runs the plain version for CPU tensors, and raises
    otherwise.  ``blk_shared`` forces the kernel's layout
    (:func:`panel_layout`); a launch that the card refuses raises.
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
    lay = panel_layout(dim, n, block.dtype, blk_shared)
    ins = (block, pos, col_at, col_index, rank_row)
    # few allocations: the host's time to issue a call is part of its cost
    pos_o, col_at_o, rank_row_o = torch.empty(
        3, B, n, dtype=torch.int32, device=block.device).unbind(0)
    outs = (torch.empty_like(block), pos_o, col_at_o, torch.empty_like(col_index), rank_row_o)
    hh = torch.empty(B, dim, dtype=block.dtype, device=block.device)
    name, fn = _panel_entry(block.dtype)
    _build.launch(fn, name, lambda: (
        *(t.data_ptr() for t in ins + outs), hh.data_ptr(), _int_array(lay.offsets), B, dim, n,
        fr, int(lay.in_shared), lay.ld, lay.nbytes, 0, tol, _build.current_stream(block.device)))
    return (*outs, hh)


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
    reg_factors: Optional[torch.Tensor] = None,
):
    """Batched l-QR (``pallas_lqr.py:302-387``, and the regularized branch
    of ``lexlse.py:514-808``): the level panels run through
    :func:`panel_factorize` (kernel B1), the regularization of each level,
    the inter-level Gauss elimination and the final physicalization as
    torch ops.

    ``A`` is (B, m, n), ``b`` (B, m).  ``fixed_mask`` (B, n) bool marks the
    variables held at ``fixed_val`` (simple bounds): their columns are
    zeroed and their values folded into the rhs (``lexlse.h:132-156``).
    With a regularization type other than NONE, each level's rhs segment
    is damped between its B1 launch and its Gauss elimination, with the
    per-level factors ``reg_factors`` ((p,) shared or (B, p); zero where
    None), and the null-space basis is accumulated; TIKHONOV_1 also
    carries each objective's damped solution and residuals.  Returns a
    batched :class:`lexls_tpu_torch.lexlse.LexQR`.
    """
    full_fp32()
    B, m, n = A.shape
    dtype, dev = A.dtype, A.device
    p = len(dims)
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

    rt = params.regularization_type
    regularize = rt != RegularizationType.NONE
    track_mu = rt == RegularizationType.TIKHONOV_1
    null_space = torch.zeros(B, n, n + 1, dtype=dtype, device=dev)
    if regularize:
        reg_factors = (torch.zeros(B, p, dtype=dtype, device=dev) if reg_factors is None
                       else reg_factors.to(dev, dtype).expand(B, p))
    X_mu = torch.zeros((B, n, p) if track_mu else (B, 0, 0), dtype=dtype, device=dev)
    residual_mu = torch.zeros(B, m if track_mu else 0, dtype=dtype, device=dev)

    ranks, first_cols = [], []
    fr = 0
    for obj, dim in enumerate(dims):
        first_col = col_index
        first_cols.append(first_col)
        if dim == 0:
            ranks.append(torch.zeros(B, dtype=torch.int32, device=dev))
            continue
        K = min(dim, n)
        if track_mu:
            # the level's deflated rhs before its reflections (lexlse.h:188-191)
            residual_mu[:, fr:fr + dim] = lod[:, fr:fr + dim, n]
        block = lod[:, fr:fr + dim, :].contiguous()
        block, pos, col_at, col_index, rank_row, hh_lvl = panel_factorize(
            block, pos, col_at, col_index, rank_row, fr=fr, tol=tol)
        lod = torch.cat([lod[:, :fr], block, lod[:, fr + dim:]], 1)
        hh[:, fr:fr + dim] = hh_lvl
        rank = col_index - first_col
        ranks.append(rank)
        if regularize:
            # the level's rows and the accumulated null space, which is kept
            # in PHYSICAL columns (later pivoting reorders the remaining
            # positions), gathered into position space; only the rhs column,
            # which both layouts share, is written back
            factor = reg_factors[:, obj]
            level_rows = _gather_cols(lod[:, fr:fr + K], col_at)
            if params.variable_regularization_factor != 0.0:
                factor = reg.variable_factor(level_rows, params.variable_regularization_factor,
                                             first_col, rank, n, factor)
            ns_pos = _gather_cols(null_space, col_at)
            if track_mu:
                X_mu, residual_mu, rhs_reg = _track_mu(
                    lod, hh, level_rows, ns_pos, X_mu, residual_mu, dims, first_cols, ranks,
                    obj, fr, col_at, pos, factor)
                lv_reg = torch.cat([level_rows[:, :, :n], rhs_reg[:, :, None]], 2)
                ns_pos = reg._accumulate_nullspace(lv_reg, ns_pos, first_col, rank, col_index, n)
            else:
                rhs_reg, ns_pos = reg.apply_level_regularization(
                    params, level_rows, ns_pos, first_col, rank, col_index, factor, n)
            lod[:, fr:fr + K, n] = rhs_reg
            null_space = _gather_cols(ns_pos, pos)
        if obj < p - 1:
            lod = _gauss_level(lod, pos, col_at, first_col, col_index, rank,
                               fr=fr, dim=dim, K=K)
        fr += dim

    # physicalize: position q holds column col_at[q]
    lod_phys = _gather_cols(lod, col_at)
    if regularize:
        null_space = _gather_cols(null_space, col_at)
    return LexQR(
        lod=lod_phys, hh=hh, perm=col_at, rank_row=rank_row,
        ranks=_stack_levels(ranks, B, dev), first_col=_stack_levels(first_cols, B, dev),
        total_rank=col_index, fixed_mask=fixed_mask, fixed_val=fixed_val,
        null_space=null_space, X_mu=X_mu, residual_mu=residual_mu,
        reg_factors=reg_factors if track_mu else A.new_zeros(B, 0),
        dims=tuple(dims), n_var=n)


def _stack_levels(per_level, B: int, dev):
    """(B, p) int32 from p per-level (B,) tensors; (B, 0) without levels."""
    if not per_level:
        return torch.zeros(B, 0, dtype=torch.int32, device=dev)
    return torch.stack(per_level, 1)


def _gather_cols(M, idx):
    """(B, r, n+1) with the first n columns gathered through ``idx``
    (B, n), the rhs column kept: ``col_at`` takes physical columns to
    positions, ``pos`` takes them back."""
    B, r, np1 = M.shape
    return torch.cat([M[:, :, :np1 - 1].gather(2, idx.long()[:, None, :].expand(B, r, np1 - 1)),
                      M[:, :, np1 - 1:]], 2)


def _track_mu(lod, hh, level_rows, ns_pos, X_mu, residual_mu, dims, first_cols, ranks, obj,
              fr, col_at, pos, factor):
    """TIKHONOV_1's regularized-multiplier bookkeeping of one level
    (``lexlse.py:708-749``, reference ``regularize_tikhonov_1_test``,
    ``lexlse.h:1774-1886``): the damped rhs, the damped residual through
    the level's WY factors, and the objective's damped solution completed
    through the levels above.  Returns (X_mu, residual_mu, rhs (B, K))."""
    n = pos.shape[1]
    dim = dims[obj]
    K = min(dim, n)
    dev = lod.device
    first_col, rank = first_cols[obj], ranks[obj]
    do_reg = ((factor != 0.0) & (rank > 0))[:, None]
    new_rhs, y_mu = reg._tikhonov_full(level_rows, ns_pos, first_col, rank, factor, n,
                                       return_y=True)
    rhs_reg = torch.where(do_reg & (torch.arange(K, device=dev) < rank[:, None]), new_rhs,
                          level_rows[:, :, n])
    # damped residual: Q [rhs head; 0] less the deflated rhs (lexlse.h:1846-1855),
    # the pivot columns gathered through col_at
    wy_cols = col_at.gather(1, (first_col[:, None] + torch.arange(K, device=dev)).clamp(0, n - 1)
                            .long())
    seg_in = torch.cat([rhs_reg, lod[:, fr + K:fr + dim, n]], 1)
    seg_in = torch.where(torch.arange(dim, device=dev) < rank[:, None], seg_in, 0.0)
    rw = _apply_wy(*_wy_raw(lod, hh, fr, dim, wy_cols), seg_in)
    old = residual_mu[:, fr:fr + dim]
    residual_mu = torch.cat([residual_mu[:, :fr], torch.where(do_reg, rw - old, old),
                             residual_mu[:, fr + dim:]], 1)
    # the objective's damped solution, completed through the levels above
    # (get_intermediate_x, lexlse.h:2010), then positions -> variables
    X_pos = torch.where(torch.arange(n, device=dev) >= first_col[:, None], y_mu, 0.0)
    X_pos = _intermediate_x(_gather_cols(lod[:, :fr], col_at), dims, first_cols, ranks, obj,
                            first_col, X_pos, n)
    X_mu = X_mu.clone()
    X_mu[:, :, obj] = torch.where(do_reg, X_pos.gather(1, pos.long()), X_mu[:, :, obj])
    return X_mu, residual_mu, rhs_reg
