"""Kernel B2: the entire active-set solve of each instance in one kernel.

``fused_active_set`` runs the primal active-set loop (reference
``LexLSI::solve``/``verifyWorkingSet``, ``lexlsi.h:205-246, 1144-1265``)
to termination for every instance of a batch.  It replaces the Pallas TPU
kernel ``lexls_tpu/ops/fused.py::fused_active_set`` (``pl.pallas_call``
at ``fused.py:966``): general levels with an optional simple-bounds level
(``d0 > 0``), the ``iter_cap``/``it0`` pause and resume, the export of
the last factorization (per-level R, positions, ranks) that the
carried-factorization tracker starts from, the working-set log
(``log_cap`` > 0) and cycling handling (``cycling``), whose states come
in and go out so that a paused call resumes them.  On a CUDA tensor it
launches ``csrc/fused.cu`` (one thread block per instance, which loops
until its own instance terminates or pauses, with the instance's state in
shared memory as :func:`fused_layout` places it; the kernel reads the
caller's tensors and writes new ones, so the wrapper copies nothing); on
a CPU tensor it runs
``fused_active_set_ref``, a batched torch transliteration of the kernel's
stages with per-instance freezing, written for clarity.

Each iteration: build the masked subproblem (formLexLSE), factorize level
by level (panel pivot loop + Gauss elimination of the lower rows), solve
by backward substitution, form the step, run the ratio test, and when no
constraint blocks, compute every objective's multipliers by Householder
replay and pick the constraint to remove.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .. import tracing
from ..lexlsi import (
    _check_blocking,
    _cycling_step,
    _empty_log,
    _fixed_variables,
    _initial_cycling,
    _is_active,
    _log_append,
    _log_row_table,
    _rhs_of_type,
)
from ..types import CtrType, TerminationStatus
from . import _build
from .panel_lqr import (INT_MAX, _STEP_BYTES, _SUFFIX, SharedLayout, _check_cuda_args,
                        _int_array, _panel_step, odd_stride, pack_regions)


class ActiveSetResult(NamedTuple):
    """Final state per instance; ints are int32 of shape (B,) or (B, m).
    ``status`` is still UNKNOWN where the factorization budget ran out or
    the call paused at ``iter_cap``.  ``rpad`` (B, p, Kmax, Kmax), ``posf``
    (B, n) and ``ranks`` (B, p) describe the factorization of the
    instance's last iteration in this call: per level, R in pivot order
    (meaningful on ``[:rank, :rank]``), the column positions, the ranks;
    zeros / ``arange(n)`` / zeros where the call ran no iteration.
    ``lb``/``ub`` are the bounds as cycling handling relaxed them (the
    inputs themselves when it is off); the log is ``log_*`` with (B,
    log_cap) entries, ``log_len`` and ``log_overflow`` (flags as int32),
    the cycling detector ``cyc_*`` (B,)."""

    x: torch.Tensor
    v: torch.Tensor
    dx: torch.Tensor
    dv: torch.Tensor
    Ax: torch.Tensor
    Adx: torch.Tensor
    ctr_type: torch.Tensor
    stamp: torch.Tensor
    next_stamp: torch.Tensor
    it: torch.Tensor
    n_act: torch.Tensor
    n_deact: torch.Tensor
    n_fact: torch.Tensor
    status: torch.Tensor
    rpad: torch.Tensor
    posf: torch.Tensor
    ranks: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    log_obj: torch.Tensor
    log_ctr: torch.Tensor
    log_type: torch.Tensor
    log_value: torch.Tensor
    log_rank: torch.Tensor
    log_cycling: torch.Tensor
    log_len: torch.Tensor
    log_overflow: torch.Tensor
    cyc_counter: torch.Tensor
    cyc_prev_op: torch.Tensor
    cyc_prev_row: torch.Tensor
    cyc_prev_type: torch.Tensor


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _kmax(dims, n):
    """Side of the exported per-level R blocks (``tracker.kmax_of``)."""
    return max(1, max((min(d, n) for d in dims), default=1))


def _level_columns(pos, fc, K):
    """(B, K) physical column at position fc + j (clamped past n-1; only
    j < rank is ever read)."""
    B, n = pos.shape
    inv = torch.empty_like(pos, dtype=torch.long).scatter_(
        1, pos.long(), torch.arange(n, device=pos.device).expand(B, n).contiguous())
    idx = (fc[:, None] + torch.arange(K, device=pos.device)).clamp(max=n - 1).long()
    return inv.gather(1, idx)


def _gauss_columns(Bpad, R, rank, K):
    """L with L R = B by a forward column sweep (``fused.py:96-115``);
    columns at or beyond the rank are zero."""
    W = Bpad.clone()
    for j in range(K):
        live = (j < rank)[:, None]
        rjj = R[:, j, j]
        rjj_safe = torch.where(rjj.abs() > 0, rjj, torch.ones_like(rjj))
        lj = torch.where(live, W[:, :, j] / rjj_safe[:, None], 0.0)
        W[:, :, j + 1:] -= lj[:, :, None] * R[:, j, None, j + 1:]
        W[:, :, j] = lj
    return W


def _backsub(R, seg, rank, K):
    """y with triu(R) y = seg within one level (``fused.py:118-134``);
    entries at or beyond the rank are zero."""
    acc = seg.clone()
    y = torch.zeros_like(seg)
    for j in range(K - 1, -1, -1):
        rjj = R[:, j, j]
        rjj_safe = torch.where(rjj.abs() > 0, rjj, torch.ones_like(rjj))
        yj = torch.where(j < rank, acc[:, j] / rjj_safe, 0.0)
        acc[:, :j] -= yj[:, None] * R[:, :j, j]
        y[:, j] = yj
    return y


def _iteration(A, lb, ub, ct, st, ns, x, v, Ax, *, dims, d0, var_idx, prio, elig, tol_ld,
               tol_feas, tol_wrong, tol_correct, deact_first):
    """One active-set iteration for every instance (``fused.py:270-677``);
    the caller keeps the results of alive instances only.  Rows below
    ``d0`` are the simple-bounds level; the LOD holds the general rows."""
    B, m, n = A.shape
    dev, dtype = A.device, A.dtype
    p = len(dims)
    iota_m = torch.arange(m, device=dev)
    active = _is_active(ct)
    rhs_row = _rhs_of_type(lb, ub, ct)

    # ---- masked LexLSE subproblem (formLexLSE, lexlsi.h:968-982): inactive
    # rows are zero; active bound rows fix their variables, whose columns
    # are zeroed and whose values are folded into the rhs
    actf = active.to(dtype)
    Agm = A[:, d0:] * actf[:, d0:, None]
    rhsg = rhs_row[:, d0:] * actf[:, d0:]
    if d0:
        fixed_mask, fixed_val = _fixed_variables(active, rhs_row, d0, var_idx, n)
        rhsg = rhsg - (Agm * fixed_val[:, None, :]).sum(2)
        lod = torch.cat([torch.where(fixed_mask[:, None, :], 0.0, Agm), rhsg[:, :, None]], 2)
    else:
        lod = torch.cat([Agm, rhsg[:, :, None]], 2)

    # ---- factorize: per-level panel pivot loop + Gauss elimination
    pos = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n).contiguous()
    ci = torch.zeros(B, dtype=torch.int32, device=dev)
    levels = []
    fr = 0
    for k, dim in enumerate(dims):
        K = min(dim, n)
        fc = ci
        if dim == 0:
            levels.append(None)
            continue
        blk = lod[:, fr:fr + dim]
        cn = (blk[:, :, :n] * blk[:, :, :n]).sum(1)
        stopped = torch.zeros(B, dtype=torch.bool, device=dev)
        hh = torch.zeros(B, dim, dtype=dtype, device=dev)
        V = torch.zeros(B, K, dim, dtype=dtype, device=dev)
        for counter in range(dim):
            blk, cn, pos, _, ci, stopped, _, hh, u_live = _panel_step(
                counter, blk, cn, pos, None, ci, stopped, None, hh, fr=fr, tol=tol_ld, lean=True)
            if counter < K:
                V[:, counter] = u_live
        lod = torch.cat([lod[:, :fr], blk, lod[:, fr + dim:]], 1)
        end = ci
        rank = end - fc
        colat = _level_columns(pos, fc, K)
        R = lod[:, fr:fr + K, :n].gather(2, colat[:, None, :].expand(B, K, K))
        levels.append((fr, dim, K, fc, end, rank, R, V, hh, colat))

        if k < p - 1:
            below = lod[:, fr + dim:]
            Mk = below.shape[1]
            Bpad = below[:, :, :n].gather(2, colat[:, None, :].expand(B, Mk, K))
            L = _gauss_columns(Bpad, R, rank, K)
            Up = torch.where(torch.arange(K, device=dev)[None, :, None] < rank[:, None, None],
                             lod[:, fr:fr + K], 0.0)
            trail = torch.cat([pos >= end[:, None],
                               torch.ones(B, 1, dtype=torch.bool, device=dev)], 1)
            Up = torch.where(trail[:, None, :], Up, 0.0)
            new_below = below - L @ Up
            store = (pos >= fc[:, None]) & (pos < end[:, None])
            rel = (pos - fc[:, None]).clamp(0, K - 1).long()
            Lscat = L.gather(2, rel[:, None, :].expand(B, Mk, n))
            new_below = torch.cat(
                [torch.where(store[:, None, :], Lscat, new_below[:, :, :n]), new_below[:, :, n:]], 2)
            lod = torch.cat([lod[:, :fr + dim], new_below], 1)
        fr += dim

    # ---- basic solve: per-level backward substitution (free vars = 0)
    x_var = torch.zeros(B, n, dtype=dtype, device=dev)
    for lvl in reversed(levels):
        if lvl is None:
            continue
        fr, dim, K, fc, end, rank, R, V, hh, colat = lvl
        xt = torch.where(pos >= end[:, None], x_var, 0.0)
        rows_lvl = lod[:, fr:fr + K]
        contrib = (rows_lvl[:, :, :n] * xt[:, None, :]).sum(2)
        seg = torch.where(torch.arange(K, device=dev) < rank[:, None],
                          rows_lvl[:, :, n] - contrib, 0.0)
        y = _backsub(R, seg, rank, K)
        rel = pos - fc[:, None]
        in_lvl = (rel >= 0) & (rel < K)
        x_var = x_var + torch.where(in_lvl, y.gather(1, rel.clamp(0, K - 1).long()), 0.0)
    if d0:
        x_var = torch.where(fixed_mask, fixed_val, x_var)

    # ---- step and ratio test
    dx = x_var - x
    Adx = (A @ dx[:, :, None])[:, :, 0]
    dv = -v + torch.where(active, Ax + Adx - rhs_row, 0.0)
    alpha, brow, btype, blocking = _check_blocking(ct, Ax, Adx, v, dv, lb, ub, tol_feas)

    # ---- λ sweep by Householder replay (fused.py:537-579), over the
    # general rows
    lam = torch.zeros(B, p, m - d0, dtype=dtype, device=dev)
    rhs_all = torch.zeros(B, p, n, dtype=dtype, device=dev)
    jvec = torch.arange(p, device=dev)[None, :, None]
    for k in range(p - 1, -1, -1):
        if levels[k] is None:
            continue
        fr, dim, K, fc, end, rank, R, V, hh, colat = levels[k]
        rows_d = torch.arange(dim, device=dev)
        seg_top = torch.where(rows_d >= rank[:, None], -lod[:, fr:fr + dim, n], 0.0)
        segs = torch.zeros(B, p, dim, dtype=dtype, device=dev)
        segs[:, :, :K] = rhs_all.gather(2, colat[:, None, :].expand(B, p, K))
        segs = torch.where(rows_d[None, None, :] < rank[:, None, None], segs, 0.0)
        S = torch.where(jvec == k, seg_top[:, None, :], segs)
        for j in range(K - 1, -1, -1):
            vj = V[:, j]
            coef = (S * vj[:, None, :]).sum(2)
            S = S - hh[:, j, None, None] * coef[:, :, None] * vj[:, None, :]
        valid = jvec >= k
        S = torch.where(valid, S, 0.0)
        lam[:, :, fr:fr + dim] = S
        contrib = S @ lod[:, fr:fr + dim, :n]
        below_fc = (pos < fc[:, None])[:, None, :]
        rhs_all = torch.where(valid & below_fc, rhs_all - contrib, rhs_all)

    # ---- removal selection (lexlsi.h:1048-1139 + CORRECT_SIGN exemption)
    LB, UB = int(CtrType.ACTIVE_LB), int(CtrType.ACTIVE_UB)
    sense = ct
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    sel_row = torch.full((B,), -1, dtype=torch.int64, device=dev)
    sel_val = torch.zeros(B, dtype=dtype, device=dev)
    for j in range(p):
        vals = lam[:, j]
        if d0:
            # λ of the fixed variables, -A_g^T λ_j over the masked general
            # rows (lexlse.h:591-601), placed on their bound rows
            lam_fixed = torch.where(fixed_mask, -(Agm * vals[:, :, None]).sum(1), 0.0)
            vals = torch.cat([lam_fixed[:, list(var_idx)], vals], 1)
        a = torch.where(ct == LB, -vals, vals)
        consider = (elig[j] != 0) & ((sense == LB) | (sense == UB))
        mark = consider & (a > tol_correct)
        wrong = consider & (a < -tol_wrong)
        sense = torch.where(mark & ~found[:, None], int(CtrType.CORRECT_SIGN_OF_LAMBDA), sense)
        found_j = wrong.any(1)
        if deact_first:
            kmin = torch.where(wrong, st, INT_MAX).amin(1)
            first = wrong & (st == kmin[:, None])
            val_j = torch.zeros_like(sel_val)
        else:
            amin = torch.where(wrong, a, torch.inf).amin(1)
            tie = wrong & (a == amin[:, None])
            pmin = torch.where(tie, prio[j], INT_MAX).amin(1)
            first = tie & (prio[j] == pmin[:, None])
            val_j = amin
        row_j = torch.where(first, iota_m, INT_MAX).amin(1)
        sel_row = torch.where(found_j & ~found, row_j, sel_row)
        sel_val = torch.where(found_j & ~found, val_j, sel_val)
        found = found | found_j
    want_sweep = ~blocking
    do_remove = want_sweep & found
    solved = want_sweep & ~found

    # ---- working-set update and step
    at_b = blocking[:, None] & (iota_m == brow[:, None])
    at_r = do_remove[:, None] & (iota_m == sel_row[:, None])
    new_ct = torch.where(at_b, btype[:, None], torch.where(at_r, int(CtrType.INACTIVE), ct))
    new_st = torch.where(at_b, ns[:, None], torch.where(at_r, -1, st))
    afl = torch.where(alpha > 0.0, alpha, 0.0)[:, None]
    return dict(x=x + afl * dx, v=v + afl * dv, Ax=Ax + afl * Adx, dx=dx, dv=dv, Adx=Adx,
                ct=new_ct.to(torch.int32), st=new_st.to(torch.int32),
                blocking=blocking, do_remove=do_remove, solved=solved,
                alpha=alpha, brow=brow, btype=btype, sel_row=sel_row, sel_val=sel_val,
                rm_type=ct.gather(1, sel_row.clamp(min=0)[:, None])[:, 0], total_rank=ci,
                R=[None if lvl is None else lvl[6] for lvl in levels],
                rank=[None if lvl is None else lvl[5] for lvl in levels], pos=pos)


def fused_active_set_ref(A, lb, ub, ctr_type, stamp, next_stamp, x, v, Ax, n_fact, it0=None,
                         log_state=None, cyc_state=None, *,
                         dims, prio, elig, tol_ld, tol_feas, tol_wrong, tol_correct,
                         max_fact, deact_first, d0=0, var_idx=(), iter_cap=0, log_cap=0,
                         cycling=False, cyc_max=50, cyc_relax=1e-8) -> ActiveSetResult:
    """Plain version of :func:`fused_active_set`: iterate until no
    instance is alive, freezing terminated and paused instances."""
    B, m, n = A.shape
    dev, dtype = A.device, A.dtype
    i32 = dict(dtype=torch.int32, device=dev)
    p = len(dims)
    kmax = _kmax(dims, n)
    ct, st, ns, nf = ctr_type, stamp, next_stamp, n_fact
    dx = torch.zeros(B, n, dtype=dtype, device=dev)
    dv = torch.zeros(B, m, dtype=dtype, device=dev)
    Adx = torch.zeros(B, m, dtype=dtype, device=dev)
    na, nd = torch.zeros(B, **i32), torch.zeros(B, **i32)
    it0 = torch.zeros(B, **i32) if it0 is None else it0
    it = it0
    status = torch.full((B,), int(TerminationStatus.UNKNOWN), **i32)
    rpad = torch.zeros(B, p, kmax, kmax, dtype=dtype, device=dev)
    posf = torch.arange(n, **i32).expand(B, n)
    ranks = torch.zeros(B, p, **i32)
    log = _empty_log(B, log_cap, dtype, dev) if log_state is None else tuple(log_state)
    cyc = _initial_cycling(B, dev) if cyc_state is None else tuple(cyc_state)
    row_table = _log_row_table(((d0,) if d0 else ()) + tuple(dims), dev)
    kw = dict(dims=dims, d0=d0, var_idx=var_idx, prio=prio, elig=elig, tol_ld=tol_ld,
              tol_feas=tol_feas, tol_wrong=tol_wrong, tol_correct=tol_correct,
              deact_first=deact_first)
    while True:
        alive = (status == int(TerminationStatus.UNKNOWN)) & ((it == 0) | (nf < max_fact))
        if iter_cap:
            # pause (do not terminate) after iter_cap iterations of this call
            alive = alive & (it < it0 + iter_cap)
        if not bool(alive.any()):
            break
        r = _iteration(A, lb, ub, ct, st, ns, x, v, Ax, **kw)
        a1 = alive[:, None]
        x, v, Ax = (torch.where(a1, r["x"], x), torch.where(a1, r["v"], v),
                    torch.where(a1, r["Ax"], Ax))
        dx, dv, Adx = (torch.where(a1, r["dx"], dx), torch.where(a1, r["dv"], dv),
                       torch.where(a1, r["Adx"], Adx))
        ct, st = torch.where(a1, r["ct"], ct), torch.where(a1, r["st"], st)
        # the factorization of the latest alive iteration (fused.py:457-475)
        rpad = rpad.clone()
        for k, R in enumerate(r["R"]):
            if R is not None:
                K = R.shape[-1]
                rpad[:, k, :K, :K] = torch.where(alive[:, None, None], R, rpad[:, k, :K, :K])
        ranks = torch.where(a1, torch.stack(
            [torch.zeros(B, **i32) if rk is None else rk for rk in r["rank"]], 1), ranks)
        posf = torch.where(a1, r["pos"], posf)
        ai = alive.to(torch.int32)
        status = torch.where(alive & r["solved"], int(TerminationStatus.PROBLEM_SOLVED), status)
        # the log and the detector see this iteration's change (fused.py:679-746)
        change = (alive, r["blocking"], r["do_remove"], r["brow"], r["sel_row"], r["btype"])
        if log_cap:
            log = _log_append(log, *change, r["alpha"], r["sel_val"], r["total_rank"], row_table)
        if cycling:
            cyc, lb, ub, status, log_cycling = _cycling_step(
                cyc, lb, ub, status, log[5], log[6], *change, r["rm_type"], cyc_max, cyc_relax)
            log = log[:5] + (log_cycling,) + log[6:]
        ns = ns + ai * r["blocking"].to(torch.int32)
        na = na + ai * r["blocking"].to(torch.int32)
        nd = nd + ai * r["do_remove"].to(torch.int32)
        nf = nf + ai * (it > 0).to(torch.int32)
        it = it + ai
    return ActiveSetResult(x, v, dx, dv, Ax, Adx, ct, st, ns, it, na, nd, nf,
                           status.to(torch.int32), rpad, posf.contiguous(), ranks, lb, ub,
                           *log, *cyc)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_THREADS = 128  # csrc/fused.cu::kFusedThreads

# The entry's argument arrays, in the order of csrc/fused.cu's enums
# FusedInput, FusedOutput, FusedInt, FusedReal and FusedRegion.
FUSED_INPUTS = ("A", "lb", "ub", "ct", "st", "ns", "x", "v", "Ax", "nf", "it0",
                "lobj", "lctr", "ltyp", "lval", "lrank", "lcyc", "llen", "lovf",
                "ccnt", "cop", "crow", "ctyp", "lvl", "prio", "elig", "vidx")
FUSED_OUTPUTS = ("x", "v", "Ax", "dx", "dv", "Adx", "ct", "st", "ns", "it", "na", "nd", "nf",
                 "status", "rpad", "posf", "ranks", "lb", "ub",
                 "lobj", "lctr", "ltyp", "lval", "lrank", "lcyc", "llen", "lovf",
                 "ccnt", "cop", "crow", "ctyp", "work")
FUSED_INTS = ("B", "m", "n", "p", "d0", "kmax", "ld", "lod_shared", "smem_bytes", "max_fact",
              "deact_first", "iter_cap", "log_cap", "cycling", "cyc_max", "query")
FUSED_REALS = ("tol_ld", "tol_feas", "tol_wrong", "tol_correct", "cyc_relax")
FUSED_REGIONS = ("lod", "hh", "cn", "u", "xdx", "lam", "rhs_all", "fval", "x", "v", "Ax", "dv",
                 "Adx", "lb", "ub", "red", "step", "pos", "col_at", "sense", "ct", "st",
                 "lvl_fc", "lvl_rank", "fmask")


@functools.lru_cache(maxsize=256)
def fused_layout(m: int, n: int, p: int, d0: int, dmax: int, dtype,
                 lod_shared: Optional[bool] = None) -> SharedLayout:
    """Kernel B2's shared memory for one instance (``FUSED_REGIONS``): the
    masked subproblem (LOD) over the ``m - d0`` general rows at an odd row
    stride, the taus, column norms, reflection vector (``dmax``, the
    largest level), basic solution / step, multipliers of every objective
    over all rows, the λ back-propagation of objectives 1.., the fixed
    variables' values and flags (``d0 > 0`` only), x, v, Ax, dv, Adx, the
    bounds, the reduction scratch and the step's scalars, then the
    permutation and its inverse, the marked types, the working set, the
    stamps and each level's first position and rank.

    The rule, stated here and nowhere else: the LOD lives in shared memory
    exactly when all of this fits what a thread block may use
    (``SMEM_BLOCK_LIMIT``, 227 KB); otherwise it stays in device memory and
    the rest is in shared memory.  ``lod_shared`` forces either, for
    measurements."""
    es = torch.empty(0, dtype=dtype).element_size()
    mg, ld = m - d0, odd_stride(n)
    fixed = n if d0 else 0
    reals = (mg * ld, mg, n, dmax, n, p * m, (p - 1) * n, fixed, n, m, m, m, m, m, m)
    ints = (n, n, m, m, m, p, p, fixed)
    sizes = (*(k * es for k in reals), (_THREADS // 32) * (8 + es), _STEP_BYTES,
             *(k * 4 for k in ints))
    shared, offsets, sizes, nbytes, all_shared = pack_regions(sizes, 0, lod_shared)
    return SharedLayout(shared, ld, offsets, sizes, nbytes, all_shared)


@functools.lru_cache(maxsize=None)
def _fused_entry(dtype):
    name = f"lexls_fused_active_set_{_SUFFIX[dtype][0]}"
    return name, _build.bind(name, (_P,) * 6)


def _entry_args(ins, outs, lay: SharedLayout, ints: dict, reals, stream):
    """The C entry's six arguments: ``ins`` / ``outs`` are pointers (or None)
    in the order of ``FUSED_INPUTS`` / ``FUSED_OUTPUTS``, ``reals`` numbers
    in the order of ``FUSED_REALS``, ``ints`` by name (the layout's are
    added here)."""
    ints = dict(ints, ld=lay.ld, lod_shared=int(lay.in_shared), smem_bytes=lay.nbytes)
    return (_IN_ARRAY(*ins), _OUT_ARRAY(*outs), _int_array(lay.offsets),
            _int_array(tuple(ints.get(k, 0) for k in FUSED_INTS)), _REAL_ARRAY(*reals), stream)


_IN_ARRAY = _P * len(FUSED_INPUTS)
_OUT_ARRAY = _P * len(FUSED_OUTPUTS)
_REAL_ARRAY = ctypes.c_double * len(FUSED_REALS)


def fused_occupancy(lay: SharedLayout, dtype) -> int:
    """Resident blocks per SM that the card reports for kernel B2 at this
    layout's shared-memory size (needs the card)."""
    name, fn = _fused_entry(dtype)
    got = fn(*_entry_args((), (), lay, dict(query=1), (), None))
    if got < 0:
        raise RuntimeError(f"{name}: CUDA error {-got} at {lay.nbytes} bytes of shared memory")
    return got


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(lay: SharedLayout, dtype) -> int:
    """:func:`fused_occupancy`, asked of the card once per layout and dtype:
    the gauge ``b2.blocks_per_sm`` of a traced launch."""
    return fused_occupancy(lay, dtype)


@functools.lru_cache(maxsize=64)
def _level_table(dims: tuple, device: torch.device) -> torch.Tensor:
    """(2, p) int32 on ``device``: level sizes and first rows, made once
    per (dims, device) rather than copied to the device at every call."""
    offs = [0]
    for d in dims[:-1]:
        offs.append(offs[-1] + d)
    return torch.tensor([list(dims), offs], dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=64)
def _var_index(var_idx: tuple, n: int, device: torch.device) -> torch.Tensor:
    """(max(d0, 1),) int32 on ``device``: the variable of each bound row."""
    if any(not 0 <= c < n for c in var_idx):
        raise ValueError("fused_active_set: var_idx out of range")
    return torch.tensor(list(var_idx) or [0], dtype=torch.int32, device=device)


def fused_active_set(A, lb, ub, ctr_type, stamp, next_stamp, x, v, Ax, n_fact, it0=None,
                     log_state=None, cyc_state=None, *,
                     dims, prio, elig, tol_ld, tol_feas, tol_wrong, tol_correct,
                     max_fact, deact_first, d0=0, var_idx=(), iter_cap=0, log_cap=0,
                     cycling=False, cyc_max=50, cyc_relax=1e-8,
                     lod_shared: Optional[bool] = None) -> ActiveSetResult:
    """Run the active-set loop of a batch to termination, or to a pause.

    A (B, m, n); lb, ub, v, Ax (B, m); x (B, n); ctr_type, stamp (B, m)
    int32; next_stamp, n_fact (B,) int32; ``dims`` the general level
    sizes; the first ``d0`` rows of A are a simple-bounds level whose
    active rows fix the variables ``var_idx``; ``prio``/``elig`` (p, m)
    int32 λ-sweep visit priorities and eligibility.  ``it0`` (B,) int32 is
    the iteration counter to resume from (zeros when omitted) and
    ``iter_cap`` > 0 pauses an instance, status UNKNOWN, after that many
    iterations of this call.  An instance that is not alive on entry
    (``it0 > 0`` and ``n_fact >= max_fact``) runs nothing and keeps its
    inputs.

    ``log_cap`` > 0 turns the working-set log on at that capacity and
    ``cycling`` the cycling handling (``cyc_max``, ``cyc_relax``:
    ``cycling_max_counter`` and ``cycling_relax_step``).  ``log_state`` =
    (obj, ctr, type, value, rank, cycling (B, log_cap); len, overflow
    (B,)), flags int32, and ``cyc_state`` = (counter, previous operation,
    row, type), each (B,) int32, are the log and the detector to resume
    from (empty and initial when omitted); both come back in the result
    with the relaxed bounds.

    Launches the CUDA kernel for CUDA tensors, runs the plain version for
    CPU tensors, and raises otherwise.  The kernel reads its inputs and
    writes new output tensors: no input is written or copied by the
    wrapper, and the result's ``lb``/``ub`` are the inputs themselves
    unless cycling handling is on.  ``lod_shared`` forces the kernel's
    layout (:func:`fused_layout`) for measurements; a launch that the card
    refuses raises.  With tracing on, a launch sets the gauge
    ``b2.blocks_per_sm``, the resident blocks per SM that the card reports
    at its layout (:mod:`lexls_tpu_torch.tracing`).
    """
    kw = dict(dims=dims, prio=prio, elig=elig, tol_ld=tol_ld, tol_feas=tol_feas,
              tol_wrong=tol_wrong, tol_correct=tol_correct, max_fact=max_fact,
              deact_first=deact_first, d0=d0, var_idx=var_idx, iter_cap=iter_cap,
              log_cap=log_cap, cycling=cycling, cyc_max=cyc_max, cyc_relax=cyc_relax)
    if A.device.type == "cpu":
        return fused_active_set_ref(A, lb, ub, ctr_type, stamp, next_stamp, x, v, Ax,
                                    n_fact, it0, log_state, cyc_state, **kw)
    if A.device.type != "cuda":
        raise ValueError(f"fused_active_set: unsupported device {A.device}")
    B, m, n = A.shape
    p = len(dims)
    mg = m - d0
    dev, dtype = A.device, A.dtype
    if sum(dims) != mg or prio.shape != (p, m) or elig.shape != (p, m) or len(var_idx) != d0:
        raise ValueError("fused_active_set: dims/d0/var_idx/prio/elig do not match A")
    log_in = () if log_state is None else tuple(log_state)
    cyc_in = () if cyc_state is None else tuple(cyc_state)
    for t, shape in ((lb, (B, m)), (ub, (B, m)), (v, (B, m)), (Ax, (B, m)), (x, (B, n)),
                     (ctr_type, (B, m)), (stamp, (B, m)), (next_stamp, (B,)), (n_fact, (B,)),
                     *(() if it0 is None else ((it0, (B,)),)),
                     *((t, (B, log_cap)) for t in log_in[:6]),
                     *((t, (B,)) for t in log_in[6:] + cyc_in)):
        if t.shape != shape:
            raise ValueError(f"fused_active_set: expected shape {shape}, got {tuple(t.shape)}")
    vidx = _var_index(tuple(var_idx), n, dev)
    lvl = _level_table(tuple(dims), dev)
    _check_cuda_args([A, lb, ub, x, v, Ax, *log_in[3:4]],
                     [ctr_type, stamp, next_stamp, n_fact, prio, elig, vidx,
                      *(() if it0 is None else (it0,)), *log_in[:3], *log_in[4:], *cyc_in], dtype)
    kmax = _kmax(dims, n)
    dmax = max(1, max(dims, default=1))
    lay = fused_layout(m, n, p, d0, dmax, dtype, lod_shared)

    def empty(count, *shape, dtype=torch.int32):
        """``count`` output tensors of ``shape`` in one allocation (the host's
        time to issue a call is part of its cost, and an allocation costs
        less than taking a buffer apart does: so only for three and more)."""
        if count < 3:
            return [torch.empty(*shape, dtype=dtype, device=dev) for _ in range(count)]
        return torch.empty(count, *shape, dtype=dtype, device=dev).unbind(0)

    # outputs, in the order of FUSED_OUTPUTS; the bounds are an output only
    # where the detector may relax them, `work` only when the LOD is not in
    # shared memory, and without a log its five (B, 0) arrays are one tensor
    x_o, dx_o = empty(2, B, n, dtype=dtype)
    v_o, Ax_o, dv_o, Adx_o, *bounds_o = empty(6 if cycling else 4, B, m, dtype=dtype)
    ct_o, st_o = empty(2, B, m)
    ns_o, it_o, na_o, nd_o, nf_o, status_o, llen_o, lovf_o, *cyc_o = empty(12, B)
    lobj_o, lctr_o, ltyp_o, lrank_o, lcyc_o = (
        empty(5, B, log_cap) if log_cap else (torch.empty(B, 0, dtype=torch.int32, device=dev),) * 5)
    lval_o = torch.empty(B, log_cap, dtype=dtype, device=dev)
    rpad = torch.empty(B, p, kmax, kmax, dtype=dtype, device=dev)
    posf, ranks = empty(1, B, n)[0], empty(1, B, p)[0]
    work = None if lay.in_shared else torch.empty(B, mg * lay.ld, dtype=dtype, device=dev)
    outs = (x_o, v_o, Ax_o, dx_o, dv_o, Adx_o, ct_o, st_o, ns_o, it_o, na_o, nd_o, nf_o, status_o,
            rpad, posf, ranks, *(bounds_o or (None, None)),
            lobj_o, lctr_o, ltyp_o, lval_o, lrank_o, lcyc_o, llen_o, lovf_o, *cyc_o, work)
    ins = (A, lb, ub, ctr_type, stamp, next_stamp, x, v, Ax, n_fact, it0,
           *(log_in or (None,) * 8), *(cyc_in or (None,) * 4), lvl, prio, elig, vidx)
    name, fn = _fused_entry(dtype)
    if tracing.enabled():
        tracing.gauge("b2.blocks_per_sm", _blocks_per_sm(lay, dtype))
    _build.launch(fn, name, lambda: _entry_args(
        [None if t is None else t.data_ptr() for t in ins],
        [None if t is None else t.data_ptr() for t in outs], lay,
        dict(B=B, m=m, n=n, p=p, d0=d0, kmax=kmax, max_fact=int(max_fact),
             deact_first=int(bool(deact_first)), iter_cap=int(iter_cap), log_cap=int(log_cap),
             cycling=int(bool(cycling)), cyc_max=int(cyc_max)),
        (tol_ld, tol_feas, tol_wrong, tol_correct, cyc_relax), _build.current_stream(dev)))
    lb_o, ub_o = bounds_o or (lb, ub)
    return ActiveSetResult(x_o, v_o, dx_o, dv_o, Ax_o, Adx_o, ct_o, st_o, ns_o, it_o, na_o, nd_o,
                           nf_o, status_o, rpad, posf, ranks, lb_o, ub_o, lobj_o, lctr_o, ltyp_o,
                           lval_o, lrank_o, lcyc_o, llen_o, lovf_o, *cyc_o)
