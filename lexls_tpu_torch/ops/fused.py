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
from ..active_set import (
    _check_blocking,
    _commit,
    _empty_log,
    _form_step,
    _initial_cycling,
    _log_row_table,
    _masked_general,
    _select_removal,
    kmax,
)
from ..types import TerminationStatus
from . import _build
from .panel_lqr import (_SUFFIX, SharedLayout, _check_cuda_args, _int_array,
                        _panel_step, _step_bytes, odd_stride, pack_regions)


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


def _iteration(A, lb, ub, ct, st, x, v, Ax, *, dims, d0, tol_ld, tol_feas, **kw):
    """One active-set iteration for every instance (``fused.py:270-677``)
    up to its decision, which the caller commits for the alive instances
    (:func:`lexls_tpu_torch.active_set._commit`).  Rows below ``d0`` are
    the simple-bounds level; the LOD holds the general rows.  ``kw`` are
    the removal selection's options (``var_idx``, ``prio``, ``elig``, the
    sign tolerances, ``deact_first``)."""
    B, m, n = A.shape
    dev, dtype = A.device, A.dtype
    p = len(dims)

    # ---- masked LexLSE subproblem (formLexLSE, lexlsi.h:968-982): inactive
    # rows are zero; active bound rows fix their variables, whose columns
    # are zeroed and whose values are folded into the rhs
    Agm, rhsg, fixed_mask, fixed_val = _masked_general(A, lb, ub, ct, d0=d0, **kw)
    if d0:
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
    Adx, dv = _form_step(A, lb, ub, ct, Ax, v, dx)
    block = _check_blocking(ct, Ax, Adx, v, dv, lb, ub, tol_feas)

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
    removal = _select_removal(lam, ct, st, Agm, fixed_mask, d0=d0, **kw)
    return dict(dx=dx, dv=dv, Adx=Adx, block=block, removal=removal, total_rank=ci,
                R=[None if lvl is None else lvl[6] for lvl in levels],
                rank=[None if lvl is None else lvl[5] for lvl in levels], pos=pos)


def fused_active_set_ref(A, lb, ub, ctr_type, stamp, next_stamp, x, v, Ax, n_fact, it0=None,
                         log_state=None, cyc_state=None, *,
                         dims, prio, elig, tol_ld, tol_feas, tol_wrong, tol_correct,
                         max_fact, deact_first, d0=0, var_idx=(), iter_cap=0, log_cap=0,
                         cycling=False, cyc_max=50, cyc_relax=1e-8) -> ActiveSetResult:
    """Plain version of :func:`fused_active_set`: iterate until no
    instance is alive, freezing terminated and paused instances.  Its
    state is the result it returns."""
    B, m, n = A.shape
    dev, dtype = A.device, A.dtype
    i32 = dict(dtype=torch.int32, device=dev)
    p = len(dims)
    K = kmax(dims, n)
    fl = dict(dtype=dtype, device=dev)
    it0 = torch.zeros(B, **i32) if it0 is None else it0
    r = ActiveSetResult(
        x, v, torch.zeros(B, n, **fl), torch.zeros(B, m, **fl), Ax, torch.zeros(B, m, **fl),
        ctr_type, stamp, next_stamp, it0, torch.zeros(B, **i32), torch.zeros(B, **i32), n_fact,
        torch.full((B,), int(TerminationStatus.UNKNOWN), **i32),
        torch.zeros(B, p, K, K, **fl), torch.arange(n, **i32).expand(B, n),
        torch.zeros(B, p, **i32), lb, ub,
        *(_empty_log(B, log_cap, dtype, dev) if log_state is None else log_state),
        *(_initial_cycling(B, dev) if cyc_state is None else cyc_state))
    row_table = _log_row_table(((d0,) if d0 else ()) + tuple(dims), dev)
    kw = dict(dims=dims, d0=d0, var_idx=var_idx, prio=prio, elig=elig, tol_ld=tol_ld,
              tol_feas=tol_feas, tol_wrong=tol_wrong, tol_correct=tol_correct,
              deact_first=deact_first)
    while True:
        alive = (r.status == int(TerminationStatus.UNKNOWN)) & (
            (r.it == 0) | (r.n_fact < max_fact))
        if iter_cap:
            # pause (do not terminate) after iter_cap iterations of this call
            alive = alive & (r.it < it0 + iter_cap)
        if not bool(alive.any()):
            break
        step = _iteration(A, r.lb, r.ub, r.ctr_type, r.stamp, r.x, r.v, r.Ax, **kw)
        alpha, brow, btype, blocking = step["block"]
        found, rrow, rval = step["removal"]
        # the log and the detector see this iteration's change (fused.py:679-746)
        new, _, _ = _commit(r, alive, step["dx"], step["dv"], step["Adx"], alpha, brow, btype,
                            blocking, rrow, ~blocking & found, ~blocking & ~found,
                            log=(row_table, rval, step["total_rank"]) if log_cap else None,
                            cycling=(cyc_max, cyc_relax) if cycling else None)
        # the factorization of the latest alive iteration (fused.py:457-475)
        rpad = r.rpad.clone()
        for k, R in enumerate(step["R"]):
            if R is not None:
                Kk = R.shape[-1]
                rpad[:, k, :Kk, :Kk] = torch.where(alive[:, None, None], R, rpad[:, k, :Kk, :Kk])
        ranks = torch.where(alive[:, None], torch.stack(
            [torch.zeros(B, **i32) if rk is None else rk for rk in step["rank"]], 1), r.ranks)
        r = r._replace(**new, rpad=rpad, ranks=ranks,
                       posf=torch.where(alive[:, None], step["pos"], r.posf))
    return r._replace(posf=r.posf.contiguous())


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
                 "Adx", "red", "step", "pos", "col_at", "ct", "lvl_fc", "lvl_rank", "fmask")
# What ints["query"] asks of the entry instead of a launch
# (csrc/fused.cu::FusedQuery): resident blocks per SM, registers a thread,
# local-memory bytes a thread.
QUERY_BLOCKS_PER_SM, QUERY_REGS, QUERY_LOCAL_BYTES = 1, 2, 3


@functools.lru_cache(maxsize=256)
def fused_layout(m: int, n: int, p: int, d0: int, dmax: int, dtype,
                 lod_shared: Optional[bool] = None) -> SharedLayout:
    """Kernel B2's shared memory for one instance (``FUSED_REGIONS``): the
    masked subproblem (LOD) over the ``m - d0`` general rows at an odd row
    stride, the taus, column norms, reflection vector (``dmax``, the
    largest level), basic solution / step, multipliers of every objective
    over all rows, the λ back-propagation of objectives 1.., the fixed
    variables' values and flags (``d0 > 0`` only), x, v, Ax, dv, Adx, the
    reduction scratch and the step's scalars (sized by the dtype), then the
    permutation and its inverse, the working set (which also carries the
    removal selection's CORRECT_SIGN marks) and each level's first position
    and rank.  The bounds and the stamps, which an iteration reads once a
    row at most, stay in device memory: so four blocks of the bench shape
    (m=120, n=100, p=4, 30-row levels) fit an SM in float32.

    The rule, stated here and nowhere else: the LOD lives in shared memory
    exactly when all of this fits what a thread block may use
    (``SMEM_BLOCK_LIMIT``, 227 KB); otherwise it stays in device memory and
    the rest is in shared memory.  ``lod_shared`` forces either, for
    measurements."""
    es = torch.empty(0, dtype=dtype).element_size()
    mg, ld = m - d0, odd_stride(n)
    fixed = n if d0 else 0
    reals = (mg * ld, mg, n, dmax, n, p * m, (p - 1) * n, fixed, n, m, m, m, m)
    ints = (n, n, m, p, p, fixed)
    sizes = (*(k * es for k in reals), (_THREADS // 32) * (8 + es), _step_bytes(es),
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


def _query(lay: SharedLayout, dtype, query: int) -> int:
    """What the card reports of kernel B2's variant for this layout (LOD in
    shared or in device memory) at its shared-memory size (needs the card)."""
    name, fn = _fused_entry(dtype)
    got = fn(*_entry_args((), (), lay, dict(query=query), (), None))
    if got < 0:
        raise RuntimeError(f"{name}: CUDA error {-got} at {lay.nbytes} bytes of shared memory")
    return got


def fused_occupancy(lay: SharedLayout, dtype) -> int:
    """Resident blocks per SM that the card reports for kernel B2 at this
    layout's shared-memory size (needs the card)."""
    return _query(lay, dtype, QUERY_BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(lay: SharedLayout, dtype) -> int:
    """:func:`fused_occupancy`, asked of the card once per layout and dtype:
    the gauge ``b2.blocks_per_sm`` of a traced launch."""
    return fused_occupancy(lay, dtype)


@functools.lru_cache(maxsize=None)
def _registers(dtype, lod_shared: bool) -> tuple:
    """(registers, local-memory bytes) a thread of kernel B2's variant, as
    ``cudaFuncGetAttributes`` reports them, asked once per dtype and
    variant: the gauges ``b2.regs`` and ``b2.local_bytes``."""
    lay = fused_layout(1, 1, 1, 0, 1, dtype, lod_shared)
    return _query(lay, dtype, QUERY_REGS), _query(lay, dtype, QUERY_LOCAL_BYTES)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, asked once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def waves(batch: int, blocks_per_sm: int, sm_count: int) -> int:
    """How many rounds of resident blocks a launch of ``batch`` blocks
    takes on ``sm_count`` SMs that hold ``blocks_per_sm`` each: the gauge
    ``b2.waves`` of a traced launch."""
    return -(-batch // (blocks_per_sm * sm_count))


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
    refuses raises.  With tracing on, a launch sets the gauges
    ``b2.blocks_per_sm``, the resident blocks per SM that the card reports
    at its layout, ``b2.waves``, the rounds of resident blocks the batch
    takes (:func:`waves`), ``b2.smem_bytes``, the layout's shared memory a
    block, and ``b2.regs`` and ``b2.local_bytes``, the registers and the
    local-memory bytes a thread of the kernel's variant
    (:mod:`lexls_tpu_torch.tracing`).
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
    K = kmax(dims, n)
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
    rpad = torch.empty(B, p, K, K, dtype=dtype, device=dev)
    posf, ranks = empty(1, B, n)[0], empty(1, B, p)[0]
    work = None if lay.in_shared else torch.empty(B, mg * lay.ld, dtype=dtype, device=dev)
    outs = (x_o, v_o, Ax_o, dx_o, dv_o, Adx_o, ct_o, st_o, ns_o, it_o, na_o, nd_o, nf_o, status_o,
            rpad, posf, ranks, *(bounds_o or (None, None)),
            lobj_o, lctr_o, ltyp_o, lval_o, lrank_o, lcyc_o, llen_o, lovf_o, *cyc_o, work)
    ins = (A, lb, ub, ctr_type, stamp, next_stamp, x, v, Ax, n_fact, it0,
           *(log_in or (None,) * 8), *(cyc_in or (None,) * 4), lvl, prio, elig, vidx)
    name, fn = _fused_entry(dtype)
    if tracing.enabled():
        per_sm = _blocks_per_sm(lay, dtype)
        tracing.gauge("b2.blocks_per_sm", per_sm)
        tracing.gauge("b2.waves", waves(B, per_sm, _sm_count(dev)))
        tracing.gauge("b2.smem_bytes", lay.nbytes)
        regs, local_bytes = _registers(dtype, lay.in_shared)
        tracing.gauge("b2.regs", regs)
        tracing.gauge("b2.local_bytes", local_bytes)
    _build.launch(fn, name, lambda: _entry_args(
        [None if t is None else t.data_ptr() for t in ins],
        [None if t is None else t.data_ptr() for t in outs], lay,
        dict(B=B, m=m, n=n, p=p, d0=d0, kmax=K, max_fact=int(max_fact),
             deact_first=int(bool(deact_first)), iter_cap=int(iter_cap), log_cap=int(log_cap),
             cycling=int(bool(cycling)), cyc_max=int(cyc_max)),
        (tol_ld, tol_feas, tol_wrong, tol_correct, cyc_relax), _build.current_stream(dev)))
    lb_o, ub_o = bounds_o or (lb, ub)
    return ActiveSetResult(x_o, v_o, dx_o, dv_o, Ax_o, Adx_o, ct_o, st_o, ns_o, it_o, na_o, nd_o,
                           nf_o, status_o, rpad, posf, ranks, lb_o, ub_o, lobj_o, lctr_o, ltyp_o,
                           lval_o, lrank_o, lcyc_o, llen_o, lovf_o, *cyc_o)
