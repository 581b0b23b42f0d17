"""One active-set iteration's shared pieces: the layer below the kernels
and the solver tiers.

Kernel B2's plain version (:mod:`lexls_tpu_torch.ops.fused`), the exact
tier (:mod:`lexls_tpu_torch.lexlsi`) and the tracker
(:mod:`lexls_tpu_torch.tracker`) each factorize in their own way; what
they do with a factorization is here, once: the masked subproblem, the
step, the ratio test, the removal selection and :func:`_commit`, which
applies the decision.  So are phase 1's pieces that the hot-start
kernel's plain version shares.  The step's options have one form, kernel
B2's keyword arguments (:func:`active_set_kwargs`).  A state is any record
with the field names that ``LexLSIState``, ``ActiveSetResult`` and
:class:`Phase1Result` share; every tensor has a leading batch axis B.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import lexlse
from .types import CtrType, OperationType, ParametersLexLSI, TerminationStatus

INT_MAX = torch.iinfo(torch.int32).max

# the fields of a state that an iteration writes (:func:`_commit`), that the
# working-set log holds and that the cycling detector holds
STEP_FIELDS = ("x", "v", "dx", "dv", "Ax", "Adx", "ctr_type", "stamp", "next_stamp", "it",
               "n_act", "n_deact", "n_fact", "status")
LOG_FIELDS = ("log_obj", "log_ctr", "log_type", "log_value", "log_rank", "log_cycling",
              "log_len", "log_overflow")
CYCLING_FIELDS = ("cyc_counter", "cyc_prev_op", "cyc_prev_row", "cyc_prev_type")


def full_fp32() -> None:
    """Keep float32 matmuls in full precision: TF32 breaks the
    rank-revealing pivot decisions (the JAX package pins
    ``jax.default_matmul_precision("float32")`` for the same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kmax(dims, n) -> int:
    """Side of the per-level R blocks that kernel B2 exports and the
    tracker carries: the largest level's rank bound."""
    return max(1, max((min(d, n) for d in dims), default=1))


def _is_active(t):
    return (t == int(CtrType.ACTIVE_LB)) | (t == int(CtrType.ACTIVE_UB)) | (
        t == int(CtrType.ACTIVE_EQ))


def _rhs_of_type(lb, ub, t):
    """Active right-hand side: ub for EQ/UB, lb for LB; 0 for inactive
    (``objective.h:302-313``)."""
    is_ub = (t == int(CtrType.ACTIVE_UB)) | (t == int(CtrType.ACTIVE_EQ))
    is_lb = t == int(CtrType.ACTIVE_LB)
    return torch.where(is_ub, ub, torch.where(is_lb, lb, 0.0))


def _matvec(A, x):
    return (A @ x[:, :, None])[:, :, 0]


# ---------------------------------------------------------------------------
# The step's options
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _sweep_tables(struct, device: torch.device):
    """(prio, elig), each (p, m) int32 on ``device``: the λ-sweep visit
    priorities and eligibility per lexlse objective, made once per
    (structure, device) rather than copied to the device at every step."""
    p = len(struct.lexlse_dims)
    prio = np.stack([struct.sweep_priority(j) for j in range(p)])
    elig = np.stack([struct.sweep_eligible(j) for j in range(p)]).astype(np.int32)
    return torch.as_tensor(prio, device=device), torch.as_tensor(elig, device=device)


def active_set_kwargs(struct, params: ParametersLexLSI, device) -> dict:
    """Keyword arguments of kernel B2 (and of its plain version) for a
    structure and parameters: level sizes, tolerances, the λ-sweep tables
    of :func:`_sweep_tables`, and the log and cycling options.  The
    step's pieces below take the fields they read from it."""
    prio, elig = _sweep_tables(struct, torch.device(device))
    return dict(
        dims=struct.lexlse_dims, d0=struct.d0,
        var_idx=struct.var_idx if struct.simple_bounds else (), prio=prio, elig=elig,
        tol_ld=params.tol_linear_dependence, tol_feas=params.tol_feasibility,
        tol_wrong=params.tol_wrong_sign_lambda, tol_correct=params.tol_correct_sign_lambda,
        max_fact=params.max_number_of_factorizations,
        deact_first=params.deactivate_first_wrong_sign,
        log_cap=(params.max_number_of_factorizations + 2
                 if params.log_working_set_enabled else 0),
        cycling=params.cycling_handling_enabled, cyc_max=params.cycling_max_counter,
        cyc_relax=params.cycling_relax_step)


# ---------------------------------------------------------------------------
# The masked subproblem and the step
# ---------------------------------------------------------------------------


def _fixed_variables(active, rhs_row, d0, var_idx, n):
    """(fixed_mask (B, n) bool, fixed_val (B, n)): the variables that the
    active rows of the simple-bounds level fix, and their values
    (``lexlse.h:132-156``)."""
    B = active.shape[0]
    vidx = torch.as_tensor(var_idx, dtype=torch.long, device=active.device)
    act0 = active[:, :d0]
    fixed_mask = torch.zeros(B, n, dtype=torch.bool, device=active.device)
    fixed_mask[:, vidx] = act0
    fixed_val = torch.zeros(B, n, dtype=rhs_row.dtype, device=active.device)
    fixed_val[:, vidx] = torch.where(act0, rhs_row[:, :d0], 0.0)
    return fixed_mask, fixed_val


def _masked_general(A, lb, ub, ctr_type, *, d0, var_idx, **_):
    """(A_masked, b_masked, fixed_mask, fixed_val) of the LexLSE subproblem
    at the current working set (``formLexLSE``, ``lexlsi.py:226-246``).
    Active simple-bounds rows (the first ``d0``, bounding the variables
    ``var_idx``) become fixed variables; general rows are zero when
    inactive.  Takes the step's options (:func:`active_set_kwargs`)."""
    B, _, n = A.shape
    active = _is_active(ctr_type)
    rhs = _rhs_of_type(lb, ub, ctr_type)
    if d0:
        fixed_mask, fixed_val = _fixed_variables(active, rhs, d0, var_idx, n)
    else:
        fixed_mask = torch.zeros(B, n, dtype=torch.bool, device=A.device)
        fixed_val = torch.zeros(B, n, dtype=A.dtype, device=A.device)
    actg = active[:, d0:].to(A.dtype)
    return A[:, d0:] * actg[:, :, None], rhs[:, d0:] * actg, fixed_mask, fixed_val


def _form_step(A, lb, ub, ctr_type, Ax, v, dx):
    """``objective.h:288-338``: dv anchored to the rhs to kill drift;
    ``Ax`` is the solver's cached value."""
    Adx = _matvec(A, dx)
    rhs = _rhs_of_type(lb, ub, ctr_type)
    dv = -v + torch.where(_is_active(ctr_type), Ax + Adx - rhs, 0.0)
    return Adx, dv


# ---------------------------------------------------------------------------
# Phase 1's pieces
# ---------------------------------------------------------------------------


def _form_initial_working_set(ctr_type, stamp, next_stamp, Ax, lb, ub,
                              params: ParametersLexLSI):
    """Hot-start guess repair, Algorithm 1 (``objective.h:115-172``).
    Newly activated rows get fresh stamps in row order."""
    t = ctr_type
    inactive = t == int(CtrType.INACTIVE)
    is_lb = t == int(CtrType.ACTIVE_LB)
    is_ub = t == int(CtrType.ACTIVE_UB)
    LB, UB, IN = int(CtrType.ACTIVE_LB), int(CtrType.ACTIVE_UB), int(CtrType.INACTIVE)
    new_t = t
    if params.modify_type_inactive_enabled:
        new_t = torch.where(inactive & (Ax <= lb), LB, new_t)
        new_t = torch.where(inactive & (Ax > lb) & (Ax >= ub), UB, new_t)
    if params.modify_type_active_enabled:
        lb_off = is_lb & (Ax > lb)
        new_t = torch.where(lb_off, torch.where(Ax >= ub, UB, IN), new_t)
        ub_off = is_ub & (Ax < ub)
        new_t = torch.where(ub_off, torch.where(Ax <= lb, LB, IN), new_t)
    new_t = new_t.to(torch.int32)
    changed = new_t != t
    newly_active = changed & _is_active(new_t)
    deact = changed & (new_t == IN)
    order = newly_active.to(torch.int32).cumsum(1, dtype=torch.int32) - 1
    stamp = torch.where(newly_active, next_stamp[:, None] + order,
                        torch.where(deact, -1, stamp)).to(torch.int32)
    next_stamp = next_stamp + newly_active.sum(1, dtype=torch.int32)
    return new_t, stamp, next_stamp


def _modify_x_guess(x, ctr_type, lb, ub, struct):
    """ensureZeroCtrViolationForSimpleBounds (``objective.h:73-103``,
    ``lexlsi.py:437-445``): each bounded variable moves onto its active
    bound, or to the middle of its interval when the row is inactive."""
    d0 = struct.d0
    t0 = ctr_type[:, :d0]
    val = torch.where(t0 == int(CtrType.INACTIVE), 0.5 * (lb[:, :d0] + ub[:, :d0]),
                      torch.where(t0 == int(CtrType.ACTIVE_LB), lb[:, :d0], ub[:, :d0]))
    x = x.clone()
    x[:, list(struct.var_idx)] = val
    return x


def _initialize_v0(ctr_type, Ax, lb, ub, params: ParametersLexLSI):
    """``objective.h:183-237``."""
    t = ctr_type
    v = Ax - 0.5 * (lb + ub)
    v = torch.where(t == int(CtrType.ACTIVE_LB), Ax - lb, v)
    v = torch.where((t == int(CtrType.ACTIVE_UB)) | (t == int(CtrType.ACTIVE_EQ)), Ax - ub, v)
    inactive = t == int(CtrType.INACTIVE)
    if params.set_min_init_ctr_violation:
        vin = torch.where(Ax <= lb, Ax - lb, torch.where(Ax >= ub, Ax - ub, 0.0))
        v = torch.where(inactive, vin, v)
    else:
        tolf = params.tol_feasibility
        feas = (Ax >= lb - tolf) & (Ax <= ub + tolf)
        v = torch.where(inactive & feas, 0.0, v)
    return v


class Phase1Result(NamedTuple):
    """What phase 1 sets of a solver state (``LexLSIState``'s fields of the
    same names): floats (B, n) or (B, m), ints int32 (B, m) or (B,),
    ``log_overflow`` bool (B,).  Fields of equal value may be one tensor."""

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
    cyc_counter: torch.Tensor
    cyc_prev_op: torch.Tensor
    cyc_prev_row: torch.Tensor
    cyc_prev_type: torch.Tensor
    log_len: torch.Tensor
    log_overflow: torch.Tensor


def _phase1_result(A, lb, ub, ctr_type, stamp, next_stamp, x, Ax, v, params: ParametersLexLSI,
                   n_fact: int) -> Phase1Result:
    """The end of phase 1 from x, its A x and the working set: v0 unless
    ``v`` is given, the step at dx = 0, and a state's counters before its
    first iteration (zero, ``n_fact`` factorizations counted, status
    UNKNOWN, the cycling detector's initial values, an empty log that has
    dropped nothing)."""
    B, _, n = A.shape
    dev = A.device
    if v is None:
        v = _initialize_v0(ctr_type, Ax, lb, ub, params)
    # dx of iteration 0 is recomputed by the loop body itself
    dx = torch.zeros(B, n, dtype=A.dtype, device=dev)
    Adx, dv = _form_step(A, lb, ub, ctr_type, Ax, v, dx)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    return Phase1Result(
        x, v, dx, dv, Ax, Adx, ctr_type, stamp, next_stamp, zero, zero, zero, zero + n_fact,
        torch.full((B,), int(TerminationStatus.UNKNOWN), dtype=torch.int32, device=dev),
        *_initial_cycling(B, dev), zero, torch.zeros(B, dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# The decision: ratio test and removal selection
# ---------------------------------------------------------------------------


def _check_blocking(ct, Ax, Adx, v, dv, lb, ub, tol_feas):
    """Ratio test over inactive rows (``lexlsi.py:292-317``,
    ``objective.h:521-578``), first-minimum tie-break.  Returns (alpha,
    row (-1 if none), type, blocking)."""
    B, m = ct.shape
    iota_m = torch.arange(m, device=ct.device)
    inactive = ct == int(CtrType.INACTIVE)
    den = Adx - dv
    neg = den < -tol_feas
    pos = den > tol_feas
    eligible = inactive & (neg | pos)
    rhs = torch.where(neg, lb, ub)
    typ = torch.where(neg, int(CtrType.ACTIVE_LB), int(CtrType.ACTIVE_UB))
    num = rhs - Ax + v
    ratio = (num / torch.where(eligible, den, 1.0)).clamp_min(0.0)
    masked = torch.where(eligible, ratio, torch.inf)
    amin = masked.amin(1)
    first = eligible & (masked == amin[:, None])
    row = torch.where(first, iota_m, INT_MAX).amin(1)
    blocking = (amin < 1.0) & (row < m)
    alpha = torch.where(blocking, amin, 1.0)
    btype = torch.where(blocking, typ.gather(1, row.clamp(max=m - 1)[:, None])[:, 0], 0)
    return alpha, torch.where(blocking, row, -1), btype, blocking


def _row_multipliers(lam_all, Agm, fixed_mask, *, d0, var_idx, **_):
    """Every objective's multipliers over all constraint rows, (B, p, m) in
    user row order, from those over the general rows, ``lam_all`` (B, p,
    m - d0): a simple-bounds row takes its variable's multiplier,
    -A_fix^T lam where the row fixes it and 0 elsewhere
    (:func:`lexlse.fixed_multipliers`)."""
    if not d0:
        return lam_all
    lam_fixed = lexlse.fixed_multipliers(lam_all, Agm, fixed_mask)
    return torch.cat([lam_fixed[:, :, list(var_idx)], lam_all], 2)


def _select_removal(lam_all, ct, st, Agm, fixed_mask, *, d0, var_idx, prio, elig, tol_wrong,
                    tol_correct, deact_first, **_):
    """Batched removal selection (``findActiveCtr2Remove``,
    ``lexlsi.h:1048-1139``) from every objective's multipliers over the
    general rows, ``lam_all`` (B, p, m - d0), vectorized over objectives
    (``tracker.py:888-958``).  Takes the step's options
    (:func:`active_set_kwargs`): the λ-sweep tables ``prio``/``elig``, the
    two sign tolerances and the strategy ``deact_first``.

    The sweep's only coupling across objectives is the CORRECT_SIGN
    marking: a row marked at objective i is not considered at objectives
    after i.  Before the first wrong-sign hit the marks do not depend on
    earlier marks, so the serially updated sense is an exclusive OR-scan
    of the per-objective mark sets.  Returns (found (B,), row (B,), -1
    where none, value (B,)): the value is the selected sign-adjusted
    multiplier under the largest-multiplier strategy and 0 under
    ``deactivate_first_wrong_sign`` or where nothing is found
    (``lexlsi.py:378-391``)."""
    dev = lam_all.device
    iota_m = torch.arange(ct.shape[1], device=dev)
    vals = _row_multipliers(lam_all, Agm, fixed_mask, d0=d0, var_idx=var_idx)  # (B, p, m)
    LB, UB = int(CtrType.ACTIVE_LB), int(CtrType.ACTIVE_UB)
    in_sweep = (elig != 0)[None]
    active0 = ((ct == LB) | (ct == UB))[:, None, :]
    a = torch.where((ct == LB)[:, None, :], -vals, vals)
    mark = in_sweep & active0 & (a > tol_correct)
    marki = mark.to(torch.int32)
    marked_before = (torch.cumsum(marki, 1) - marki) > 0
    wrong = in_sweep & active0 & ~marked_before & (a < -tol_wrong)
    found_j = wrong.any(2)                                         # (B, p)
    found = found_j.any(1)
    first_j = found_j.to(torch.int32).argmax(1)                    # first objective that hits
    hot_j = (torch.arange(found_j.shape[1], device=dev) == first_j[:, None])[:, :, None]
    wrong_s = (wrong & hot_j).any(1)                               # (B, m)
    val = torch.zeros_like(lam_all[:, 0, 0])
    if deact_first:
        kmin = torch.where(wrong_s, st, INT_MAX).amin(1, keepdim=True)
        first = wrong_s & (st == kmin)
    else:
        a_s = torch.where(wrong & hot_j, a, 0.0).sum(1)
        amin = torch.where(wrong_s, a_s, torch.inf).amin(1, keepdim=True)
        tie = wrong_s & (a_s == amin)
        prio_s = prio[first_j.long()]                              # (B, m)
        pmin = torch.where(tie, prio_s, INT_MAX).amin(1, keepdim=True)
        first = tie & (prio_s == pmin)
        val = torch.where(found, amin[:, 0], val)
    row = torch.where(first, iota_m, INT_MAX).amin(1)
    return found, torch.where(found, row, -1).to(torch.int32), val


# ---------------------------------------------------------------------------
# The working-set log and cycling handling
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _log_row_table(dims: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """(2, m) int32 on ``device``: for each constraint row the objective it
    belongs to and its row within that objective, as working-set log
    entries name a constraint.  ``dims`` are all levels, a simple-bounds
    level included as objective 0."""
    obj = np.concatenate([np.full(d, k) for k, d in enumerate(dims)] or [np.zeros(0)])
    row = np.concatenate([np.arange(d) for d in dims] or [np.zeros(0)])
    return torch.as_tensor(np.stack([obj, row]).astype(np.int32), device=device)


def _empty_log(B: int, cap: int, dtype, device):
    """An empty working-set log of ``cap`` entries per instance, in the
    form kernel B2 takes it: (obj, ctr, type, value, rank, cycling) of
    (B, cap) and (len, overflow) of (B,), flags as int32."""
    zi = torch.zeros(B, cap, dtype=torch.int32, device=device)
    z = torch.zeros(B, dtype=torch.int32, device=device)
    return (zi, zi, zi, torch.zeros(B, cap, dtype=dtype, device=device), zi, zi, z, z)


def _initial_cycling(B: int, device):
    """The cycling detector before any operation: (counter 0, previous
    operation UNDEFINED, previous row -1, previous type -1), each (B,)."""
    z = torch.zeros(B, dtype=torch.int32, device=device)
    return (z, z + int(OperationType.UNDEFINED), z - 1, z - 1)


def _log_append(log, alive, blocking, do_remove, brow, rrow, btype, alpha, rval, total_rank,
                row_table):
    """Append this iteration's working-set change to the log of every
    alive instance that made one (``typedefs.h:380-432``,
    ``lexlsi.h:1188-1222``): the constraint as (objective, row within it),
    its new type (INACTIVE for a removal), the step length of an addition
    or the selected multiplier of a removal, and the total rank of the
    iteration's factorization.  A full log drops the entry and raises the
    overflow flag.  ``log`` is (obj, ctr, type, value, rank, cycling, len,
    overflow); the flags keep their dtype (bool or int32)."""
    obj, ctr, typ, val, rank, cyc, length, ovf = log
    cap = obj.shape[1]
    want = (blocking | do_remove) & alive
    can = length < cap
    do_log = want & can
    row = torch.where(blocking, brow, rrow).clamp(min=0).long()
    at = do_log[:, None] & (torch.arange(cap, device=obj.device) == length[:, None])

    def put(buf, entry):
        return torch.where(at, entry[:, None].to(buf.dtype), buf)

    return (put(obj, row_table[0][row]), put(ctr, row_table[1][row]),
            put(typ, torch.where(blocking, btype, int(CtrType.INACTIVE))),
            put(val, torch.where(blocking, alpha, rval)), put(rank, total_rank), cyc,
            length + do_log.to(torch.int32), ovf | (want & ~can))


def _cycling_step(cyc, lb, ub, status, log_cycling, log_len, alive, blocking, do_remove,
                  brow, rrow, btype, rm_type, cyc_max: int, cyc_relax: float):
    """Cycling handling of one iteration (``cycling.h:32-65``) for the
    alive instances: an addition of the (row, type) that the previous
    operation removed is a detection.  Past ``cyc_max`` detections the
    status becomes PROBLEM_SOLVED_CYCLING_HANDLING; otherwise the bound
    that was removed is relaxed by ``cyc_relax``, the counter rises and
    the newest log entry is flagged.  ``rm_type`` is the type the removed
    row had before its removal.  Returns (cyc, lb, ub, status,
    log_cycling) with ``cyc`` = (counter, previous operation, row, type)."""
    cnt, pop, prow, ptype = cyc
    ADD, REMOVE, UNDEFINED = (int(OperationType.ADD), int(OperationType.REMOVE),
                              int(OperationType.UNDEFINED))
    op = torch.where(blocking, ADD, torch.where(do_remove, REMOVE, UNDEFINED))
    row = torch.where(blocking, brow, torch.where(do_remove, rrow, -1))
    typ = torch.where(blocking, btype, torch.where(do_remove, rm_type, -1))
    detected = (op == ADD) & (pop == REMOVE) & (row == prow) & (typ == ptype) & alive
    over = detected & (cnt >= cyc_max)
    relax = detected & ~over
    status = torch.where(over, int(TerminationStatus.PROBLEM_SOLVED_CYCLING_HANDLING), status)
    at = relax[:, None] & (torch.arange(lb.shape[1], device=lb.device) == prow[:, None])
    lb = torch.where(at & (ptype == int(CtrType.ACTIVE_LB))[:, None], lb - cyc_relax, lb)
    ub = torch.where(at & (ptype == int(CtrType.ACTIVE_UB))[:, None], ub + cyc_relax, ub)
    cap = log_cycling.shape[1]
    if cap:
        last = (log_len - 1).clamp(0, cap - 1)
        log_cycling = log_cycling | (
            relax[:, None] & (torch.arange(cap, device=lb.device) == last[:, None]))
    upd = (op != UNDEFINED) & alive
    i32 = torch.int32
    cyc = ((cnt + relax.to(i32)).to(i32), torch.where(upd, op, pop).to(i32),
           torch.where(upd, row, prow).to(i32), torch.where(upd, typ, ptype).to(i32))
    return cyc, lb, ub, status.to(i32), log_cycling


# ---------------------------------------------------------------------------
# The commit
# ---------------------------------------------------------------------------


def _commit(s, gate, dx, dv, Adx, alpha, brow, btype, blocking, rrow, do_remove, solved, *,
            log=None, cycling=None):
    """Apply one iteration's decision to the state ``s`` where ``gate``
    holds (``lexlsi.h:1144-1265``); elsewhere every field keeps its value.
    The working set changes by the blocking row ``brow``, which enters with
    type ``btype`` and the next stamp, or by the removal ``rrow``; the
    counters follow, the status becomes PROBLEM_SOLVED where ``solved``,
    and the step (dx, dv, Adx) is taken with length ``alpha`` where that is
    positive.  The gate selects, it never multiplies: a gated-out instance
    may hold NaNs (a rejected carry of the tracker), and 0 * NaN would
    poison its state.  With ``log`` = (row table, the removal's value, the
    total rank) the change enters the working-set log
    (:func:`_log_append`), with ``cycling`` = (cyc_max, cyc_relax) the
    cycling detector sees it (:func:`_cycling_step`).  Returns (the new
    fields by name, the rows added and removed as (B, m) one-hot masks)."""
    i32 = torch.int32
    iota_m = torch.arange(s.ctr_type.shape[1], device=s.ctr_type.device)
    add, rm = blocking & gate, do_remove & gate
    at_b = add[:, None] & (iota_m == brow[:, None])
    at_r = rm[:, None] & (iota_m == rrow[:, None])
    g, take, a1 = gate[:, None], ((alpha > 0.0) & gate)[:, None], alpha[:, None]
    new = dict(
        x=torch.where(take, s.x + a1 * dx, s.x), v=torch.where(take, s.v + a1 * dv, s.v),
        Ax=torch.where(take, s.Ax + a1 * Adx, s.Ax),
        dx=torch.where(g, dx, s.dx), dv=torch.where(g, dv, s.dv), Adx=torch.where(g, Adx, s.Adx),
        ctr_type=torch.where(at_b, btype[:, None],
                             torch.where(at_r, int(CtrType.INACTIVE), s.ctr_type)).to(i32),
        stamp=torch.where(at_b, s.next_stamp[:, None], torch.where(at_r, -1, s.stamp)).to(i32),
        next_stamp=s.next_stamp + add.to(i32), it=s.it + gate.to(i32),
        n_act=s.n_act + add.to(i32), n_deact=s.n_deact + rm.to(i32),
        n_fact=s.n_fact + (gate & (s.it > 0)).to(i32),
        status=torch.where(gate & solved, int(TerminationStatus.PROBLEM_SOLVED),
                           s.status).to(i32))
    entries = tuple(getattr(s, k) for k in LOG_FIELDS)
    if log is not None:
        row_table, rval, total_rank = log
        entries = _log_append(entries, gate, blocking, do_remove, brow, rrow, btype, alpha,
                              rval, total_rank, row_table)
        new.update(zip(LOG_FIELDS, entries))
    if cycling is not None:
        rm_type = s.ctr_type.gather(1, rrow.clamp(min=0).long()[:, None])[:, 0]
        cyc, new["lb"], new["ub"], new["status"], new["log_cycling"] = _cycling_step(
            tuple(getattr(s, k) for k in CYCLING_FIELDS), s.lb, s.ub, new["status"], entries[5],
            entries[6], gate, blocking, do_remove, brow, rrow, btype, rm_type, *cycling)
        new.update(zip(CYCLING_FIELDS, cyc))
    return new, at_b, at_r
