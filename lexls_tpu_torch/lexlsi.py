"""The primal active-set solver, batched (LexLSI): its two tiers.

Counterpart of ``lexls_tpu/lexlsi.py``: the static ``Structure``, the
solver state, phase 1 (``_initial_state``, ``lexlsi.py:472-551``), the
pieces of one active-set iteration that the tiers, the tracker and the
plain version of kernel B2 share (``_masked_general``, ``_form_step``,
``_check_blocking``, ``_select_removal``, the working-set log and cycling
handling), the whole-solve tier (``solve_core_fused``/``_fused_tail``,
``lexlsi.py:844-1050``), whose active-set loop is kernel B2
(:mod:`lexls_tpu_torch.ops.fused`), the natively batched exact tier
(``solve_core_batched``, ``lexlsi.py:570-834``), which factorizes every
iteration through kernel B1 (:mod:`lexls_tpu_torch.ops.panel_lqr`), runs
every regularization type (:mod:`lexls_tpu_torch.regularization`), the
per-iteration trace and ``use_phase1_v0``, the multipliers at a working
set (``get_lambda``, ``collect_wrong_sign``, ``lexlsi.py:1059-1129``), and
the host API over a batch of one (``solve``, ``solve_lambda``,
``solve_collect_wrong_sign``, ``LexLSIResult``, ``lexlsi.py:1157-1296``).

Every tensor carries a leading batch axis B in place of the JAX
package's ``vmap``.  The working set is data: a per-constraint int32
activation type (``CtrType``) and an insertion stamp per row.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import lexlse, tracing
from .types import (
    CtrType,
    LexLSError,
    OperationType,
    ParametersLexLSI,
    RegularizationType,
    TerminationStatus,
    WorkingSetLogEntry,
)

_INT_MAX = torch.iinfo(torch.int32).max


def full_fp32() -> None:
    """Keep float32 matmuls in full precision: TF32 breaks the
    rank-revealing pivot decisions (the JAX package pins
    ``jax.default_matmul_precision("float32")`` for the same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
# Static problem structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Structure:
    """Static structure of a hierarchy: level segmentation + level-0 kind
    (``lexlsi.py:81-160``)."""

    dims: Tuple[int, ...]
    n_var: int
    simple_bounds: bool = False
    var_idx: Optional[Tuple[int, ...]] = None

    @property
    def m(self) -> int:
        return sum(self.dims)

    @property
    def obj_offset(self) -> int:
        return 1 if self.simple_bounds else 0

    @property
    def d0(self) -> int:
        return self.dims[0] if self.simple_bounds else 0

    @property
    def lexlse_dims(self) -> Tuple[int, ...]:
        return self.dims[1:] if self.simple_bounds else self.dims

    @functools.cached_property
    def first_row(self) -> Tuple[int, ...]:
        return tuple(int(o) for o in np.cumsum((0,) + self.dims[:-1]))

    def sweep_priority(self, j: int) -> np.ndarray:
        """Visit-order priority of each constraint row during the λ sweep
        of lexlse objective ``j`` (levels j..0 descending, then the fixed
        simple-bounds rows; ``lexlse.h:611-762``).  Ineligible rows get
        INT32_MAX."""
        prio = np.full(self.m, np.iinfo(np.int32).max, dtype=np.int32)
        c = 0
        for k in range(j, -1, -1):
            lvl = k + self.obj_offset
            fr, d = self.first_row[lvl], self.dims[lvl]
            prio[fr : fr + d] = np.arange(c, c + d)
            c += d
        if self.simple_bounds:
            prio[: self.d0] = np.arange(c, c + self.d0)
        return prio

    def sweep_eligible(self, j: int) -> np.ndarray:
        """Rows visited during the λ sweep of lexlse objective ``j``."""
        return self.sweep_priority(j) != np.iinfo(np.int32).max

    @staticmethod
    def of(prob) -> "Structure":
        """From any hierarchy with ``dims``, ``n_var``, ``simple_bounds``
        and ``var_idx`` (this package's or the JAX package's)."""
        return Structure(
            dims=tuple(int(d) for d in prob.dims),
            n_var=int(prob.n_var),
            simple_bounds=bool(prob.simple_bounds),
            var_idx=None if prob.var_idx is None else tuple(int(i) for i in prob.var_idx),
        )


# ---------------------------------------------------------------------------
# Solver state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LexLSIState:
    """Batched solver state: float (B, n) or (B, m), int32 (B, m) or (B,).
    The working-set log holds ``cap = max_number_of_factorizations + 2``
    entries per instance when ``log_working_set_enabled`` and none
    otherwise, and the trace as many iterations when ``trace_enabled``
    (``tcap``, else 0); ``lb``/``ub`` are the bounds as cycling handling
    relaxed them."""

    x: torch.Tensor
    v: torch.Tensor
    dx: torch.Tensor
    dv: torch.Tensor
    Ax: torch.Tensor
    Adx: torch.Tensor
    ctr_type: torch.Tensor
    stamp: torch.Tensor      # working-set insertion stamp (-1 inactive)
    next_stamp: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    it: torch.Tensor
    n_act: torch.Tensor
    n_deact: torch.Tensor
    n_fact: torch.Tensor
    status: torch.Tensor
    cyc_counter: torch.Tensor
    cyc_prev_op: torch.Tensor
    cyc_prev_row: torch.Tensor
    cyc_prev_type: torch.Tensor
    log_obj: torch.Tensor       # (B, cap) int32
    log_ctr: torch.Tensor
    log_type: torch.Tensor
    log_value: torch.Tensor     # (B, cap) float
    log_rank: torch.Tensor
    log_cycling: torch.Tensor   # (B, cap) bool
    log_len: torch.Tensor
    log_overflow: torch.Tensor  # (B,) bool: an entry was dropped (log full)
    trace_x: torch.Tensor       # (B, tcap, n) x after each iteration
    trace_v: torch.Tensor       # (B, tcap, m)
    trace_dx: torch.Tensor      # (B, tcap, n)
    trace_dv: torch.Tensor      # (B, tcap, m)
    trace_alpha: torch.Tensor   # (B, tcap)
    trace_op: torch.Tensor      # (B, tcap) int32 OperationType
    trace_row: torch.Tensor     # (B, tcap) int32 row added or removed (-1 none)


# ---------------------------------------------------------------------------
# Phase 1
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


def _masked_general(A, lb, ub, ctr_type, struct: Structure):
    """(A_masked, b_masked, fixed_mask, fixed_val) of the LexLSE subproblem
    at the current working set (``formLexLSE``, ``lexlsi.py:226-246``).
    Active simple-bounds rows become fixed variables; general rows are
    zero when inactive."""
    B, _, n = A.shape
    active = _is_active(ctr_type)
    rhs = _rhs_of_type(lb, ub, ctr_type)
    d0 = struct.d0
    if struct.simple_bounds:
        fixed_mask, fixed_val = _fixed_variables(active, rhs, d0, struct.var_idx, n)
    else:
        fixed_mask = torch.zeros(B, n, dtype=torch.bool, device=A.device)
        fixed_val = torch.zeros(B, n, dtype=A.dtype, device=A.device)
    actg = active[:, d0:].to(A.dtype)
    return A[:, d0:] * actg[:, :, None], rhs[:, d0:] * actg, fixed_mask, fixed_val


def _factorize_masked(Ag, bg, fixed_mask, fixed_val, struct: Structure,
                      params: ParametersLexLSI, reg):
    """The l-QR of the masked subproblem through kernel B1
    (``lexlsi.py:255-272``): ``reg`` holds a factor for every level, the
    simple-bounds level included, which takes none."""
    from .ops import factorize_fast_batched

    reg_g = None if reg is None else (reg[1:] if struct.simple_bounds else reg)
    return factorize_fast_batched(Ag, bg, struct.lexlse_dims, params.lexlse_parameters(),
                                  fixed_mask=fixed_mask, fixed_val=fixed_val, reg_factors=reg_g)


def _reg_factors(reg, params: ParametersLexLSI, A):
    """The per-level factors on ``A``'s device and in its dtype, or None
    where the type is NONE (the factorization then reads none)."""
    if reg is None or params.regularization_type == RegularizationType.NONE:
        return None
    return torch.as_tensor(reg).to(A.device, A.dtype)


def _form_step(A, lb, ub, ctr_type, Ax, v, dx):
    """``objective.h:288-338``: dv anchored to the rhs to kill drift;
    ``Ax`` is the solver's cached value."""
    Adx = _matvec(A, dx)
    rhs = _rhs_of_type(lb, ub, ctr_type)
    dv = -v + torch.where(_is_active(ctr_type), Ax + Adx - rhs, 0.0)
    return Adx, dv


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


def _modify_x_guess(x, ctr_type, lb, ub, struct: Structure):
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


def _initial_state(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0,
                   struct: Structure, params: ParametersLexLSI,
                   x_guess_specified: bool, v0_specified: bool, reg=None) -> LexLSIState:
    """Phase 1 (``lexlsi.h:816-915``): initial x (a cold factorization +
    basic solve, through kernel B1 and damped by ``reg`` under
    regularization, unless a guess is given), v, working set and step.
    With a guess it is :func:`lexls_tpu_torch.ops.phase1.phase1_warm`, one
    kernel launch on the card.  With ``use_phase1_v0`` the guess is
    required and counts no factorization (``lexlsi.py:487-501``).  Traced
    as the span ``lexls.phase1.warm`` with a guess, ``lexls.phase1.cold``
    without one (:mod:`lexls_tpu_torch.tracing`)."""
    from .ops.phase1 import phase1_warm

    with tracing.span("lexls.phase1.warm" if x_guess_specified else "lexls.phase1.cold"):
        B, m, n = A.shape
        dev = A.device
        # hot_start_related_tests (lexlsi.h:758-793): v0 needs x_guess
        if v0_specified and not x_guess_specified:
            v0_specified = False
        if params.use_phase1_v0 and not x_guess_specified:
            raise LexLSError("when use_phase1_v0 = true, x_guess has to be specified")

        if x_guess_specified:
            p1 = phase1_warm(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, struct=struct,
                             params=params, v0_specified=v0_specified)
        else:
            Ag, bg, fixed_mask, fixed_val = _masked_general(A, lb, ub, ctr_type0, struct)
            x = lexlse.solve(_factorize_masked(Ag, bg, fixed_mask, fixed_val, struct, params, reg))
            p1 = _phase1_result(A, lb, ub, ctr_type0, stamp0, next_stamp0, x, _matvec(A, x),
                                None, params, n_fact=1)
        cap = params.max_number_of_factorizations + 2 if params.log_working_set_enabled else 0
        tcap = params.max_number_of_factorizations + 2 if params.trace_enabled else 0
        i32 = dict(dtype=torch.int32, device=dev)
        fl = dict(dtype=A.dtype, device=dev)
        b8 = dict(dtype=torch.bool, device=dev)
        # zero-capacity arrays hold nothing to fill: one empty tensor per shape
        ei, ef = torch.empty(B, 0, **i32), torch.empty(B, 0, **fl)
        log_int = torch.zeros(B, cap, **i32) if cap else ei
        log_value = torch.zeros(B, cap, **fl) if cap else ef
        log_cycling = torch.zeros(B, cap, **b8) if cap else torch.empty(B, 0, **b8)
        if tcap:
            trace = dict(trace_x=torch.zeros(B, tcap, n, **fl),
                         trace_v=torch.zeros(B, tcap, m, **fl),
                         trace_dx=torch.zeros(B, tcap, n, **fl),
                         trace_dv=torch.zeros(B, tcap, m, **fl),
                         trace_alpha=torch.zeros(B, tcap, **fl),
                         trace_op=torch.zeros(B, tcap, **i32),
                         trace_row=torch.full((B, tcap), -1, **i32))
        else:
            tn, tm = torch.empty(B, 0, n, **fl), torch.empty(B, 0, m, **fl)
            trace = dict(trace_x=tn, trace_v=tm, trace_dx=tn, trace_dv=tm, trace_alpha=ef,
                         trace_op=ei, trace_row=ei)
        return LexLSIState(
            **p1._asdict(), lb=lb, ub=ub, log_obj=log_int, log_ctr=log_int, log_type=log_int,
            log_value=log_value, log_rank=log_int, log_cycling=log_cycling, **trace)


# ---------------------------------------------------------------------------
# Pieces of one active-set iteration, shared by the exact tier below, the
# plain version of kernel B2 and the tracker
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
    row = torch.where(first, iota_m, _INT_MAX).amin(1)
    blocking = (amin < 1.0) & (row < m)
    alpha = torch.where(blocking, amin, 1.0)
    btype = torch.where(blocking, typ.gather(1, row.clamp(max=m - 1)[:, None])[:, 0], 0)
    return alpha, torch.where(blocking, row, -1), btype, blocking


@functools.lru_cache(maxsize=64)
def _sweep_tables(struct: Structure, device: torch.device):
    """(prio, elig), each (p, m) int32 on ``device``: the λ-sweep visit
    priorities and eligibility per lexlse objective, made once per
    (structure, device) rather than copied to the device at every step."""
    p = len(struct.lexlse_dims)
    prio = np.stack([struct.sweep_priority(j) for j in range(p)])
    elig = np.stack([struct.sweep_eligible(j) for j in range(p)]).astype(np.int32)
    return torch.as_tensor(prio, device=device), torch.as_tensor(elig, device=device)


def _row_multipliers(lam_all, Agm, fixed_mask, struct: Structure):
    """Every objective's multipliers over all constraint rows, (B, p, m) in
    user row order, from those over the general rows, ``lam_all`` (B, p,
    m - d0): a simple-bounds row takes its variable's multiplier,
    -A_fix^T lam where the row fixes it and 0 elsewhere
    (:func:`lexlse.fixed_multipliers`)."""
    if not struct.d0:
        return lam_all
    lam_fixed = lexlse.fixed_multipliers(lam_all, Agm, fixed_mask)
    return torch.cat([lam_fixed[:, :, list(struct.var_idx)], lam_all], 2)


def _select_removal(lam_all, ct, st, Agm, fixed_mask, struct: Structure,
                    params: ParametersLexLSI):
    """Batched removal selection (``findActiveCtr2Remove``,
    ``lexlsi.h:1048-1139``) from every objective's multipliers over the
    general rows, ``lam_all`` (B, p, m - d0), vectorized over objectives
    (``tracker.py:888-958``).

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
    iota_m = torch.arange(struct.m, device=dev)
    prio_all, elig_all = _sweep_tables(struct, dev)               # (p, m) int32
    vals = _row_multipliers(lam_all, Agm, fixed_mask, struct)      # (B, p, m)
    LB, UB = int(CtrType.ACTIVE_LB), int(CtrType.ACTIVE_UB)
    elig = (elig_all != 0)[None]
    active0 = ((ct == LB) | (ct == UB))[:, None, :]
    a = torch.where((ct == LB)[:, None, :], -vals, vals)
    mark = elig & active0 & (a > params.tol_correct_sign_lambda)
    marki = mark.to(torch.int32)
    marked_before = (torch.cumsum(marki, 1) - marki) > 0
    wrong = elig & active0 & ~marked_before & (a < -params.tol_wrong_sign_lambda)
    found_j = wrong.any(2)                                         # (B, p)
    found = found_j.any(1)
    first_j = found_j.to(torch.int32).argmax(1)                    # first objective that hits
    hot_j = (torch.arange(found_j.shape[1], device=dev) == first_j[:, None])[:, :, None]
    wrong_s = (wrong & hot_j).any(1)                               # (B, m)
    val = torch.zeros_like(lam_all[:, 0, 0])
    if params.deactivate_first_wrong_sign:
        kmin = torch.where(wrong_s, st, _INT_MAX).amin(1, keepdim=True)
        first = wrong_s & (st == kmin)
    else:
        a_s = torch.where(wrong & hot_j, a, 0.0).sum(1)
        amin = torch.where(wrong_s, a_s, torch.inf).amin(1, keepdim=True)
        tie = wrong_s & (a_s == amin)
        prio_s = prio_all[first_j.long()]                          # (B, m)
        pmin = torch.where(tie, prio_s, _INT_MAX).amin(1, keepdim=True)
        first = tie & (prio_s == pmin)
        val = torch.where(found, amin[:, 0], val)
    row = torch.where(first, iota_m, _INT_MAX).amin(1)
    return found, torch.where(found, row, -1).to(torch.int32), val


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
# The whole-solve tier
# ---------------------------------------------------------------------------


def _check_whole_solve_tier(params: ParametersLexLSI, name: str) -> None:
    """Refuse what the whole-solve tier does not run: regularization, the
    trace and ``use_phase1_v0`` (kernel B2 has none of them, as the JAX
    package's kernel, ``lexlsi.py:862-872``, PARITY.md:132-133); the exact
    tier, ``solve_core_batched``, runs all three."""
    if params.regularization_type != RegularizationType.NONE:
        raise LexLSError(f"{name}: regularization runs on the exact tier only "
                         "(solve_core_batched)")
    if params.trace_enabled or params.use_phase1_v0:
        raise LexLSError(f"{name}: trace/use_phase1_v0 run on the exact tier only "
                         "(solve_core_batched)")


def solve_core_fused(
    A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, reg,
    struct: Structure, params: ParametersLexLSI,
    x_guess_specified: bool, v0_specified: bool, return_factors: bool = False,
):
    """Whole-solve tier (``lexlsi.py:844-891``): phase 1 in torch, then
    the entire active-set loop in kernel B2, the working-set log and
    cycling handling included.  All arrays carry a leading batch axis
    except ``reg`` (per-level regularization factors, unused: the kernel
    has no regularization).  With ``return_factors`` returns
    ``(state, (rpad, posf, ranks))``, the final factorization that
    :func:`lexls_tpu_torch.tracker.bootstrap_carried` takes.  Raises
    ``LexLSError`` for options the port does not support.  Traced as the
    span ``lexls.solve_core_fused``, over phase 1's and B2's
    (:mod:`lexls_tpu_torch.tracing`)."""
    with tracing.span("lexls.solve_core_fused"):
        _check_whole_solve_tier(params, "solve_core_fused")
        full_fp32()
        A, lb, ub = A.contiguous(), lb.contiguous(), ub.contiguous()
        s = _initial_state(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0,
                           struct, params, x_guess_specified, v0_specified)
        return _fused_tail(A, s, struct=struct, params=params, return_factors=return_factors)


def active_set_kwargs(struct: Structure, params: ParametersLexLSI, device) -> dict:
    """Keyword arguments of kernel B2 (and of its plain version) for a
    structure and parameters: level sizes, tolerances, the λ-sweep tables
    of :func:`_sweep_tables`, and the log and cycling options."""
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


def _fused_tail(A, s: LexLSIState, it0=None, *, struct: Structure, params: ParametersLexLSI,
                return_factors: bool = False):
    """Run the whole-solve active-set loop (kernel B2) from a phase-1
    state ``s``, or from a mid-solve state with per-instance iteration
    counters ``it0`` (``lexlsi.py:915-1050`` without compaction: a CUDA
    block per instance does not wait for the slowest instance of a tile,
    so the trajectory is the same without it).  The log and the cycling
    detector continue from the state's and go back into it, with the
    relaxed bounds, when their options are on.  Instances still UNKNOWN
    afterwards ran out of factorizations.  B2's wrapper, from the keyword
    arguments to the launch, is traced as the span ``lexls.b2``."""
    from .ops.fused import fused_active_set

    log_on, cyc_on = params.log_working_set_enabled, params.cycling_handling_enabled
    i32 = torch.int32
    log_state = (s.log_obj, s.log_ctr, s.log_type, s.log_value, s.log_rank,
                 s.log_cycling.to(i32), s.log_len, s.log_overflow.to(i32)) if log_on else None
    cyc_state = (s.cyc_counter, s.cyc_prev_op, s.cyc_prev_row, s.cyc_prev_type) if cyc_on else None
    with tracing.span("lexls.b2"):
        out = fused_active_set(A, s.lb, s.ub, s.ctr_type, s.stamp, s.next_stamp, s.x, s.v,
                               s.Ax, s.n_fact, it0, log_state, cyc_state,
                               **active_set_kwargs(struct, params, A.device))
    status = torch.where(out.status == int(TerminationStatus.UNKNOWN),
                         int(TerminationStatus.MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED),
                         out.status).to(torch.int32)
    state = dataclasses.replace(
        s, x=out.x, v=out.v, dx=out.dx, dv=out.dv, Ax=out.Ax, Adx=out.Adx,
        ctr_type=out.ctr_type, stamp=out.stamp, next_stamp=out.next_stamp,
        it=out.it, n_act=out.n_act, n_deact=out.n_deact, n_fact=out.n_fact,
        status=status)
    if log_on:
        state = dataclasses.replace(
            state, log_obj=out.log_obj, log_ctr=out.log_ctr, log_type=out.log_type,
            log_value=out.log_value, log_rank=out.log_rank,
            log_cycling=out.log_cycling.bool(), log_len=out.log_len,
            log_overflow=out.log_overflow.bool())
    if cyc_on:
        state = dataclasses.replace(
            state, lb=out.lb, ub=out.ub, cyc_counter=out.cyc_counter,
            cyc_prev_op=out.cyc_prev_op, cyc_prev_row=out.cyc_prev_row,
            cyc_prev_type=out.cyc_prev_type)
    if return_factors:
        return state, (out.rpad, out.posf, out.ranks)
    return state


# ---------------------------------------------------------------------------
# The exact tier, natively batched: kernel B1 factorizes every iteration
# ---------------------------------------------------------------------------


def _lambda_sweep(f, Ag, ctr_type, stamp, struct: Structure, params: ParametersLexLSI):
    """Find an active constraint to remove (``lexlsi.py:325-398``): every
    objective's multipliers from the factorization, in one transposed pass
    or, under TIKHONOV_1, one regularized objective at a time
    (``lexlse.objective_sensitivity_regularized``), then the removal
    selection.  Returns (found, row (-1 where none), selected value)."""
    if params.regularization_type == RegularizationType.TIKHONOV_1:
        lam_all = torch.stack([lexlse.objective_sensitivity_regularized(f, j)
                               for j in range(len(f.dims))], 1)
    else:
        lam_all = lexlse.sensitivities_all(f)
    return _select_removal(lam_all, ctr_type, stamp, Ag, f.fixed_mask, struct, params)


def _instance_alive(s: LexLSIState, max_fact: int):
    return (s.status == int(TerminationStatus.UNKNOWN)) & ((s.it == 0) | (s.n_fact < max_fact))


def _verify_with_f(s: LexLSIState, A, Ag, f, alive, struct: Structure,
                   params: ParametersLexLSI) -> LexLSIState:
    """One active-set iteration of every instance given the factorization
    ``f`` of its current working set (``lexlsi.py:570-720``): solve, step,
    ratio test, removal sweep, working-set update, log, trace and cycling
    handling.  With ``use_phase1_v0`` iteration 0 keeps phase 1's step and
    runs no removal sweep.  Instances that are not ``alive`` keep their
    state, their trace included."""
    B, m, _ = A.shape
    i32 = torch.int32
    iota_m = torch.arange(m, device=A.device)
    dx = lexlse.solve(f) - s.x
    Adx, dv = _form_step(A, s.lb, s.ub, s.ctr_type, s.Ax, s.v, dx)
    want_sweep = torch.ones_like(alive)
    if params.use_phase1_v0:
        normal = (s.it != 0)[:, None]
        dx, Adx, dv = (torch.where(normal, a, b) for a, b in
                       ((dx, s.dx), (Adx, s.Adx), (dv, s.dv)))
        want_sweep = normal[:, 0]
    alpha, brow, btype, blocking = _check_blocking(
        s.ctr_type, s.Ax, Adx, s.v, dv, s.lb, s.ub, params.tol_feasibility)
    # the sweep's result counts only where nothing blocks
    found_rm, rrow, rval = _lambda_sweep(f, Ag, s.ctr_type, s.stamp, struct, params)
    want_sweep = want_sweep & ~blocking
    do_remove = want_sweep & found_rm
    solved = want_sweep & ~found_rm

    at_b = blocking[:, None] & (iota_m == brow[:, None])
    at_r = do_remove[:, None] & (iota_m == rrow[:, None])
    ctr_type = torch.where(at_b, btype[:, None],
                           torch.where(at_r, int(CtrType.INACTIVE), s.ctr_type)).to(i32)
    stamp = torch.where(at_b, s.next_stamp[:, None], torch.where(at_r, -1, s.stamp)).to(i32)
    status = torch.where(solved, int(TerminationStatus.PROBLEM_SOLVED), s.status).to(i32)
    new = dict(
        dx=dx, dv=dv, Adx=Adx, ctr_type=ctr_type, stamp=stamp,
        next_stamp=s.next_stamp + blocking.to(i32), it=s.it + 1,
        n_act=s.n_act + blocking.to(i32), n_deact=s.n_deact + do_remove.to(i32),
        n_fact=s.n_fact + (s.it > 0).to(i32))

    log = (s.log_obj, s.log_ctr, s.log_type, s.log_value, s.log_rank, s.log_cycling,
           s.log_len, s.log_overflow)
    if params.log_working_set_enabled:
        log = _log_append(log, alive, blocking, do_remove, brow, rrow, btype, alpha, rval,
                          f.total_rank, _log_row_table(struct.dims, A.device))
    if params.cycling_handling_enabled:
        rm_type = s.ctr_type.gather(1, rrow.clamp(min=0).long()[:, None])[:, 0]
        cyc, lb, ub, status, log_cycling = _cycling_step(
            (s.cyc_counter, s.cyc_prev_op, s.cyc_prev_row, s.cyc_prev_type), s.lb, s.ub,
            status, log[5], log[6], alive, blocking, do_remove, brow, rrow, btype, rm_type,
            params.cycling_max_counter, params.cycling_relax_step)
        log = log[:5] + (log_cycling,) + log[6:]
        new.update(lb=lb, ub=ub, cyc_counter=cyc[0], cyc_prev_op=cyc[1], cyc_prev_row=cyc[2],
                   cyc_prev_type=cyc[3])
    new.update(zip(("log_obj", "log_ctr", "log_type", "log_value", "log_rank", "log_cycling",
                    "log_len", "log_overflow"), log))

    # step (lexlsi.h:1243-1250)
    take = (alpha > 0.0)[:, None]
    a1 = alpha[:, None]
    new.update(x=torch.where(take, s.x + a1 * dx, s.x), v=torch.where(take, s.v + a1 * dv, s.v),
               Ax=torch.where(take, s.Ax + a1 * Adx, s.Ax), status=status)

    # per-iteration trace (outputStuff, lexlsi.h:1272-1379): entry it, or
    # the last one once the budget's entries are spent
    tcap = s.trace_x.shape[1]
    if tcap:
        at = torch.arange(tcap, device=A.device) == s.it.clamp(max=tcap - 1)[:, None]
        op = torch.where(blocking, int(OperationType.ADD),
                         torch.where(do_remove, int(OperationType.REMOVE),
                                     int(OperationType.UNDEFINED)))
        row = torch.where(blocking, brow, torch.where(do_remove, rrow, -1))

        def put(buf, entry):
            mask = at.reshape(at.shape + (1,) * (buf.dim() - 2))
            return torch.where(mask, entry[:, None].to(buf.dtype), buf)

        new.update(trace_x=put(s.trace_x, new["x"]), trace_v=put(s.trace_v, new["v"]),
                   trace_dx=put(s.trace_dx, dx), trace_dv=put(s.trace_dv, dv),
                   trace_alpha=put(s.trace_alpha, alpha), trace_op=put(s.trace_op, op),
                   trace_row=put(s.trace_row, row))
    return dataclasses.replace(s, **{
        k: torch.where(alive.reshape((-1,) + (1,) * (v.dim() - 1)), v, getattr(s, k))
        for k, v in new.items()})


def solve_core_batched(
    A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, reg,
    struct: Structure, params: ParametersLexLSI,
    x_guess_specified: bool, v0_specified: bool,
) -> LexLSIState:
    """Natively batched whole solver, the exact tier
    (``lexlsi.py:775-834``): phase 1, then :func:`_exact_tail`.  All
    arrays carry a leading batch axis except ``reg``, the per-level
    regularization factors (p,), shared by the batch, read under a
    regularization type other than NONE.  Honours both removal strategies,
    simple bounds, every regularization type with the variable factor, the
    working-set log, cycling handling, the trace and ``use_phase1_v0``."""
    full_fp32()
    A, lb, ub = A.contiguous(), lb.contiguous(), ub.contiguous()
    reg = _reg_factors(reg, params, A)
    s = _initial_state(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0,
                       struct, params, x_guess_specified, v0_specified, reg=reg)
    return _exact_tail(A, s, reg, struct, params)


def _exact_tail(A, s: LexLSIState, reg, struct: Structure, params: ParametersLexLSI):
    """The exact tier's active-set loop from a phase-1 or mid-solve state
    ``s`` (``lexlsi.py:800-834``, ``tracker.py:1058-1089``): every pass
    builds the masked subproblem of each instance, factorizes it through
    kernel B1 (one launch per level; its plain version for CPU tensors),
    damped by ``reg`` (device tensor or None), and runs
    :func:`_verify_with_f`.  Terminated instances are frozen, and the loop
    reads ``alive.any()`` once per pass.  Instances still UNKNOWN at the
    end ran out of factorizations."""
    max_fact = params.max_number_of_factorizations
    while True:
        alive = _instance_alive(s, max_fact)
        if not bool(alive.any()):
            break
        Ag, bg, fixed_mask, fixed_val = _masked_general(A, s.lb, s.ub, s.ctr_type, struct)
        f = _factorize_masked(Ag, bg, fixed_mask, fixed_val, struct, params, reg)
        s = _verify_with_f(s, A, Ag, f, alive, struct, params)
    status = torch.where(s.status == int(TerminationStatus.UNKNOWN),
                         int(TerminationStatus.MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED),
                         s.status).to(torch.int32)
    return dataclasses.replace(s, status=status)


# ---------------------------------------------------------------------------
# Lagrange multipliers at a working set
# ---------------------------------------------------------------------------


def get_lambda(A, lb, ub, ctr_type, reg, struct: Structure,
               params: ParametersLexLSI) -> torch.Tensor:
    """The λ matrix of every instance at its working set, (B, m, n_obj) in
    user constraint order (``lexlsi.py:1059-1090``, ``lexlsi.h:552-605``):
    column k holds the multipliers of objective k, the simple-bounds
    objective's column zero.  The working set is factorized through kernel
    B1 (damped by ``reg`` under regularization); the multipliers come from
    the factorization's residuals under every type, TIKHONOV_1 included, as
    the reference's debug λ-matrix overload (``lexlse.h:770-861``)."""
    full_fp32()
    A, lb, ub = A.contiguous(), lb.contiguous(), ub.contiguous()
    Ag, bg, fixed_mask, fixed_val = _masked_general(A, lb, ub, ctr_type, struct)
    f = _factorize_masked(Ag, bg, fixed_mask, fixed_val, struct, params,
                          _reg_factors(reg, params, A))
    lam = _row_multipliers(lexlse.sensitivities_all(f), Ag, fixed_mask, struct)  # (B, p, m)
    if struct.simple_bounds:
        lam = torch.cat([torch.zeros_like(lam[:, :1]), lam], 1)
    return lam.transpose(1, 2)


def collect_wrong_sign(A, lb, ub, ctr_type, reg, struct: Structure,
                       params: ParametersLexLSI):
    """All wrong-sign multipliers of every objective of every instance
    (``lexlsi.py:1093-1129``, the collect-all ``ObjectiveSensitivity`` of
    ``lexlse.h:511-602`` for each objective at once).  Returns ``(wrong,
    marked, lam)``, each (B, m, n_obj) in user constraint order:
    ``wrong[b, i, j]`` iff row i is an active LB/UB constraint in
    objective j's scope (levels up to j and the simple-bounds rows) whose
    sign-adjusted multiplier is below ``-tol_wrong_sign_lambda``;
    ``marked`` iff it exceeds ``tol_correct_sign_lambda``; ``lam`` is
    :func:`get_lambda`."""
    lam = get_lambda(A, lb, ub, ctr_type, reg, struct, params)
    _, elig = _sweep_tables(struct, lam.device)                     # (p, m)
    scope = torch.cat([torch.zeros_like(elig[:struct.obj_offset]), elig], 0).T != 0
    is_lb = ctr_type == int(CtrType.ACTIVE_LB)
    eligible = (is_lb | (ctr_type == int(CtrType.ACTIVE_UB)))[:, :, None] & scope
    a = torch.where(is_lb[:, :, None], -lam, lam)
    return (eligible & (a < -params.tol_wrong_sign_lambda),
            eligible & (a > params.tol_correct_sign_lambda), lam)


# ---------------------------------------------------------------------------
# Host API: one hierarchy, NumPy in and out
# ---------------------------------------------------------------------------


def initial_activation(prob, active_guess: Optional[np.ndarray] = None):
    """Initial (ctr_type, stamp, next_stamp) of one hierarchy, NumPy in
    and out (``lexlsi.py:1132-1153``): equality constraints (lb == ub to
    1e-15; general rows only with a nonzero normal, ``lexlsi.h:367-385``)
    activate in row order, then the LB/UB rows of the user's guess
    (``api_activate``, ``lexlsi.h:120-136``: EQ cannot be set, and a row
    that already has a type keeps it)."""
    ctr_type = prob.initial_ctr_type().astype(np.int32)
    eq = ctr_type == int(CtrType.ACTIVE_EQ)
    stamp = np.full(len(ctr_type), -1, dtype=np.int32)
    c = int(eq.sum())
    stamp[eq] = np.arange(c, dtype=np.int32)
    if active_guess is not None:
        guess = np.asarray(active_guess, np.int32)
        g = (ctr_type == int(CtrType.INACTIVE)) & (
            (guess == int(CtrType.ACTIVE_LB)) | (guess == int(CtrType.ACTIVE_UB)))
        ctr_type[g] = guess[g]
        stamp[g] = c + np.arange(int(g.sum()), dtype=np.int32)
        c += int(g.sum())
    return ctr_type, stamp, np.int32(c)


def host_device(device) -> torch.device:
    """The device of a host entry point: the caller's, never a silent
    fallback to the CPU.  Raises ``LexLSError`` for a CUDA device on a
    machine without one."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise LexLSError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def host_tensor(a, device, dtype=None):
    """How host input becomes a tensor, for every entry point of the port.
    A tensor (or None) is returned as it is: never moved, never cast.  A
    NumPy array (or anything ``np.asarray`` takes) goes to ``device``
    (:func:`host_device`), in ``dtype`` when one is given, else as int32
    when it holds integers and in its own dtype when it holds floats."""
    if a is None or torch.is_tensor(a):
        return a
    a = np.asarray(a)
    if dtype is None and (np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_):
        dtype = torch.int32
    t = torch.as_tensor(a, device=host_device(device))
    return t if dtype is None else t.to(dtype)


def _at_working_set(prob, res: "LexLSIResult", dtype, device):
    """(A, lb, ub, ctr_type, reg) of one hierarchy at the final working set
    and bounds of ``res``, with a batch axis of one except ``reg``."""
    dev = host_device(device)
    A, lb, ub, reg = (host_tensor(a, dev, dtype)
                      for a in (prob.A, res.lb, res.ub, prob.regularization))
    return A[None], lb[None], ub[None], host_tensor(res.ctr_type, dev)[None], reg


def solve_core(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, reg,
               struct: Structure, params: ParametersLexLSI,
               x_guess_specified: bool, v0_specified: bool) -> LexLSIState:
    """The whole solver on one instance (``lexlsi.py:727-761``): arrays
    without a batch axis in and out, a batch of one through the exact
    tier, :func:`solve_core_batched`."""
    full_fp32()
    s = solve_core_batched(A[None], lb[None], ub[None], ctr_type0[None], stamp0[None],
                           next_stamp0.reshape(1), x0[None], v0[None], reg, struct=struct,
                           params=params, x_guess_specified=x_guess_specified,
                           v0_specified=v0_specified)
    return LexLSIState(**{f.name: getattr(s, f.name)[0] for f in dataclasses.fields(s)})


def _np(t):
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class LexLSIResult:
    """Host-side result of one solve, mirror of the MEX outputs
    (``lexlsi.cpp:632-770``, ``lexlsi.py:1157-1222``); ``state`` is the
    solver state without its batch axis, on the device of the solve."""

    x: np.ndarray
    status: TerminationStatus
    ctr_type: np.ndarray
    v: np.ndarray
    n_iterations: int
    n_activations: int
    n_deactivations: int
    n_factorizations: int
    cycling_counter: int
    working_set_log: list
    log_overflow: bool
    lb: np.ndarray
    ub: np.ndarray
    state: LexLSIState

    def trace(self) -> dict:
        """The per-iteration trace (``ParametersLexLSI(trace_enabled=True)``)
        as NumPy arrays trimmed to the iterations run: x, v, dx, dv, alpha,
        op (OperationType code) and row (constraint added or removed, -1
        none); the counterpart of the reference's ``outputStuff``
        (``lexlsi.h:1272-1379``)."""
        s = self.state
        if s.trace_x.shape[0] == 0:
            raise LexLSError("trace_enabled was not set in ParametersLexLSI")
        k = min(self.n_iterations, s.trace_x.shape[0])
        return {key: _np(getattr(s, f"trace_{key}")[:k])
                for key in ("x", "v", "dx", "dv", "alpha", "op", "row")}

    def export_trace(self, path: str, append: bool = False) -> None:
        """Write the trace as a MATLAB-readable script (``outputStuff``,
        ``lexlsi.h:1272-1379``): the final counters as comments, then for
        each iteration t ``operation_(t)``, ``ctr_row_(t)``,
        ``stepLength_(t)`` and the columns ``x_(:,t)``, ``v_(:,t)``,
        ``dx_(:,t)``, ``dv_(:,t)``."""
        tr = self.trace()

        def vec(v):
            return "[ " + "; ".join(f"{float(a):.15e}" for a in v) + " ];"

        with open(path, "a" if append else "w") as fh:
            fh.write("% lexls_tpu solver trace\n")
            fh.write(f"% status          = {int(self.status)}\n")
            fh.write(f"% nIterations     = {self.n_iterations}\n")
            fh.write(f"% nFactorizations = {self.n_factorizations}\n")
            fh.write(f"% nActivations    = {self.n_activations}\n")
            fh.write(f"% nDeactivations  = {self.n_deactivations}\n")
            fh.write(f"% cycling counter = {self.cycling_counter}\n")
            for t in range(tr["x"].shape[0]):
                fh.write("% ==============================================\n")
                fh.write(f"operation_({t + 1}) = {int(tr['op'][t])};\n")
                fh.write(f"ctr_row_({t + 1}) = {int(tr['row'][t])};\n")
                fh.write(f"stepLength_({t + 1}) = {float(tr['alpha'][t]):.15e};\n")
                for key in ("x", "v", "dx", "dv"):
                    fh.write(f"{key}_(:,{t + 1}) = {vec(tr[key][t])}\n")


def solve(prob, params: Optional[ParametersLexLSI] = None, x0=None, v0=None,
          active_guess=None, dtype=torch.float64, device="cuda") -> LexLSIResult:
    """Solve one inequality hierarchy (``lexlsi.py:1225-1269``): the exact
    tier on a batch of one, kernel B1 factorizing every level of every
    pass.  ``x0``/``v0``/``active_guess`` are the optional hot start
    (NumPy).  Runs on ``device`` (the card by default; ``device="cpu"``
    runs the plain versions of the kernels), never elsewhere."""
    params = params or ParametersLexLSI()
    dev = host_device(device)
    struct = Structure.of(prob)
    ct0, st0, ns0 = initial_activation(prob, active_guess)
    x0_ = np.zeros(struct.n_var) if x0 is None else x0
    v0_ = np.zeros(struct.m) if v0 is None else v0
    A, lb, ub, x0_, v0_, reg = (host_tensor(a, dev, dtype)
                                for a in (prob.A, prob.lb, prob.ub, x0_, v0_, prob.regularization))
    ct0, st0, ns0 = (host_tensor(a, dev) for a in (ct0, st0, ns0))
    s = solve_core(A, lb, ub, ct0, st0, ns0, x0_, v0_, reg, struct, params,
                   x0 is not None, v0 is not None)
    log = []
    if params.log_working_set_enabled:
        fields = [_np(getattr(s, f"log_{k}")[:int(s.log_len)])
                  for k in ("obj", "ctr", "type", "value", "rank", "cycling")]
        log = [WorkingSetLogEntry(obj_index=int(o), ctr_index=int(c), ctr_type=int(t),
                                  alpha_or_lambda=float(v), rank=int(r),
                                  cycling_detected=bool(y)) for o, c, t, v, r, y in zip(*fields)]
    return LexLSIResult(
        x=_np(s.x), status=TerminationStatus(int(s.status)), ctr_type=_np(s.ctr_type),
        v=_np(s.v), n_iterations=int(s.it), n_activations=int(s.n_act),
        n_deactivations=int(s.n_deact), n_factorizations=int(s.n_fact),
        cycling_counter=int(s.cyc_counter), working_set_log=log,
        log_overflow=bool(s.log_overflow), lb=_np(s.lb), ub=_np(s.ub), state=s)


def solve_lambda(prob, res: LexLSIResult, params: Optional[ParametersLexLSI] = None,
                 dtype=torch.float64, device="cuda") -> np.ndarray:
    """The λ matrix (m, n_obj) at the final working set of ``res``
    (``lexlsi.py:1272-1281``), through :func:`get_lambda`."""
    return _np(get_lambda(*_at_working_set(prob, res, dtype, device), Structure.of(prob),
                          params or ParametersLexLSI())[0])


def solve_collect_wrong_sign(prob, res: LexLSIResult, params: Optional[ParametersLexLSI] = None,
                             dtype=torch.float64, device="cuda"):
    """:func:`collect_wrong_sign` at the working set of ``res``
    (``lexlsi.py:1284-1296``): ``(wrong, marked, lam)``, each (m, n_obj),
    as NumPy arrays."""
    return tuple(_np(t[0]) for t in collect_wrong_sign(
        *_at_working_set(prob, res, dtype, device), Structure.of(prob),
        params or ParametersLexLSI()))
