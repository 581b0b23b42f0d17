"""The primal active-set solver, batched (LexLSI): its two tiers.

Counterpart of ``lexls_tpu/lexlsi.py``: the static ``Structure``, the
solver state, phase 1 (``_initial_state``, ``lexlsi.py:472-551``), the
whole-solve tier (``solve_core_fused``/``_fused_tail``,
``lexlsi.py:844-1050``), whose active-set loop is kernel B2
(:mod:`lexls_tpu_torch.ops.fused`), the natively batched exact tier
(``solve_core_batched``, ``lexlsi.py:570-834``), which factorizes every
iteration through kernel B1 (:mod:`lexls_tpu_torch.ops.panel_lqr`), runs
every regularization type (:mod:`lexls_tpu_torch.regularization`), the
per-iteration trace and ``use_phase1_v0``, the multipliers at a working
set (``get_lambda``, ``collect_wrong_sign``, ``lexlsi.py:1059-1129``), and
the host API over a batch of one (``solve``, ``solve_lambda``,
``solve_collect_wrong_sign``, ``LexLSIResult``, ``lexlsi.py:1157-1296``).
The pieces of an iteration that the tiers, the tracker and the plain
version of kernel B2 share are :mod:`lexls_tpu_torch.active_set`'s.

Every tensor carries a leading batch axis B in place of the JAX
package's ``vmap``.  The working set is data: a per-constraint int32
activation type (``CtrType``) and an insertion stamp per row.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import lexlse, tracing
from .active_set import (
    CYCLING_FIELDS,
    LOG_FIELDS,
    STEP_FIELDS,
    _check_blocking,
    _commit,
    _form_step,
    _log_row_table,
    _masked_general,
    _matvec,
    _phase1_result,
    _row_multipliers,
    _select_removal,
    _sweep_tables,
    active_set_kwargs,
    full_fp32,
)
from .ops import ActiveSetResult, factorize_fast_batched, fused
from .ops.phase1 import phase1_warm
from .types import (
    CtrType,
    LexLSError,
    OperationType,
    ParametersLexLSI,
    RegularizationType,
    TerminationStatus,
    WorkingSetLogEntry,
)


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


def _factorize_masked(Ag, bg, fixed_mask, fixed_val, struct: Structure,
                      params: ParametersLexLSI, reg):
    """The l-QR of the masked subproblem through kernel B1
    (``lexlsi.py:255-272``): ``reg`` holds a factor for every level, the
    simple-bounds level included, which takes none."""
    reg_g = None if reg is None else (reg[1:] if struct.simple_bounds else reg)
    return factorize_fast_batched(Ag, bg, struct.lexlse_dims, params.lexlse_parameters(),
                                  fixed_mask=fixed_mask, fixed_val=fixed_val, reg_factors=reg_g)


def _reg_factors(reg, params: ParametersLexLSI, A):
    """The per-level factors on ``A``'s device and in its dtype, or None
    where the type is NONE (the factorization then reads none)."""
    if reg is None or params.regularization_type == RegularizationType.NONE:
        return None
    return torch.as_tensor(reg).to(A.device, A.dtype)


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
            Ag, bg, fixed_mask, fixed_val = _masked_general(A, lb, ub, ctr_type0, d0=struct.d0,
                                                            var_idx=struct.var_idx)
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
    log_on, cyc_on = params.log_working_set_enabled, params.cycling_handling_enabled
    i32 = torch.int32
    log_state = (s.log_obj, s.log_ctr, s.log_type, s.log_value, s.log_rank,
                 s.log_cycling.to(i32), s.log_len, s.log_overflow.to(i32)) if log_on else None
    cyc_state = (s.cyc_counter, s.cyc_prev_op, s.cyc_prev_row, s.cyc_prev_type) if cyc_on else None
    with tracing.span("lexls.b2"):
        # B2 through its module, so that a wrapper set there sees every launch
        out = fused.fused_active_set(A, s.lb, s.ub, s.ctr_type, s.stamp, s.next_stamp, s.x, s.v,
                               s.Ax, s.n_fact, it0, log_state, cyc_state,
                               **active_set_kwargs(struct, params, A.device))
    state = _state_after_b2(s, out, params, final=True)
    if return_factors:
        return state, (out.rpad, out.posf, out.ranks)
    return state


def _final_status(status):
    """The status of a finished call: instances still UNKNOWN ran out of
    factorizations."""
    return torch.where(status == int(TerminationStatus.UNKNOWN),
                       int(TerminationStatus.MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED), status)


def _state_after_b2(s: LexLSIState, out: ActiveSetResult, params: ParametersLexLSI,
                    final: bool) -> LexLSIState:
    """The solver state ``s`` after kernel B2's result ``out``: the
    iterate, the working set and the counters, the log (flags back to
    bool) and the cycling detector with the relaxed bounds when their
    options are on, and the status of a finished call (:func:`_final_status`)
    when ``final``; a paused call's instances keep UNKNOWN."""
    new = {k: getattr(out, k) for k in STEP_FIELDS}
    if final:
        new["status"] = _final_status(out.status)
    if params.log_working_set_enabled:
        new.update({k: getattr(out, k) for k in LOG_FIELDS},
                   log_cycling=out.log_cycling.bool(), log_overflow=out.log_overflow.bool())
    if params.cycling_handling_enabled:
        new.update({k: getattr(out, k) for k in ("lb", "ub") + CYCLING_FIELDS})
    return dataclasses.replace(s, **new)


# ---------------------------------------------------------------------------
# The exact tier, natively batched: kernel B1 factorizes every iteration
# ---------------------------------------------------------------------------


def _lambda_sweep(f, Ag, ctr_type, stamp, params: ParametersLexLSI, kw: dict):
    """Find an active constraint to remove (``lexlsi.py:325-398``): every
    objective's multipliers from the factorization, in one transposed pass
    or, under TIKHONOV_1, one regularized objective at a time
    (``lexlse.objective_sensitivity_regularized``), then the removal
    selection under the step's options ``kw``.  Returns (found, row (-1
    where none), selected value)."""
    if params.regularization_type == RegularizationType.TIKHONOV_1:
        lam_all = torch.stack([lexlse.objective_sensitivity_regularized(f, j)
                               for j in range(len(f.dims))], 1)
    else:
        lam_all = lexlse.sensitivities_all(f)
    return _select_removal(lam_all, ctr_type, stamp, Ag, f.fixed_mask, **kw)


def _instance_alive(s: LexLSIState, max_fact: int):
    return (s.status == int(TerminationStatus.UNKNOWN)) & ((s.it == 0) | (s.n_fact < max_fact))


def _verify_with_f(s: LexLSIState, A, Ag, f, alive, struct: Structure,
                   params: ParametersLexLSI) -> LexLSIState:
    """One active-set iteration of every instance given the factorization
    ``f`` of its current working set (``lexlsi.py:570-720``): solve, step,
    ratio test, removal sweep, then :func:`_commit` with the log and
    cycling handling, and the trace.  With ``use_phase1_v0`` iteration 0
    keeps phase 1's step and runs no removal sweep.  Instances that are
    not ``alive`` keep their state, their trace included."""
    kw = active_set_kwargs(struct, params, A.device)
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
    found_rm, rrow, rval = _lambda_sweep(f, Ag, s.ctr_type, s.stamp, params, kw)
    want_sweep = want_sweep & ~blocking
    do_remove = want_sweep & found_rm
    solved = want_sweep & ~found_rm
    new, _, _ = _commit(
        s, alive, dx, dv, Adx, alpha, brow, btype, blocking, rrow, do_remove, solved,
        log=((_log_row_table(struct.dims, A.device), rval, f.total_rank)
             if params.log_working_set_enabled else None),
        cycling=((params.cycling_max_counter, params.cycling_relax_step)
                 if params.cycling_handling_enabled else None))

    # per-iteration trace (outputStuff, lexlsi.h:1272-1379): entry it, or
    # the last one once the budget's entries are spent
    tcap = s.trace_x.shape[1]
    if tcap:
        at = alive[:, None] & (torch.arange(tcap, device=A.device)
                               == s.it.clamp(max=tcap - 1)[:, None])
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
    return dataclasses.replace(s, **new)


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
    kw = active_set_kwargs(struct, params, A.device)
    while True:
        alive = _instance_alive(s, max_fact)
        if not bool(alive.any()):
            break
        Ag, bg, fixed_mask, fixed_val = _masked_general(A, s.lb, s.ub, s.ctr_type, **kw)
        f = _factorize_masked(Ag, bg, fixed_mask, fixed_val, struct, params, reg)
        s = _verify_with_f(s, A, Ag, f, alive, struct, params)
    return dataclasses.replace(s, status=_final_status(s.status))


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
    kw = active_set_kwargs(struct, params, A.device)
    Ag, bg, fixed_mask, fixed_val = _masked_general(A, lb, ub, ctr_type, **kw)
    f = _factorize_masked(Ag, bg, fixed_mask, fixed_val, struct, params,
                          _reg_factors(reg, params, A))
    lam = _row_multipliers(lexlse.sensitivities_all(f), Ag, fixed_mask, **kw)  # (B, p, m)
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
