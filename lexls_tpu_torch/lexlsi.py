"""The primal active-set solver's whole-solve tier, batched (LexLSI).

Counterpart of the parts of ``lexls_tpu/lexlsi.py`` that the fused
sequence runs: the static ``Structure``, the solver state, phase 1
(``_initial_state``, ``lexlsi.py:472-551``), the pieces the tracker
shares with it (``_masked_general``, ``_form_step``) and the whole-solve
tier (``solve_core_fused``/``_fused_tail``, ``lexlsi.py:844-1050``), whose
active-set loop is kernel B2 (:mod:`lexls_tpu_torch.ops.fused`).

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

from .types import (
    CtrType,
    LexLSError,
    ParametersLexLSI,
    RegularizationType,
    TerminationStatus,
)


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
    """Batched solver state: float (B, n) or (B, m), int32 (B, m) or (B,)."""

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


def _initial_state(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0,
                   struct: Structure, params: ParametersLexLSI,
                   x_guess_specified: bool, v0_specified: bool) -> LexLSIState:
    """Phase 1 (``lexlsi.h:816-869``) without ``use_phase1_v0``: initial x
    (a cold factorization + basic solve, through kernel B1, unless a guess
    is given), v, working set and step."""
    from . import lexlse
    from .ops import factorize_fast_batched

    B, m, n = A.shape
    dev = A.device
    ctr_type, stamp, next_stamp = ctr_type0, stamp0, next_stamp0
    # hot_start_related_tests (lexlsi.h:758-793): v0 needs x_guess
    if v0_specified and not x_guess_specified:
        v0_specified = False

    if x_guess_specified:
        x = x0
    else:
        Ag, bg, fixed_mask, fixed_val = _masked_general(A, lb, ub, ctr_type, struct)
        f0 = factorize_fast_batched(Ag, bg, struct.lexlse_dims, params.lexlse_parameters(),
                                    fixed_mask=fixed_mask, fixed_val=fixed_val)
        x = lexlse.solve(f0)
    Ax = _matvec(A, x)
    if v0_specified:
        v = v0
    else:
        if x_guess_specified:
            ctr_type, stamp, next_stamp = _form_initial_working_set(
                ctr_type, stamp, next_stamp, Ax, lb, ub, params)
            if struct.simple_bounds and params.modify_x_guess_enabled:
                x = _modify_x_guess(x, ctr_type, lb, ub, struct)
                Ax = _matvec(A, x)
        v = _initialize_v0(ctr_type, Ax, lb, ub, params)
    # dx of iteration 0 is recomputed by the loop body itself
    dx = torch.zeros(B, n, dtype=A.dtype, device=dev)
    Adx, dv = _form_step(A, lb, ub, ctr_type, Ax, v, dx)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    return LexLSIState(
        x=x, v=v, dx=dx, dv=dv, Ax=Ax, Adx=Adx,
        ctr_type=ctr_type, stamp=stamp, next_stamp=next_stamp, lb=lb, ub=ub,
        it=zero, n_act=zero, n_deact=zero, n_fact=zero + 1,
        status=torch.full((B,), int(TerminationStatus.UNKNOWN), dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# The whole-solve tier
# ---------------------------------------------------------------------------


def _check_fused_supported(params: ParametersLexLSI) -> None:
    if params.regularization_type != RegularizationType.NONE:
        raise LexLSError("solve_core_fused: regularization is not ported")
    if params.trace_enabled or params.use_phase1_v0:
        raise LexLSError("solve_core_fused: trace/use_phase1_v0 are not ported")
    if params.log_working_set_enabled or params.cycling_handling_enabled:
        raise LexLSError("solve_core_fused: working-set log and cycling handling are not ported")


def solve_core_fused(
    A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, reg,
    struct: Structure, params: ParametersLexLSI,
    x_guess_specified: bool, v0_specified: bool, return_factors: bool = False,
):
    """Whole-solve tier (``lexlsi.py:844-891``): phase 1 in torch, then
    the entire active-set loop in kernel B2.  All arrays carry a leading
    batch axis except ``reg`` (per-level regularization factors, unused
    since regularization is not ported).  With ``return_factors`` returns
    ``(state, (rpad, posf, ranks))``, the final factorization that
    :func:`lexls_tpu_torch.tracker.bootstrap_carried` takes.  Raises
    ``LexLSError`` for options the port does not support."""
    _check_fused_supported(params)
    full_fp32()
    A, lb, ub = A.contiguous(), lb.contiguous(), ub.contiguous()
    s = _initial_state(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0,
                       struct, params, x_guess_specified, v0_specified)
    return _fused_tail(A, s, struct=struct, params=params, return_factors=return_factors)


@functools.lru_cache(maxsize=64)
def _sweep_tables(struct: Structure, device: torch.device):
    """(prio, elig), each (p, m) int32 on ``device``: the λ-sweep visit
    priorities and eligibility per lexlse objective, made once per
    (structure, device) rather than copied to the device at every step."""
    p = len(struct.lexlse_dims)
    prio = np.stack([struct.sweep_priority(j) for j in range(p)])
    elig = np.stack([struct.sweep_eligible(j) for j in range(p)]).astype(np.int32)
    return torch.as_tensor(prio, device=device), torch.as_tensor(elig, device=device)


def active_set_kwargs(struct: Structure, params: ParametersLexLSI, device) -> dict:
    """Keyword arguments of kernel B2 (and of its plain version) for a
    structure and parameters: level sizes, tolerances, and the λ-sweep
    tables of :func:`_sweep_tables`."""
    prio, elig = _sweep_tables(struct, torch.device(device))
    return dict(
        dims=struct.lexlse_dims, d0=struct.d0,
        var_idx=struct.var_idx if struct.simple_bounds else (), prio=prio, elig=elig,
        tol_ld=params.tol_linear_dependence, tol_feas=params.tol_feasibility,
        tol_wrong=params.tol_wrong_sign_lambda, tol_correct=params.tol_correct_sign_lambda,
        max_fact=params.max_number_of_factorizations,
        deact_first=params.deactivate_first_wrong_sign)


def _fused_tail(A, s: LexLSIState, it0=None, *, struct: Structure, params: ParametersLexLSI,
                return_factors: bool = False):
    """Run the whole-solve active-set loop (kernel B2) from a phase-1
    state ``s``, or from a mid-solve state with per-instance iteration
    counters ``it0`` (``lexlsi.py:915-1050`` without compaction: a CUDA
    block per instance does not wait for the slowest instance of a tile,
    so the trajectory is the same without it).  Instances still UNKNOWN
    afterwards ran out of factorizations."""
    from .ops.fused import fused_active_set

    out = fused_active_set(A, s.lb, s.ub, s.ctr_type, s.stamp, s.next_stamp, s.x, s.v,
                           s.Ax, s.n_fact, it0, **active_set_kwargs(struct, params, A.device))
    status = torch.where(out.status == int(TerminationStatus.UNKNOWN),
                         int(TerminationStatus.MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED),
                         out.status).to(torch.int32)
    state = dataclasses.replace(
        s, x=out.x, v=out.v, dx=out.dx, dv=out.dv, Ax=out.Ax, Adx=out.Adx,
        ctr_type=out.ctr_type, stamp=out.stamp, next_stamp=out.next_stamp,
        it=out.it, n_act=out.n_act, n_deact=out.n_deact, n_fact=out.n_fact,
        status=status)
    if return_factors:
        return state, (out.rpad, out.posf, out.ranks)
    return state
