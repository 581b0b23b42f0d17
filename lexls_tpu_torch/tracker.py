"""Cross-solve warm-start tracker: the carried factorization.

Counterpart of ``lexls_tpu/tracker.py``, for regularization NONE,
TIKHONOV and TIKHONOV_CG.
Consecutive problems of a warm-started sequence differ by a small drift,
so iteration 0 of solve t+1 factorizes almost the same matrix as the last
iteration of solve t.  Instead of rebuilding the column-pivoted l-QR (the
serial pivot chain inside kernel B2), a tracker trip re-factorizes with
the CARRIED pivot order:

* ``M = B_P · Rinv_old`` (the drifted pivot block times the carried inverse
  triangular factor) is near-orthonormal under drift; closed-form rank-1
  absorption of a pending working-set change plus a few first-order
  triangular passes re-orthonormalize it, all as batched matmuls;
* the rank pattern is verified afterwards: the orthogonality certificate,
  the pivots' prefix norms and the trailing column norms play the roles of
  the greedy panel's own acceptance rules;
* an instance whose carry is accepted takes one reference active-set step
  per trip; one whose carry is rejected (or that is still alive when
  ``loop_cap`` trips are done) continues in kernel B2 from its current
  state, through the per-instance ``it0`` handover; under regularization
  (which the kernel does not run) in the exact tier instead.

The JAX package's ``lax.while_loop`` over trips is a Python loop here
whose condition reads ``alive.any()`` on the host: one synchronisation per
trip after the first, plus one before the handover.  NaN is a signal: a
downdate that destroys rank gives a NaN certificate, which compares false
against ``cert_tol``; state is therefore gated by ``torch.where``, never
by multiplying with a mask.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .lexlsi import (
    LexLSIState,
    Structure,
    _check_blocking,
    _exact_tail,
    _factorize_masked,
    _form_step,
    _fused_tail,
    _initial_state,
    _instance_alive,
    _masked_general,
    _reg_factors,
    _select_removal,
    _verify_with_f,
    active_set_kwargs,
    full_fp32,
)
from .ops.fused import INT_MAX, _kmax
from .ops.tri import tri_inv_upper
from .regularization import _masked_chol_solve, cgls_tikhonov
from .types import CtrType, LexLSError, ParametersLexLSI, RegularizationType, TerminationStatus

_UNKNOWN = int(TerminationStatus.UNKNOWN)


class Carried(NamedTuple):
    """Carried factorization of the previous solve's final working set.

    ``rinv``  (B, p, K, K): per level, R^-1 in pivot order (rows and
    columns at or beyond the level's rank are zero);
    ``pos``   (B, n) int32: final virtual column positions (pos[c] is the
    pivot slot of physical column c; slots are numbered in factorization
    order across levels);
    ``ranks`` (B, p) int32: per-level realized ranks."""

    rinv: torch.Tensor
    pos: torch.Tensor
    ranks: torch.Tensor


def kmax_of(struct: Structure) -> int:
    return _kmax(struct.lexlse_dims, struct.n_var)


def default_cert_tol(dtype) -> float:
    """Certificate tolerance by dtype (``tracker.py:80-91``): it is the
    accuracy contract of an accepted carry, 1e-3 for float32 and narrower
    types, 1e-9 for float64 (two first-order passes contract 1e-3 drift to
    about 1e-12, so float64 carries still pass)."""
    return 1e-3 if torch.finfo(dtype).bits <= 32 else 1e-9


def bootstrap_carried(factors: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> Carried:
    """The carried state from kernel B2's factor export
    (``solve_core_fused(..., return_factors=True)``): invert the per-level
    triangular R blocks, padded with the identity at and beyond the rank
    (``tracker.py:94-107``)."""
    rpad, pos, ranks = factors
    K = rpad.shape[-1]
    jm = torch.arange(K, device=rpad.device)
    live = jm < ranks[..., None]                              # (B, p, K)
    live2 = live[..., :, None] & live[..., None, :]
    eye = torch.eye(K, dtype=rpad.dtype, device=rpad.device)
    r_safe = torch.where(live2, torch.triu(rpad), eye)
    rinv = torch.where(live2, tri_inv_upper(r_safe), 0.0)
    return Carried(rinv=rinv, pos=pos, ranks=ranks)


def carried_from_lexqr(f, struct: Structure) -> Carried:
    """The carried state from a batched l-QR (``tracker.py:110-147``): the
    per-level R blocks read from the physicalized LOD (column q holds
    pivot slot q), inverted.  Used by the regularized cold bootstrap,
    whose first iteration runs on the exact tier."""
    n = struct.n_var
    B = f.lod.shape[0]
    K = kmax_of(struct)
    dev, dtype = f.lod.device, f.lod.dtype
    iota_k = torch.arange(K, device=dev)
    rpads = []
    fr = 0
    for k, dim in enumerate(struct.lexlse_dims):
        rp = torch.zeros(B, K, K, dtype=dtype, device=dev)
        Kl = min(dim, n)
        if Kl:
            cols = (f.first_col[:, k, None] + iota_k).clamp(max=n - 1).long()
            rows = f.lod[:, fr:fr + Kl, :n].gather(2, cols[:, None, :].expand(B, Kl, K))
            rp[:, :Kl] = torch.where((iota_k < f.ranks[:, k, None])[:, None, :], rows, 0.0)
        rpads.append(rp)
        fr += dim
    iota_n = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    pos = torch.zeros(B, n, dtype=torch.int32, device=dev).scatter(1, f.perm.long(), iota_n)
    return bootstrap_carried((torch.stack(rpads, 1), pos, f.ranks))


def _orthonormalize_z(G, live2, passes: int, us=()):
    """Z (upper triangular) with (MZ)^T (MZ) = I given G = M^T M, without
    a Cholesky factorization, and an orthogonality certificate
    (``tracker.py:150-233``).

    * analytic rank-1 pre-step: G = I ± u u^T + O(drift) for a level
      whose row was activated or removed; with t_j = 1 ± sum_{i<=j} u_i^2
      and t0 its shifted prefix, Z1 = diag(sqrt(t0/t)) ∓ triu(u w^T, 1),
      w = ±u / sqrt(t t0).  A downdate that destroys rank drives some
      t_j <= 0, the square root gives NaN and the certificate fails.
    * first-order triangular passes: for the remaining E = Gz - I,
      Zi = I - (triu(E, 1) + diag(E)/2) contracts E quadratically.

    ``live2`` (B, K, K) is 1 on the live block.  ``us`` is a sequence of
    ``(u (B, K), s (B, 1))`` rank-1 terms with sign s, applied one after
    the other, each u given in the original carried frame.  Returns
    ``(Z, cert)`` with cert = max |Z^T G Z - I| of shape (B,)."""
    K = G.shape[-1]
    eye = torch.eye(K, dtype=G.dtype, device=G.device)
    on = live2 > 0
    Gz = torch.where(on, G, eye)
    if us:
        Z = None
        tiny = torch.finfo(G.dtype).tiny
        for u_i, s_i in us:
            if Z is not None:
                # express in the current (partially absorbed) frame
                u_i = torch.einsum("...ij,...i->...j", Z, u_i)
            t = 1.0 + s_i * torch.cumsum(u_i * u_i, -1)          # (B, K)
            t0 = torch.cat([torch.ones_like(t[..., :1]), t[..., :-1]], -1)
            # NaN on t <= 0 (rank loss) is wanted: the certificate fails
            dinv = torch.sqrt(t0 / t)
            w = u_i / torch.sqrt((t * t0).abs() + tiny) * torch.sign(t * t0)
            Zi = eye * dinv[..., None, :] - s_i[..., None] * torch.triu(
                u_i[..., :, None] * w[..., None, :], 1)
            Zi = torch.where(on, Zi, eye)
            Z = Zi if Z is None else torch.where(on, Z @ Zi, eye)
        Gz = torch.where(on, Z.transpose(-1, -2) @ Gz @ Z, eye)
    else:
        Z = eye.expand(G.shape)
    for _ in range(max(1, passes)):
        E = Gz - eye
        Zi = eye - (torch.triu(E, 1) + 0.5 * E * eye)
        Z = torch.where(on, Z @ Zi, 0.0)
        Gz = torch.where(on, Zi.transpose(-1, -2) @ Gz @ Zi, eye)
    cert = (Gz - eye).abs().amax((-2, -1))
    return Z, cert


@functools.lru_cache(maxsize=64)
def _level_layout(struct: Structure, device: torch.device):
    """(offsets, lvl_map): first general row of each level, and the level
    of each general row as a (mg,) long tensor on ``device``."""
    offsets = [int(o) for o in np.cumsum((0,) + struct.lexlse_dims[:-1])]
    lvl_map = np.zeros(max(struct.m - struct.d0, 1), np.int64)
    for k, (fr, dim) in enumerate(zip(offsets, struct.lexlse_dims)):
        lvl_map[fr:fr + dim] = k
    return offsets, torch.as_tensor(lvl_map, device=device)


def _row_level(row_hot_g, struct: Structure):
    """Level of the general row that the one-hot ``row_hot_g`` (B, mg)
    selects (0 where it selects none)."""
    _, lvl_map = _level_layout(struct, row_hot_g.device)
    return (row_hot_g * lvl_map.to(row_hot_g.dtype)).sum(1).round().to(torch.int32)


def _delete_last_pivot(pos, ranks, row_hot_g, struct: Structure):
    """Carried-state bookkeeping for a committed removal: drop the LAST
    pivot of the removed row's level (``tracker.py:280-317``).

    Keeping the stale pivot would make the next trip's closed-form
    downdate singular by construction.  Deleting the last slot keeps
    ``pos`` consistent with one list deletion: every later position shifts
    down and the deleted pivot's column goes to position n-1.  If the
    removal did not drop the true rank, the greedy extension re-adds the
    best pivot next trip.  ``row_hot_g`` (B, mg) is the one-hot of the
    removed general row; all-zero rows mean no removal."""
    p = len(struct.lexlse_dims)
    n = struct.n_var
    is_gen = row_hot_g.sum(1) > 0
    lv = _row_level(row_hot_g, struct)
    onehot_lv = torch.arange(p, device=pos.device) == lv[:, None]      # (B, p)
    rank_lv = torch.where(onehot_lv, ranks, 0).sum(1, dtype=torch.int32)
    can_del = is_gen & (rank_lv > 0)
    fcs = torch.cumsum(ranks, 1, dtype=torch.int32) - ranks
    fc_lv = torch.where(onehot_lv, fcs, 0).sum(1, dtype=torch.int32)
    del_slot = fc_lv + rank_lv - 1
    ranks = ranks - (onehot_lv & can_del[:, None]).to(torch.int32)
    sel_del = (pos == del_slot[:, None]) & can_del[:, None]
    shift = (pos > del_slot[:, None]) & can_del[:, None]
    pos = torch.where(sel_del, n - 1, pos - shift.to(torch.int32)).to(torch.int32)
    return pos, ranks


class _Change(NamedTuple):
    """The one constraint row whose activation state changed since the
    carried factorization: its coefficients with the fixed columns zeroed
    (B, n), its one-hot over the general rows (B, mg), its level (B, 1)
    int32 (-1 none), the Gram sign (B, 1) (+1 activated, -1 removed), and
    for removals the change's Gauss elimination column over the general
    rows (B, mg) and its W row (B, n+1), saved by the committing trip."""

    a_row: torch.Tensor
    row_hot: torch.Tensor
    lv: torch.Tensor
    sgn: torch.Tensor
    c_rm: torch.Tensor
    w_rm: torch.Tensor


class _Level(NamedTuple):
    """One level of a carried re-factorization: slot -> column one-hot
    (B, K, n), orthonormal basis Q (B, dim, K), R-frame rows W (B, K, n+1),
    the refreshed inverse R (B, K, K), the Gauss multipliers of the rows
    below (B, rows below, K), the R-frame rhs, the level's rhs, and the
    certified noise floor of its multipliers (B,)."""

    hot: torch.Tensor
    Q: torch.Tensor
    W: torch.Tensor
    rinv: torch.Tensor
    Lp: torch.Tensor
    c: torch.Tensor
    b: torch.Tensor
    lam_floor: torch.Tensor


def _damp_level(W, nsb, hot, rinv, pos, fc_k, rank_k, factor, params: ParametersLexLSI):
    """Per-level Tikhonov damping in the carried frame
    (``tracker.py:706-766``, reference ``regularize_tikhonov_1``,
    ``lexlse.h:1700-1763``): the R-frame rhs head of the W rows becomes
    [R, T] y* with y* the damped least-squares solution over the remaining
    variables, coupled through the accumulated null space ``nsb`` (B, n,
    n+1), physical on both axes.  The damped problem does not depend on
    the orthonormal frame of the pivot block, so it gives the exact tier's
    y*.  Then the null space accumulates the level with the damped rhs.
    Returns (W, nsb)."""
    B, K, np1 = W.shape
    n = np1 - 1
    dtype = W.dtype
    rows_live = torch.arange(K, device=W.device) < rank_k[:, None]
    act = (pos >= fc_k[:, None]).to(dtype)
    elim = (pos < fc_k[:, None]).to(dtype)
    A1 = W[:, :, :n] * act[:, None, :]
    Sm = nsb[:, :, :n] * elim[:, :, None] * act[:, None, :]
    s_vec = nsb[:, :, n] * elim
    c_orig = W[:, :, n]
    # the damped solves are the exact tier's (tracker.py:320-392)
    if params.regularization_type == RegularizationType.TIKHONOV_CG:
        y = cgls_tikhonov(A1, Sm, s_vec, c_orig * rows_live.to(dtype), factor, act,
                          params.max_number_of_CG_iterations)
    else:
        mu = factor * factor
        eye = torch.eye(n, dtype=dtype, device=W.device)
        D = A1.transpose(1, 2) @ A1 + mu * (Sm.transpose(1, 2) @ Sm) + mu * eye
        d = torch.einsum("bkn,bk->bn", A1, c_orig) + mu * torch.einsum("brn,br->bn", Sm, s_vec)
        y = _masked_chol_solve(D, d, act > 0)
    c_new = torch.einsum("bkn,bn->bk", A1, y)
    do_reg = (factor != 0.0) & (rank_k > 0)
    c_reg = torch.where(do_reg[:, None] & rows_live, c_new, c_orig)
    W = torch.cat([W[:, :, :n], c_reg[:, :, None]], 2)
    # the new rows of the basis at the pivot columns hold [S_prev_R + I]
    # R^-1; the trailing columns and the rhs take the Gauss-style update
    end_col = (fc_k + rank_k)[:, None]
    SR = torch.einsum("brn,bkn->brk", nsb[:, :, :n] * elim[:, :, None], hot)
    left = (SR + hot.transpose(1, 2)) @ rinv
    trail_p1 = torch.cat([(pos >= end_col).to(dtype), torch.ones(B, 1, dtype=dtype,
                                                                 device=W.device)], 1)
    Up = W * rows_live[:, :, None].to(dtype) * trail_p1[:, None, :]
    ns_upd = nsb - (left @ Up) * trail_p1[:, None, :]
    pivcol = (pos >= fc_k[:, None]) & (pos < end_col)
    left_scat = torch.einsum("brk,bkn->brn", left, hot)
    ns_upd = torch.cat([torch.where(pivcol[:, None, :], left_scat, ns_upd[:, :, :n]),
                        ns_upd[:, :, n:]], 2)
    return W, torch.where((rank_k > 0)[:, None, None], ns_upd, nsb)


def _factorize_carried(Ag, bg, rinv, pos, ranks, struct: Structure, params: ParametersLexLSI,
                       *, ns_iters: int, cert_tol: float, ext_steps: int,
                       chg: Optional[_Change] = None, reg_factors=None, want_why: bool = False):
    """Re-factorize the masked staircase with the carried pivot order,
    absorbing rank growth by greedy pivot extension (``tracker.py:395-814``).

    Per level: re-orthonormalize the carried pivot block, run up to
    ``ext_steps`` greedy extension steps with the reference's own pivot
    rule (largest trailing column norm >= tol, smallest position on ties,
    ``lexlse.h:205-217``), refine the inverse by one Newton step against
    the freshly measured R, and eliminate the rows below.  Acceptance per
    instance needs the certificate, every pivot's prefix norm above a
    quarter of the tolerance, and no trailing column norm above the
    tolerance left.

    With ``chg`` the changed level absorbs the rank-1 Gram spike in closed
    form, and each level below absorbs the rank-1 change of its Gauss
    elimination, s(g v^T + v g^T) - beta v v^T, as three signed rank-1
    terms with geometric-mean balancing.

    With ``reg_factors`` (p,), one factor for each level, every level is
    damped (:func:`_damp_level`) before it eliminates the rows below.

    With ``want_why`` it also keeps, per instance, why the carry was
    rejected (``tracker.py:465-699``): at level k the bit ``1 << 3k`` when
    the certificate failed, ``2 << 3k`` the pivot norms, ``4 << 3k`` the
    trailing columns.

    Returns ``(ok (B,), levels, fcs (B, p), pos, ranks, rinv, why)`` with one
    :class:`_Level` (or None for an empty level) per level, and ``why``
    (B,) int32, or None without ``want_why``."""
    dims = struct.lexlse_dims
    n = struct.n_var
    B = Ag.shape[0]
    dtype, dev = Ag.dtype, Ag.device
    K = rinv.shape[-1]
    tol_ld = params.tol_linear_dependence
    offsets, _ = _level_layout(struct, dev)
    eps = torch.finfo(dtype).eps

    # rows above the current level are never read again
    rest = torch.cat([Ag, bg[:, :, None]], 2)                    # (B, mg, n+1)
    iota_k = torch.arange(K, device=dev)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    why = torch.zeros(B, dtype=torch.int32, device=dev) if want_why else None

    def reject(ok, passed, bit):
        nonlocal why
        if want_why:
            why = why | (~passed).to(torch.int32) * bit
        return ok & passed

    levels, rinv_out, fcs_list, ranks_out = [], [], [], []
    fc_k = torch.zeros(B, dtype=torch.int32, device=dev)
    eye = torch.eye(K, dtype=dtype, device=dev)
    if chg is not None:
        # the changed pivot's elimination column and W row: seeded from the
        # removal carry, overwritten at an activation's level by the
        # extension pivot
        c_glob, w_cur = chg.c_rm, chg.w_rm
    if reg_factors is not None:
        nsb = torch.zeros(B, n, n + 1, dtype=dtype, device=dev)
    for k, (fr, dim) in enumerate(zip(offsets, dims)):
        fcs_list.append(fc_k)
        if dim == 0:
            levels.append(None)
            rinv_out.append(torch.zeros(B, K, K, dtype=dtype, device=dev))
            ranks_out.append(torch.zeros(B, dtype=torch.int32, device=dev))
            continue
        rank_k = ranks[:, k]
        live = iota_k < rank_k[:, None]                          # (B, K)
        live2 = live[:, :, None] & live[:, None, :]
        livef = live.to(dtype)
        # one-hot slot -> column map of this level's carried pivots
        hot = ((pos[:, None, :] == (fc_k[:, None] + iota_k)[:, :, None])
               & live[:, :, None]).to(dtype)                     # (B, K, n)

        lvl = rest[:, :dim]                                      # (B, dim, n+1)
        rest = rest[:, dim:]
        P0 = lvl[:, :, :n] @ hot.transpose(1, 2)                 # (B, dim, K)
        rinv_k = rinv[:, k]
        M = P0 @ rinv_k
        G = M.transpose(1, 2) @ M
        Gt = torch.where(live2, G, eye)
        us = ()
        if chg is not None:
            is_lvl = (chg.lv == k).to(dtype)                     # (B, 1)
            aP = torch.einsum("bn,bkn->bk", chg.a_row, hot)
            # masked by the carried live slots: after a pivot deletion the
            # stale rinv column would leak an entry at the dead slot
            u_k = torch.einsum("bk,bkj->bj", aP, rinv_k) * is_lvl * livef
            us = [(u_k, chg.sgn * is_lvl)]
            if k > 0:
                # below-level absorption: zero (and a no-op) unless the
                # change happened above this level
                c_k = c_glob[:, fr:fr + dim]
                w_hot = torch.einsum("bc,bkc->bk", w_cur[:, :n], hot)
                v_b = torch.einsum("bk,bkj->bj", w_hot, rinv_k) * livef
                g_b = torch.einsum("bdk,bd->bk", M, c_k) * livef
                beta = (c_k * c_k).sum(1, keepdim=True)
                tiny = torch.finfo(dtype).tiny
                ng = torch.linalg.vector_norm(g_b, dim=1, keepdim=True)
                nv = torch.linalg.vector_norm(v_b, dim=1, keepdim=True)
                alpha = torch.sqrt((nv + tiny) / (ng + tiny))
                sb = -chg.sgn                 # -1 activation, +1 removal
                r2 = float(np.sqrt(0.5))
                one = torch.ones_like(sb)
                us += [((alpha * g_b + sb * v_b / alpha) * r2, one),
                       ((alpha * g_b - sb * v_b / alpha) * r2, -one),
                       (torch.sqrt(beta) * v_b, -one)]
        Z, cert = _orthonormalize_z(Gt, live2, ns_iters, us=us)
        ok = reject(ok, cert < cert_tol, 1 << (3 * k))
        # certified noise floor of this level's multipliers: the own-level
        # residual Q c - b carries about cert·|b| of frame error plus plain
        # roundoff; entries below it are noise on structurally zero
        # residuals and would falsely mark rows CORRECT_SIGN
        bmax = lvl[:, :, n].abs().amax(1)
        lam_floor = (8.0 * cert + 64.0 * eps) * bmax
        MR = torch.cat([M, rinv_k], 1) @ Z                       # (B, dim+K, K)
        Q, rinv_new = MR[:, :dim], MR[:, dim:]
        W = Q.transpose(1, 2) @ lvl                              # (B, K, n+1)

        # greedy extension: absorb rank growth with the reference's own
        # pivot rule; the trigger is floored at the downdated norms'
        # cancellation noise
        rank_pre = rank_k
        colnorm0 = (lvl[:, :, :n] * lvl[:, :, :n]).sum(1)
        tol_eff = torch.clamp(64.0 * eps * colnorm0, min=tol_ld)   # (B, n)
        for _ in range(ext_steps):
            cn = colnorm0 - (W[:, :, :n] * W[:, :, :n]).sum(1)
            end_k = fc_k + rank_k
            beyond = pos >= end_k[:, None]
            cn_b = torch.where(beyond & (cn >= tol_eff), cn, -1.0)
            mx = cn_b.amax(1)
            grow = (mx > 0.0) & (rank_k < min(dim, K))
            # smallest position among the max-norm candidates
            cand = beyond & (cn_b == mx[:, None])
            qmin = torch.where(cand, pos, INT_MAX).amin(1)
            sel = cand & (pos == qmin[:, None])                  # (B, n) one-hot
            self_f = sel.to(dtype)
            a_c = torch.einsum("bdn,bn->bd", lvl[:, :, :n], self_f)
            w_c = torch.einsum("bkn,bn->bk", W[:, :, :n], self_f)
            resid = a_c - torch.einsum("bdk,bk->bd", Q, w_c)
            rho2 = (resid * resid).sum(1)
            grow = grow & (rho2 >= tol_ld)
            rho = torch.sqrt(torch.clamp(rho2, min=1e-30))
            q_new = resid / rho[:, None]
            slot = iota_k == rank_k[:, None]                     # (B, K)
            slotf = slot.to(dtype)
            growf = grow.to(dtype)[:, None]
            # Q gains column q_new at slot rank_k
            Q = Q + growf[:, :, None] * q_new[:, :, None] * slotf[:, None, :]
            # R gains column [w_c; rho]: Rinv column = [-Rinv w_c/rho; 1/rho]
            rcol = -torch.einsum("bij,bj->bi", rinv_new, w_c) / rho[:, None]
            rcol = rcol + slotf / rho[:, None]
            rinv_new = rinv_new + growf[:, :, None] * rcol[:, :, None] * slotf[:, None, :]
            # W gains row q_new^T lvl at slot rank_k
            w_new = torch.einsum("bd,bdc->bc", q_new, lvl)
            W = W + growf[:, :, None] * slotf[:, :, None] * w_new[:, None, :]
            # positions: insert sel at slot end_k (list-insertion renumbering)
            shift = (pos >= end_k[:, None]) & (pos < qmin[:, None]) & grow[:, None]
            pos = torch.where(sel & grow[:, None], end_k[:, None],
                              pos + shift.to(torch.int32)).to(torch.int32)
            hot = hot + growf[:, :, None] * slotf[:, :, None] * self_f[:, None, :]
            rank_k = rank_k + grow.to(torch.int32)

        # Newton inverse-refinement against the freshly measured R:
        # rinv_new = rinv_old Z compounds evaluation error over committed
        # trips, W is re-projected from the data every trip, and one step
        # X' = X (2I - R X) squares the carried error
        R_meas = W[:, :, :n] @ hot.transpose(1, 2)
        live_now = iota_k < rank_k[:, None]
        live_now2 = live_now[:, :, None] & live_now[:, None, :]
        R_tri = torch.where(live_now2, torch.triu(R_meas), eye)
        rinv_stab = torch.where(live_now2, rinv_new, eye)
        rinv_new = torch.where(live_now2, rinv_stab @ (2.0 * eye - R_tri @ rinv_stab), 0.0)

        # acceptance, the greedy panel's own rules on the carried factors:
        # (a) every pivot's prefix-downdated norm, 1/diag(Rinv)^2 (Rinv is
        #     upper triangular throughout), stays above the dependence
        #     tolerance, with 4x slack against flapping under drift
        rdiag_inv = torch.diagonal(rinv_new, dim1=1, dim2=2)
        piv_norm2 = torch.where(live_now, 1.0 / torch.clamp(rdiag_inv * rdiag_inv, min=1e-30),
                                torch.inf)
        ok = reject(ok, piv_norm2.amin(1) >= 0.25 * tol_ld, 2 << (3 * k))
        # (b) no trailing column above the tolerance remains, floored at
        #     the cancellation noise and at the frame's certified error
        #     (this doubles as the frame-quality filter that bounds an
        #     accepted carry's x error)
        cn = colnorm0 - (W[:, :, :n] * W[:, :, :n]).sum(1)
        beyond = pos >= (fc_k + rank_k)[:, None]
        tol_chk = torch.maximum(tol_eff, 8.0 * cert[:, None] * colnorm0)
        ok = reject(ok, ~(beyond & (cn >= tol_chk)).any(1), 4 << (3 * k))

        # the multipliers take the UNdamped R-frame rhs: damping rewrites
        # only the sub-rank head (lexlse.h:316-410)
        c_orig = W[:, :, n]
        if reg_factors is not None:
            W, nsb = _damp_level(W, nsb, hot, rinv_new, pos, fc_k, rank_k, reg_factors[k],
                                 params)

        # Gauss elimination of all lower-priority rows (lexlse.h:431-471):
        # L = B_P R^-1; applying the full R-frame rows W cancels the pivot
        # columns exactly
        Lp = (rest[:, :, :n] @ hot.transpose(1, 2)) @ rinv_new
        if rest.shape[1]:
            rest = rest - Lp @ W

        if chg is not None and rest.shape[1]:
            # an activation whose extension added a pivot here: save the
            # exact rank-1 elimination change for the levels below, with
            # z = Q[r, :] the activated row's Q-frame coordinates:
            # delta = (Lp z)(W[slot, :])^T / z_slot
            act_here = (chg.lv[:, 0] == k) & (chg.sgn[:, 0] > 0) & (rank_k > rank_pre)
            sel_new = (iota_k == rank_pre[:, None]).to(dtype)
            z_row = torch.einsum("bd,bdk->bk", chg.row_hot[:, fr:fr + dim], Q)
            zs = (z_row * sel_new).sum(1, keepdim=True)
            inv_zs = torch.where(zs.abs() > 1e-12, 1.0 / zs, 0.0)
            c_col = torch.einsum("bmk,bk->bm", Lp, z_row) * inv_zs
            w_row = torch.einsum("bkc,bk->bc", W, sel_new)
            c_glob = torch.cat([c_glob[:, :fr + dim],
                                torch.where(act_here[:, None], c_col, c_glob[:, fr + dim:])], 1)
            w_cur = torch.where(act_here[:, None], w_row, w_cur)

        levels.append(_Level(hot, Q, W, rinv_new, Lp, c_orig, lvl[:, :, n], lam_floor))
        rinv_out.append(rinv_new)
        ranks_out.append(rank_k)
        fc_k = fc_k + rank_k

    return (ok, levels, torch.stack(fcs_list, 1), pos, torch.stack(ranks_out, 1),
            torch.stack(rinv_out, 1), why)


def _hot_solve(levels, fcs, pos, fixed_mask, fixed_val, struct: Structure):
    """Basic solve through the carried staircase, bottom level up
    (``lexlse.h:1015-1045``); free variables are zero."""
    n = struct.n_var
    x_var = torch.zeros_like(fixed_val)
    for k in range(len(struct.lexlse_dims) - 1, -1, -1):
        if levels[k] is None:
            continue
        L = levels[k]
        trail = (pos >= fcs[:, k][:, None]).to(x_var.dtype)      # (B, n)
        rhs = L.W[:, :, n] - torch.einsum("bkn,bn->bk", L.W[:, :, :n] * trail[:, None, :], x_var)
        y = torch.einsum("bij,bj->bi", L.rinv, rhs)
        x_var = x_var + torch.einsum("bk,bkn->bn", y, L.hot)
    return torch.where(fixed_mask, fixed_val, x_var)


def _hot_lambda(levels, struct: Structure, B: int, dtype, device):
    """All objectives' multipliers from the carried factorization
    (``tracker.py:839-885``), (B, p, mg).

    For objective k the multiplier of level k's own constraints is the
    factorization residual Q c - b on the level's rows; higher objectives
    back-propagate through Q_k and the Gauss L factors, as kernel B2's
    transposed sweep does."""
    dims = struct.lexlse_dims
    p = len(dims)
    offsets, _ = _level_layout(struct, device)
    K = next((L.Q.shape[-1] for L in levels if L is not None), 1)
    zc = [torch.zeros(B, p, K, dtype=dtype, device=device) for _ in range(p)]
    lam_parts = [None] * p
    jvec = torch.arange(p, device=device)[None, :, None]
    for k in range(p - 1, -1, -1):
        fr, dim = offsets[k], dims[k]
        if levels[k] is None:
            lam_parts[k] = torch.zeros(B, p, dim, dtype=dtype, device=device)
            continue
        L = levels[k]
        seg_gt = torch.einsum("bpk,bdk->bpd", zc[k], L.Q)
        seg_kk = torch.einsum("bdk,bk->bd", L.Q, L.c) - L.b
        # below the certified noise floor the residual of a (numerically)
        # exactly solved level is structurally zero
        seg_kk = torch.where(seg_kk.abs() <= L.lam_floor[:, None], 0.0, seg_kk)
        seg = torch.where(jvec == k, seg_kk[:, None, :], seg_gt)
        seg = torch.where(jvec >= k, seg, 0.0)
        lam_parts[k] = seg
        for j in range(k):
            if levels[j] is None:
                continue
            off = fr - (offsets[j] + dims[j])
            zc[j] = zc[j] - torch.einsum("bpd,bdk->bpk", seg, levels[j].Lp[:, off:off + dim])
    return torch.cat(lam_parts, 2)


def _check_tracked_config(params: ParametersLexLSI, reg, name: str) -> None:
    """What the tracker runs, as ``tracker.py:1038-1055``: regularization
    NONE, or TIKHONOV / TIKHONOV_CG with factors and a constant factor;
    no cycling handling, log, trace or ``use_phase1_v0``."""
    rt = params.regularization_type
    if rt not in (RegularizationType.NONE, RegularizationType.TIKHONOV,
                  RegularizationType.TIKHONOV_CG):
        raise LexLSError(f"{name}: only NONE/TIKHONOV/TIKHONOV_CG regularization supported")
    if rt != RegularizationType.NONE:
        if reg is None:
            raise LexLSError(f"{name}: TIKHONOV needs reg factors")
        if params.variable_regularization_factor != 0.0:
            raise LexLSError(f"{name}: variable regularization factor unsupported")
    if (params.cycling_handling_enabled or params.log_working_set_enabled
            or params.trace_enabled or params.use_phase1_v0):
        raise LexLSError(f"{name}: cycling/log/trace/use_phase1_v0 unsupported")


def _where_rows(cond, a, b):
    """Per-instance selection between two tensors with a leading B."""
    return torch.where(cond.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


@dataclasses.dataclass
class _Trip:
    """What one tracker trip hands to the next: the solver state, the
    carried factorization, the instances that left for kernel B2, the
    working-set change the trip committed (one-hot row over all m rows,
    sign, and for a removal its elimination column and W row), and when
    asked why each carry was rejected (:func:`_factorize_carried`)."""

    s: LexLSIState
    rinv: torch.Tensor
    pos: torch.Tensor
    ranks: torch.Tensor
    fall: torch.Tensor
    chg_hot: torch.Tensor
    chg_sign: torch.Tensor
    chg_c: torch.Tensor
    chg_w: torch.Tensor
    why: Optional[torch.Tensor] = None


def _map_rows(fn, *xs):
    """``fn`` over matching tensors of ``xs``: tensors, or solver states,
    trip states, carried factorizations and tuples of them, walked field
    by field (None stays None).  Gathers, scatters and merges of a batch's
    rows go through it."""
    x = xs[0]
    if x is None:
        return None
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _map_rows(fn, *(getattr(y, f.name) for y in xs))
                          for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        parts = [_map_rows(fn, *ys) for ys in zip(*xs)]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return fn(*xs)


def _trip(c: _Trip, A, *, struct: Structure, params: ParametersLexLSI, ns_iters: int,
          cert_tol: float, ext_steps: int, nochg: bool, reg=None,
          want_why: bool = False) -> _Trip:
    """One tracker trip over the batch (``tracker.py:1178-1364``): carried
    re-factorization (damped by the general levels' factors ``reg`` under
    regularization), one reference active-set step, committed only for
    alive instances whose carry was accepted.  ``nochg`` drops the
    change-absorption inputs: valid for the first trip of a warm solve,
    whose carry matches the previous solve's final working set.
    ``want_why`` keeps the rejection reasons in the result's ``why``."""
    B, m, n = A.shape
    d0 = struct.d0
    dtype, dev = A.dtype, A.device
    s = c.s
    max_fact = params.max_number_of_factorizations
    offsets, _ = _level_layout(struct, dev)
    iota_m = torch.arange(m, device=dev)
    alive = _alive(s, c.fall, max_fact)

    Ag, bg, fixed_mask, fixed_val = _masked_general(A, s.lb, s.ub, s.ctr_type, struct)
    # fixed-variable elimination (lexlse.h:132-156): zero the fixed columns
    # and fold their values into the rhs
    Agz = torch.where(fixed_mask[:, None, :], 0.0, Ag)
    bgz = bg - torch.einsum("bmn,bn->bm", Ag, fixed_val)
    if nochg:
        chg = None
    else:
        # the changed row's raw coefficients (a removed row is zero in
        # Agz), its level and Gram sign; simple-bounds changes get level -1
        # and sign 0: no analytic absorption, the certificate decides
        hot_g = c.chg_hot[:, d0:]
        has_g = hot_g.sum(1, keepdim=True)
        a_row = torch.einsum("bm,bmn->bn", hot_g,
                             torch.where(fixed_mask[:, None, :], 0.0, A[:, d0:]))
        lv = torch.where(has_g > 0, _row_level(hot_g, struct)[:, None], -1).to(torch.int32)
        chg = _Change(a_row, hot_g, lv, c.chg_sign * has_g, c.chg_c, c.chg_w)
    ok, levels, fcs, pos_n, ranks_n, rinv_n, why = _factorize_carried(
        Agz, bgz, c.rinv, c.pos, c.ranks, struct, params, ns_iters=ns_iters,
        cert_tol=cert_tol, ext_steps=ext_steps, chg=chg, reg_factors=reg, want_why=want_why)

    x_star = _hot_solve(levels, fcs, pos_n, fixed_mask, fixed_val, struct)
    dx = x_star - s.x
    Adx, dv = _form_step(A, s.lb, s.ub, s.ctr_type, s.Ax, s.v, dx)
    alpha, brow, btype, blocking = _check_blocking(
        s.ctr_type, s.Ax, Adx, s.v, dv, s.lb, s.ub, params.tol_feasibility)

    lam_all = _hot_lambda(levels, struct, B, dtype, dev)
    found_rm, rrow, _ = _select_removal(lam_all, s.ctr_type, s.stamp, Ag, fixed_mask, struct,
                                        params)
    do_remove = ~blocking & found_rm
    solved = ~blocking & ~found_rm

    # working-set update and step (lexlsi.h:1144-1265), committed only for
    # alive instances with an accepted carry
    commit = alive & ok
    cm = commit[:, None]
    at_b = (blocking & commit)[:, None] & (iota_m == brow[:, None])
    at_r = (do_remove & commit)[:, None] & (iota_m == rrow[:, None])
    INACTIVE = int(CtrType.INACTIVE)
    ctr_type = torch.where(at_b, btype[:, None], torch.where(at_r, INACTIVE, s.ctr_type))
    stamp = torch.where(at_b, s.next_stamp[:, None], torch.where(at_r, -1, s.stamp))
    # gate by selection, never by multiplication: a rejected carry may
    # carry NaNs, and 0 * NaN would poison the state the fallback resumes
    take = ((alpha > 0.0) & commit)[:, None]
    a1 = alpha[:, None]
    ci = commit.to(torch.int32)
    s_new = dataclasses.replace(
        s,
        x=torch.where(take, s.x + a1 * dx, s.x),
        v=torch.where(take, s.v + a1 * dv, s.v),
        Ax=torch.where(take, s.Ax + a1 * Adx, s.Ax),
        dx=torch.where(cm, dx, s.dx), dv=torch.where(cm, dv, s.dv),
        Adx=torch.where(cm, Adx, s.Adx),
        ctr_type=ctr_type.to(torch.int32), stamp=stamp.to(torch.int32),
        next_stamp=s.next_stamp + (blocking & commit).to(torch.int32),
        it=s.it + ci,
        n_act=s.n_act + (blocking & commit).to(torch.int32),
        n_deact=s.n_deact + (do_remove & commit).to(torch.int32),
        n_fact=s.n_fact + (commit & (s.it > 0)).to(torch.int32),
        status=torch.where(commit & solved, int(TerminationStatus.PROBLEM_SOLVED),
                           s.status).to(torch.int32))

    # a committed removal deletes its level's last carried pivot, and saves
    # the deleted pivot's elimination change (from this trip's factors,
    # before the deletion) for the levels below to absorb next trip:
    # z = Q[r, :] of the removed row, delta = (Lp z)(W[slot, :])^T / z_slot
    rm_hot_g = at_r[:, d0:].to(dtype)
    K = rinv_n.shape[-1]
    iota_k = torch.arange(K, device=dev)
    lv_rm = _row_level(rm_hot_g, struct)
    is_rm = rm_hot_g.sum(1) > 0
    chg_c_n = torch.zeros_like(c.chg_c)
    chg_w_n = torch.zeros_like(c.chg_w)
    for j, (fr_j, dim_j) in enumerate(zip(offsets, struct.lexlse_dims)):
        if levels[j] is None or fr_j + dim_j >= c.chg_c.shape[1]:
            continue
        L = levels[j]
        mask_j = (is_rm & (lv_rm == j))[:, None]
        sel_j = (iota_k == (ranks_n[:, j] - 1)[:, None]).to(dtype)
        z_j = torch.einsum("bd,bdk->bk", rm_hot_g[:, fr_j:fr_j + dim_j], L.Q)
        zs_j = (z_j * sel_j).sum(1, keepdim=True)
        inv_j = torch.where(zs_j.abs() > 1e-12, 1.0 / zs_j, 0.0)
        c_j = torch.einsum("bmk,bk->bm", L.Lp, z_j) * inv_j
        w_j = torch.einsum("bkc,bk->bc", L.W, sel_j)
        chg_c_n[:, fr_j + dim_j:] += torch.where(mask_j, c_j, 0.0)
        chg_w_n = chg_w_n + torch.where(mask_j, w_j, 0.0)
    pos_n, ranks_n = _delete_last_pivot(pos_n, ranks_n, rm_hot_g, struct)

    return _Trip(
        s=s_new,
        rinv=_where_rows(commit, rinv_n, c.rinv),
        pos=torch.where(cm, pos_n, c.pos), ranks=torch.where(cm, ranks_n, c.ranks),
        fall=c.fall | (alive & ~ok),
        # the working-set change this trip applied: the next trip's
        # factorization absorbs it analytically
        chg_hot=(at_b | at_r).to(dtype),
        chg_sign=(blocking & commit).to(dtype)[:, None] - (do_remove & commit).to(dtype)[:, None],
        chg_c=torch.where(cm, chg_c_n, 0.0), chg_w=torch.where(cm, chg_w_n, 0.0), why=why)


def _alive(s: LexLSIState, fall, max_fact: int):
    return (s.status == _UNKNOWN) & ~fall & ((s.it == 0) | (s.n_fact < max_fact))


def _slab_sizes(shrink, B: int, loop_cap: int, debug_fall: bool) -> tuple:
    """The pyramid's slab sizes (``tracker.py:1377-1396``): strictly
    decreasing, positive and below B, trimmed to ``loop_cap - 1`` slab
    trips (the full-width trip is the first of the cap)."""
    if debug_fall and shrink:
        raise LexLSError("debug_fall with shrink unsupported")
    sizes = tuple(int(z) for z in shrink)
    if any(z <= 0 for z in sizes) or any(a <= b for a, b in zip((B,) + sizes, sizes)):
        raise LexLSError(f"shrink sizes must be strictly decreasing and < B: {sizes} (B={B})")
    return sizes[:max(0, loop_cap - 1)] if loop_cap else sizes


def _tracked_tail(A, s0: LexLSIState, carried: Carried, *, struct: Structure,
                  params: ParametersLexLSI, ns_iters: int, cert_tol: float, ext_steps: int,
                  chg0=None, loop_cap: int = 0, trip1_noext: bool = False,
                  stats: Optional[list] = None, reg=None, shrink: tuple = (),
                  handover_slab: int = 0, debug_fall: bool = False):
    """The tracker loop and the kernel handover, from a batched state
    (phase 1 done, or the mid-solve state of the cold bootstrap;
    ``tracker.py:1092-1604``).

    ``chg0`` = optional ``(chg_hot (B, m), chg_sign (B, 1))`` naming the
    one constraint row whose activation state differs between the carried
    factorization and ``s0``'s working set (the cold bootstrap); without
    it the first trip runs with no pending change.  ``loop_cap`` > 0
    bounds the loop to that many trips; instances still alive then finish
    in kernel B2, as do those whose carry was rejected.  Resolved
    instances are parked for that launch through the factorization budget
    (status is not a kernel input), and when every instance resolved the
    kernel is not launched.  With ``reg``, the regularization factors of
    every level (device tensor), the trips damp each general level and the
    instances left over continue in the exact tier (:func:`_exact_tail`)
    with their own counters, their carried factors invalidated (ranks 0:
    they fall back at once in the next solve).

    ``shrink``, strictly decreasing slab sizes below B, runs the loop as a
    pyramid (``tracker.py:1382-1465``): after the full-width trip, for each
    size the alive instances move to the front in stable order, the first
    ``size`` rows are gathered and one trip runs on them if any is alive;
    the smallest slab then loops on.  Alive instances beyond a slab are
    marked fallen and finish in B2, so results do not depend on the sizes.
    The rows scatter back through the inverse order at the end.
    ``handover_slab`` S (0 < S < B, no regularization): when S or fewer
    instances are unresolved, B2 and the factor bootstrap run on a slab of
    S rows, the unresolved first in stable order; above S, at full width
    (``tracker.py:1515-1571``).

    ``stats``, when given, receives one ``(trips, instances handed over)``
    tuple, slab trips counted.  Returns ``(state, carried')``, and with
    ``debug_fall`` (not with ``shrink``) also ``(fall, fall_trip,
    fall_why)`` (``tracker.py:1349-1359``): the instances that left the
    loop unresolved, the trip each fell at times 10 plus the op that trip
    tried to absorb plus 1 (-1 removal, 0 none, 1 activation), and the
    rejection bits of :func:`_factorize_carried`."""
    B, m, n = A.shape
    d0 = struct.d0
    dtype, dev = A.dtype, A.device
    max_fact = params.max_number_of_factorizations
    sizes = _slab_sizes(shrink, B, loop_cap, debug_fall)
    reg_g = None if reg is None else (reg[1:] if struct.simple_bounds else reg)
    kw = dict(struct=struct, params=params, ns_iters=ns_iters, cert_tol=cert_tol, reg=reg_g,
              want_why=debug_fall)

    if chg0 is None:
        chg_hot0 = torch.zeros(B, m, dtype=dtype, device=dev)
        chg_sign0 = torch.zeros(B, 1, dtype=dtype, device=dev)
    else:
        chg_hot0, chg_sign0 = chg0
    c = _Trip(s=s0, rinv=carried.rinv, pos=carried.pos, ranks=carried.ranks,
              fall=torch.zeros(B, dtype=torch.bool, device=dev),
              chg_hot=chg_hot0, chg_sign=chg_sign0,
              chg_c=torch.zeros(B, max(m - d0, 1), dtype=dtype, device=dev),
              chg_w=torch.zeros(B, n + 1, dtype=dtype, device=dev))
    fall_trip = fall_why = torch.zeros(B, dtype=torch.int32, device=dev)
    trips = 0

    def trip(c, A_c, nochg=False, ext=ext_steps):
        nonlocal trips, fall_trip, fall_why
        c_new = _trip(c, A_c, nochg=nochg, ext_steps=ext, **kw)
        trips += 1
        if debug_fall:
            new = c_new.fall & ~c.fall
            op = c.chg_sign[:, 0].round().to(torch.int32)
            fall_trip = torch.where(new, trips * 10 + op + 1, fall_trip).to(torch.int32)
            fall_why = torch.where(new, c_new.why, fall_why)
        return c_new

    # the first trip of a warm solve has no pending change, so its
    # absorption inputs drop out; with trip1_noext its greedy extension
    # too (drift-induced rank growth then fails the trailing-column check
    # and finishes in the kernel)
    nochg = chg0 is None
    c = trip(c, A, nochg=nochg, ext=0 if (nochg and trip1_noext) else ext_steps)
    # the pyramid: each level parks the rows beyond its slab, in the order
    # that put the alive instances first
    parked, A_cur = [], A
    for sz in sizes:
        alive = _alive(c.s, c.fall, max_fact)
        if not bool(alive.any()):
            break
        order = torch.argsort(~alive, stable=True)
        tail = order[sz:]
        # an alive instance beyond the slab finishes in the kernel
        parked.append((order, _map_rows(lambda a: a[tail], c), alive[tail]))
        c, A_cur = _map_rows(lambda a: a[order[:sz]], (c, A_cur))
        c = trip(c, A_cur)
    while (not loop_cap or trips < loop_cap) and bool(_alive(c.s, c.fall, max_fact).any()):
        c = trip(c, A_cur)

    fall = (c.fall | _alive(c.s, c.fall, max_fact)) if loop_cap else c.fall
    s, carried_t = c.s, Carried(rinv=c.rinv, pos=c.pos, ranks=c.ranks)
    for order, t, overflow in reversed(parked):
        # the slab's rows, then the parked ones, back where ``order`` took them from
        s, carried_t, fall = _map_rows(
            lambda h, tl: torch.cat([h, tl]).index_copy(0, order, torch.cat([h, tl])),
            (s, carried_t, fall), (t.s, Carried(t.rinv, t.pos, t.ranks), t.fall | overflow))

    resolved = s.status != _UNKNOWN
    n_unresolved = int((~resolved).sum())
    if stats is not None:
        stats.append((trips, n_unresolved))

    def result(state, car):
        return (state, car, (fall, fall_trip, fall_why)) if debug_fall else (state, car)

    if n_unresolved == 0:
        return result(s, carried_t)
    if reg is not None:
        st_x = _exact_tail(A, s, reg, struct, params)
        carried_x = Carried(rinv=torch.zeros_like(carried_t.rinv),
                            pos=torch.arange(n, dtype=torch.int32, device=dev).expand(B, n),
                            ranks=torch.zeros_like(carried_t.ranks))
        return result(*_map_rows(lambda a, b: _where_rows(resolved, a, b),
                                 (s, carried_t), (st_x, carried_x)))
    return result(*_handover(A, s, carried_t, struct=struct, params=params,
                             handover_slab=handover_slab))


def _handover(A, s: LexLSIState, carried_t: Carried, *, struct: Structure,
              params: ParametersLexLSI, handover_slab: int):
    """Kernel B2 after the tracker loop: the unresolved instances of ``s``
    continue from their current state with their own iteration counters
    (the kernel's restart at zero, so phases sum); the resolved ones are
    parked for the launch through the factorization budget and keep ``s``
    and ``carried_t``.  With 0 < ``handover_slab`` < B and at most that
    many unresolved, B2 and the factor bootstrap run on a slab of S rows,
    the unresolved first in stable order; otherwise at full width
    (``tracker.py:1515-1571``).  Returns ``(state, carried')``."""
    max_fact = params.max_number_of_factorizations
    resolved = s.status != _UNKNOWN
    s_in = dataclasses.replace(
        s, n_fact=torch.where(resolved, max_fact, s.n_fact).to(torch.int32))
    if 0 < handover_slab < A.shape[0] and int((~resolved).sum()) <= handover_slab:
        rows = torch.argsort(resolved, stable=True)[:handover_slab]
        st_k, factors_k = _fused_tail(A[rows], *_map_rows(lambda a: a[rows], (s_in, s.it)),
                                      struct=struct, params=params, return_factors=True)
        st_k, car_k = _map_rows(lambda a, b: a.index_copy(0, rows, b), (s, carried_t),
                                (st_k, bootstrap_carried(factors_k)))
    else:
        st_k, factors_k = _fused_tail(A, s_in, s.it, struct=struct, params=params,
                                      return_factors=True)
        car_k = bootstrap_carried(factors_k)
    state, carried_new = _map_rows(lambda a, b: _where_rows(resolved, a, b),
                                   (s, carried_t), (st_k, car_k))
    return dataclasses.replace(state, n_act=s.n_act + torch.where(resolved, 0, st_k.n_act),
                               n_deact=s.n_deact + torch.where(resolved, 0, st_k.n_deact)), \
        carried_new


def solve_core_tracked(
    A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, carried: Carried,
    struct: Structure, params: ParametersLexLSI,
    ns_iters: int = 2, cert_tol: Optional[float] = None, ext_steps: int = 1,
    loop_cap: int = 0, trip1_noext: bool = False, stats: Optional[list] = None, reg=None,
    shrink: tuple = (), handover_slab: int = 0, debug_fall: bool = False,
):
    """Batched warm solve with the active-set loop on the carried
    factorization (``tracker.py:970-1035``).

    Every trip re-factorizes through the carried pivot order
    (:func:`_factorize_carried`) and applies one reference active-set
    step; an instance leaves the loop when it terminates, exhausts the
    budget or fails verification, and then continues in kernel B2 from
    its current state.  ``x0`` is the previous solve's solution (the guess
    is always specified) and ``carried`` comes from
    :func:`bootstrap_carried` or from this function's second return value.
    ``loop_cap`` > 0 bounds the tracker loop to that many trips.  Same
    configuration envelope as :func:`lexls_tpu_torch.solve_core_fused`,
    plus TIKHONOV and TIKHONOV_CG with the per-level factors ``reg`` (p,):
    the damped solve runs inside every trip, and instances that fall
    continue in the exact tier, since kernel B2 has no regularization.
    ``shrink`` (slab sizes of the pyramid), ``handover_slab`` (B2 on a
    slab) and ``debug_fall`` are :func:`_tracked_tail`'s; results do not
    depend on the slab sizes.  Returns ``(state, carried')``, and with
    ``debug_fall`` also ``(fall, fall_trip, fall_why)``."""
    _check_tracked_config(params, reg, "solve_core_tracked")
    full_fp32()
    if cert_tol is None:
        cert_tol = default_cert_tol(A.dtype)
    A, lb, ub = A.contiguous(), lb.contiguous(), ub.contiguous()
    s0 = _initial_state(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, struct, params,
                        True, False)
    return _tracked_tail(A, s0, carried, struct=struct, params=params, ns_iters=ns_iters,
                         cert_tol=cert_tol, ext_steps=ext_steps, loop_cap=loop_cap,
                         trip1_noext=trip1_noext, stats=stats, reg=_reg_factors(reg, params, A),
                         shrink=shrink, handover_slab=handover_slab, debug_fall=debug_fall)


def solve_core_cold_tracked(
    A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0,
    struct: Structure, params: ParametersLexLSI,
    x_guess_specified: bool = False, v0_specified: bool = False,
    ns_iters: int = 2, cert_tol: Optional[float] = None, ext_steps: int = 1,
    stats: Optional[list] = None, reg=None, debug_fall: bool = False,
):
    """Cold-start batched solve through the tracker loop
    (``tracker.py:1614-1731``).

    No carried state exists at a cold start, so one exact kernel iteration
    runs first (``iter_cap=1``): it factorizes the initial working set with
    the greedy pivoted panel and exports the factors.  Under TIKHONOV or
    TIKHONOV_CG (factors ``reg``), which the kernel does not run, that
    iteration runs on the exact tier (kernel B1) and the carried factors
    come from its factorization (:func:`carried_from_lexqr`); phase 1
    factorizes without the factors there, as the JAX package's does.  The
    tracker loop then continues every remaining iteration, with
    per-instance fallback.  Returns ``(state, carried')``, and with
    ``debug_fall`` also ``(fall, fall_trip, fall_why)``
    (:func:`_tracked_tail`)."""
    from .ops.fused import fused_active_set

    _check_tracked_config(params, reg, "solve_core_cold_tracked")
    full_fp32()
    if cert_tol is None:
        cert_tol = default_cert_tol(A.dtype)
    A, lb, ub = A.contiguous(), lb.contiguous(), ub.contiguous()
    reg = _reg_factors(reg, params, A)
    s = _initial_state(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, struct, params,
                       x_guess_specified, v0_specified)
    if reg is not None:
        Ag, bg, fixed_mask, fixed_val = _masked_general(A, s.lb, s.ub, s.ctr_type, struct)
        f = _factorize_masked(Ag, bg, fixed_mask, fixed_val, struct, params, reg)
        s1 = _verify_with_f(s, A, Ag, f, _instance_alive(s, params.max_number_of_factorizations),
                            struct, params)
        carried0 = carried_from_lexqr(f, struct)
    else:
        out = fused_active_set(A, s.lb, s.ub, s.ctr_type, s.stamp, s.next_stamp, s.x, s.v,
                               s.Ax, s.n_fact, iter_cap=1,
                               **active_set_kwargs(struct, params, A.device))
        # a paused instance keeps status UNKNOWN: the tracker loop takes it on
        s1 = dataclasses.replace(
            s, x=out.x, v=out.v, dx=out.dx, dv=out.dv, Ax=out.Ax, Adx=out.Adx,
            ctr_type=out.ctr_type, stamp=out.stamp, next_stamp=out.next_stamp, it=out.it,
            n_act=out.n_act, n_deact=out.n_deact, n_fact=out.n_fact, status=out.status)
        carried0 = bootstrap_carried((out.rpad, out.posf, out.ranks))

    # the bootstrap factors describe the INITIAL working set, while the
    # bootstrap iteration may have committed one change into s1: hand it to
    # the first trip to absorb, and for a removal delete the carried pivot
    LB, UB = int(CtrType.ACTIVE_LB), int(CtrType.ACTIVE_UB)
    was_act = (s.ctr_type == LB) | (s.ctr_type == UB)
    now_act = (s1.ctr_type == LB) | (s1.ctr_type == UB)
    changed = was_act != now_act
    dtype = A.dtype
    chg_hot0 = changed.to(dtype)
    n_chg = chg_hot0.sum(1, keepdim=True)
    sgn0 = ((now_act & changed).to(dtype).sum(1, keepdim=True)
            - (was_act & changed).to(dtype).sum(1, keepdim=True))
    # iter_cap=1 commits at most one change; zeros mean "the carry matches
    # exactly", and then the certificate decides
    chg_hot0 = torch.where(n_chg <= 1.0, chg_hot0, 0.0)
    chg_sign0 = torch.where(n_chg <= 1.0, sgn0, 0.0)
    rm_hot_g = chg_hot0[:, struct.d0:] * (chg_sign0 < 0).to(dtype)
    pos0, ranks0 = _delete_last_pivot(carried0.pos, carried0.ranks, rm_hot_g, struct)
    carried0 = Carried(rinv=carried0.rinv, pos=pos0, ranks=ranks0)
    return _tracked_tail(A, s1, carried0, struct=struct, params=params, ns_iters=ns_iters,
                         cert_tol=cert_tol, ext_steps=ext_steps,
                         chg0=(chg_hot0, chg_sign0), stats=stats, reg=reg,
                         debug_fall=debug_fall)
