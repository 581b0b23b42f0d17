"""The plain reference that decides ``correct``: a primal active-set solve
of one inequality hierarchy, in NumPy.

A frozen copy of the NumPy oracle beside the JAX package
(``lexls_tpu/oracle/lexlse.py`` and ``lexls_tpu/oracle/lexlsi.py``, with
the enums of ``lexls_tpu/types.py``), cut to what the benchmark's
configurations use: the l-QR with column pivoting and fixed variables, the
basic solve, the multipliers of one objective, and the active-set loop from
a cold start.  Left out: regularization, least-norm solves, the working-set
log, cycling handling, ``use_phase1_v0`` and the hot start.  It imports
NumPy and SciPy only: neither the port nor the JAX package.

Every matrix or vector product goes through :class:`Products`.  With
``precision="float64"`` they are NumPy's products in float64; with
``precision="tf32"`` both operands are first rounded to TF32 (a 10-bit
mantissa, round to nearest even), as a tensor-core product in TF32 rounds
them, and the product is then formed in float64.  That is the control of a
configuration stated as float32 with TF32 off: the reference computed with
TF32 products.  Its accumulation is in float64, more exact than the
card's, so it errs less than a real TF32 run would.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np
import scipy.linalg


class CtrType(enum.IntEnum):
    INACTIVE = 0
    ACTIVE_LB = 1
    ACTIVE_UB = 2
    ACTIVE_EQ = 3
    CORRECT_SIGN_OF_LAMBDA = 4  # internal marker of the multiplier sweep


class TerminationStatus(enum.IntEnum):
    UNKNOWN = -1
    PROBLEM_SOLVED = 0
    PROBLEM_SOLVED_CYCLING_HANDLING = 1
    MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED = 2


ACTIVE_TYPES = (int(CtrType.ACTIVE_LB), int(CtrType.ACTIVE_UB), int(CtrType.ACTIVE_EQ))


@dataclasses.dataclass(frozen=True)
class Params:
    """The tolerances and budget of ``ParametersLexLSI`` that a cold solve
    without regularization reads (lexls ``typedefs.h:268-294``)."""

    max_number_of_factorizations: int = 200
    tol_linear_dependence: float = 1e-12
    tol_wrong_sign_lambda: float = 1e-8
    tol_correct_sign_lambda: float = 1e-12
    tol_feasibility: float = 1e-13
    deactivate_first_wrong_sign: bool = False


@dataclasses.dataclass
class Hierarchy:
    """Stacked levels ``lb <= A x - v <= ub``; with ``var_idx`` the first
    level is simple bounds on those variables (its rows of ``A`` unit
    rows)."""

    A: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    dims: Tuple[int, ...]
    var_idx: Optional[np.ndarray] = None

    @property
    def simple_bounds(self) -> bool:
        return self.var_idx is not None


# ---------------------------------------------------------------------------
# Products, in float64 or with TF32 operands
# ---------------------------------------------------------------------------


def _tf32(a):
    """Round to TF32: float32 with the low 13 mantissa bits rounded away."""
    a32 = np.asarray(a, dtype=np.float32)
    bits = a32.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


class Products:
    """Every matrix or vector product of a solve, in float64 or with both
    operands rounded to TF32 first."""

    def __init__(self, precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}: float64 or tf32")
        self.round = _tf32 if precision == "tf32" else (lambda a: a)

    def mm(self, a, b):
        return np.matmul(self.round(a), self.round(b))

    def outer(self, a, b):
        return np.outer(self.round(a), self.round(b))


F64 = Products()


def _solve_triu_right(B: np.ndarray, R: np.ndarray) -> np.ndarray:
    """L with L @ triu(R) = B."""
    if R.shape[0] == 0:
        return B
    return scipy.linalg.solve_triangular(R.T, B.T, lower=True).T


def _solve_triu_left(R: np.ndarray, y: np.ndarray) -> np.ndarray:
    if R.shape[0] == 0:
        return y
    return scipy.linalg.solve_triangular(R, y, lower=False)


# ---------------------------------------------------------------------------
# Householder primitives (Eigen's conventions, lexls ``lexlse.h:241-246``)
# ---------------------------------------------------------------------------


def _make_householder(x: np.ndarray, pr: Products) -> Tuple[float, float, np.ndarray]:
    """(tau, beta, essential) with (I - tau u u^T) x = beta e1, u = [1; essential]."""
    c0 = x[0]
    tail = x[1:]
    s = float(pr.mm(tail, tail))
    if s == 0.0:
        return 0.0, float(c0), np.zeros_like(tail)
    beta = float(np.sqrt(c0 * c0 + s))
    if c0 >= 0.0:
        beta = -beta
    return float((beta - c0) / beta), beta, tail / (c0 - beta)


def _apply_householder_left(M: np.ndarray, essential: np.ndarray, tau: float,
                            pr: Products) -> None:
    if tau == 0.0:
        return
    u = np.concatenate(([1.0], essential))
    M -= tau * pr.outer(u, pr.mm(u, M))


def _apply_householder_seq_left(V: np.ndarray, h: np.ndarray, vec: np.ndarray,
                                 pr: Products) -> np.ndarray:
    """Q = H_0 ... H_{r-1} applied to a copy of ``vec``, H_{r-1} first."""
    out = vec.copy()
    dim, r = V.shape
    for j in range(r - 1, -1, -1):
        tau = h[j]
        if tau == 0.0:
            continue
        u = np.concatenate(([1.0], V[j + 1:, j]))
        seg = out[j:dim]
        seg -= tau * u * pr.mm(u, seg)
    return out


# ---------------------------------------------------------------------------
# The l-QR (lexls ``lexlse.h:117-506``) and what is read from it
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LexQR:
    lod: np.ndarray         # (m, n+1): factors, rhs in the last column
    hh_scalars: np.ndarray  # (m,)
    perm_cols: np.ndarray   # x_user[perm_cols[j]] = x_pos[j]
    dims: Tuple[int, ...]
    ranks: List[int]
    first_row: List[int]
    first_col: List[int]
    n_var: int
    n_fixed: int
    fixed_values: np.ndarray
    fixed_a: np.ndarray     # original columns of the fixed variables, (m, n_fixed)


def factorize(A, b, dims, tol, fixed_idx=None, fixed_val=None, pr: Products = F64) -> LexQR:
    """Per level a column-pivoted Householder QR over the remaining
    variables, cut at ``tol``, then Gauss elimination of the block below."""
    m, n_var = A.shape
    n_obj = len(dims)
    lod = np.concatenate([A.astype(np.float64, copy=True), b.reshape(-1, 1)], axis=1)
    hh = np.zeros(m)
    perm = np.arange(n_var)
    first_row = list(np.cumsum((0,) + tuple(dims))[:-1].astype(int))
    first_col = [0] * n_obj
    ranks = [0] * n_obj

    n_fixed = 0
    fixed_values = np.zeros(0)
    fixed_a = np.zeros((m, 0))
    if fixed_idx is not None and len(fixed_idx) > 0:
        n_fixed = len(fixed_idx)
        fixed_values = np.asarray(fixed_val, dtype=np.float64).copy()
        fi = np.asarray(fixed_idx, dtype=np.int64).copy()
        for k in range(n_fixed):
            coeff = fi[k]
            perm[[k, coeff]] = perm[[coeff, k]]
            if k != coeff:
                lod[:, [k, coeff]] = lod[:, [coeff, k]]
            for i in range(k + 1, n_fixed):  # a later index that pointed at k now lives at coeff
                if fi[i] == k:
                    fi[i] = coeff
                    break
        lod[:, n_var] -= pr.mm(lod[:, :n_fixed], fixed_values)
        fixed_a = lod[:, :n_fixed].copy()

    col = n_fixed
    if col < n_var:
        norms = np.zeros(n_var)
        terminated = False
        for obj in range(n_obj):
            frow, dim = first_row[obj], dims[obj]
            first_col[obj] = col
            if terminated:
                if obj > 0:
                    first_col[obj] = first_col[obj - 1] + ranks[obj - 1]
                continue
            norms[col:] = (lod[frow:frow + dim, col:n_var] ** 2).sum(axis=0)
            for counter in range(dim):
                row = frow + counter
                rem_rows = dim - counter
                piv = col + int(np.argmax(norms[col:n_var]))
                max_val = float((lod[row:row + rem_rows, piv] ** 2).sum())
                norms[piv] = max_val
                if max_val < tol:
                    break
                if col != piv:
                    lod[:, [col, piv]] = lod[:, [piv, col]]
                    norms[[col, piv]] = norms[[piv, col]]
                perm[[col, piv]] = perm[[piv, col]]
                if rem_rows > 1:
                    tau, beta, ess = _make_householder(lod[row:row + rem_rows, col], pr)
                    lod[row, col] = beta
                    lod[row + 1:row + rem_rows, col] = ess
                    _apply_householder_left(lod[row:row + rem_rows, col + 1:], ess, tau, pr)
                    hh[row] = tau
                col += 1
                if col == n_var:
                    break
                norms[col:n_var] -= lod[row, col:n_var] ** 2
            ranks[obj] = col - first_col[obj]
            rank = ranks[obj]
            if obj < n_obj - 1 and rank > 0:  # Gauss elimination (lexlse.h:431-471)
                below = lod[frow + dim:m, :]
                fc = first_col[obj]
                L = _solve_triu_right(below[:, fc:fc + rank], lod[frow:frow + rank, fc:fc + rank])
                below[:, fc:fc + rank] = L
                below[:, col:] -= pr.mm(L, lod[frow:frow + rank, col:])
            if col == n_var:
                terminated = True
    else:
        first_col = [n_fixed] * n_obj
    return LexQR(lod=lod, hh_scalars=hh, perm_cols=perm, dims=tuple(dims), ranks=ranks,
                 first_row=first_row, first_col=first_col, n_var=n_var, n_fixed=n_fixed,
                 fixed_values=fixed_values, fixed_a=fixed_a)


def solve_basic(f: LexQR, pr: Products = F64) -> np.ndarray:
    """The basic solution, free variables at zero (``lexlse.h:1015-1045``)."""
    n = f.n_var
    x_pos = np.zeros(n)
    x_pos[:f.n_fixed] = f.fixed_values
    acc = 0
    for k in range(len(f.dims) - 1, -1, -1):
        r = f.ranks[k]
        if r == 0:
            continue
        fr, fc = f.first_row[k], f.first_col[k]
        rhs = f.lod[fr:fr + r, n].copy()
        if acc > 0:
            nc = f.first_col[k + 1]
            rhs -= pr.mm(f.lod[fr:fr + r, nc:nc + acc], x_pos[nc:nc + acc])
        x_pos[fc:fc + r] = _solve_triu_left(f.lod[fr:fr + r, fc:fc + r], rhs)
        acc += r
    x = np.zeros(n)
    x[f.perm_cols] = x_pos
    return x


def objective_sensitivity(f: LexQR, j: int, pr: Products = F64) -> Tuple[np.ndarray, np.ndarray]:
    """The multipliers of objective ``j`` over the rows of levels 0..j and
    over the fixed variables (``lexlse.h:770-861``)."""
    n = f.n_var
    lam = np.zeros(sum(f.dims[:j + 1]))
    rhs = np.zeros(sum(f.ranks[:j]) + f.n_fixed)
    fr, fc = f.first_row[j], f.first_col[j]
    dim, r = f.dims[j], f.ranks[j]
    seg = np.zeros(dim)
    seg[r:] = -f.lod[fr + r:fr + dim, n]
    lam[fr:fr + dim] = _apply_householder_seq_left(f.lod[fr:fr + dim, fc:fc + r],
                                                   f.hh_scalars[fr:fr + dim], seg, pr)
    if j > 0:
        rhs[:fc] -= pr.mm(f.lod[fr:fr + dim, :fc].T, lam[fr:fr + dim])
        for k in range(j - 1, -1, -1):
            fr, fc = f.first_row[k], f.first_col[k]
            dim, r = f.dims[k], f.ranks[k]
            seg = np.zeros(dim)
            seg[:r] = rhs[fc:fc + r]
            lam[fr:fr + dim] = _apply_householder_seq_left(f.lod[fr:fr + dim, fc:fc + r],
                                                           f.hh_scalars[fr:fr + dim], seg, pr)
            rhs[:fc] -= pr.mm(f.lod[fr:fr + dim, :fc].T, lam[fr:fr + dim])
    lam_fixed = np.zeros(f.n_fixed)
    if f.n_fixed > 0:
        lam_fixed = -pr.mm(f.fixed_a[:len(lam), :].T, lam)
    return lam_fixed, lam


# ---------------------------------------------------------------------------
# The active-set loop (lexls ``lexlsi.h``), from a cold start
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Result:
    x: np.ndarray
    status: TerminationStatus
    ctr_type: np.ndarray
    n_iterations: int
    n_factorizations: int


class _Solver:
    def __init__(self, prob: Hierarchy, params: Params, pr: Products):
        self.p, self.prm, self.pr = prob, params, pr
        self.m, self.n = prob.A.shape
        self.obj_offset = 1 if prob.simple_bounds else 0
        self.first_row = [int(sum(prob.dims[:k])) for k in range(len(prob.dims))]
        # equalities (lb == ub; a general row also needs a nonzero normal)
        # enter the working set first, in row order (lexlsi.h:367-385)
        eq = np.abs(prob.lb - prob.ub) < 1e-15
        nonzero = (prob.A ** 2).sum(axis=1) > 0
        if prob.simple_bounds:
            nonzero[:prob.dims[0]] = True
        self.ctr_type = np.where(eq & nonzero, int(CtrType.ACTIVE_EQ),
                                 int(CtrType.INACTIVE)).astype(np.int64)
        self.stamp = np.full(self.m, -1, dtype=np.int64)
        n_eq = int((self.ctr_type == int(CtrType.ACTIVE_EQ)).sum())
        self.stamp[self.ctr_type == int(CtrType.ACTIVE_EQ)] = np.arange(n_eq)
        self.next_stamp = n_eq
        self.x = np.zeros(self.n)
        self.dx = np.zeros(self.n)
        self.v = np.zeros(self.m)
        self.dv = np.zeros(self.m)
        self.Ax = np.zeros(self.m)
        self.Adx = np.zeros(self.m)
        self.n_iterations = 0
        self.n_factorizations = 0
        self.status = TerminationStatus.UNKNOWN
        self.f: Optional[LexQR] = None
        self._fixed_rows = np.zeros(0, dtype=np.int64)

    def _rhs(self):
        t = self.ctr_type
        is_ub = (t == int(CtrType.ACTIVE_UB)) | (t == int(CtrType.ACTIVE_EQ))
        return np.where(is_ub, self.p.ub, np.where(t == int(CtrType.ACTIVE_LB), self.p.lb, 0.0))

    def _factorize(self) -> LexQR:
        """The masked equality subproblem at the working set (``lexlsi.h:968-982``)."""
        p = self.p
        active = np.isin(self.ctr_type, ACTIVE_TYPES)
        rhs = self._rhs()
        tol = self.prm.tol_linear_dependence
        if p.simple_bounds:
            d0 = p.dims[0]
            act0 = np.arange(d0)[active[:d0]]
            self._fixed_rows = act0
            gen = slice(d0, self.m)
            self.f = factorize(p.A[gen] * active[gen, None], rhs[gen] * active[gen], p.dims[1:],
                               tol, fixed_idx=p.var_idx[act0], fixed_val=rhs[act0], pr=self.pr)
        else:
            self.f = factorize(p.A * active[:, None], rhs * active, p.dims, tol, pr=self.pr)
        return self.f

    def _activate(self, row: int, t: int) -> None:
        self.ctr_type[row] = t
        self.stamp[row] = self.next_stamp
        self.next_stamp += 1

    def _form_step(self) -> None:
        """``objective.h:288-338``."""
        self.Adx = self.pr.mm(self.p.A, self.dx)
        active = np.isin(self.ctr_type, ACTIVE_TYPES)
        self.dv = -self.v
        self.dv[active] += self.Ax[active] + self.Adx[active] - self._rhs()[active]

    def _phase1(self) -> None:
        """Cold phase 1 (``lexlsi.h:816-869``) and v0 (``objective.h:183-237``)
        with ``set_min_init_ctr_violation``."""
        self.x = solve_basic(self._factorize(), self.pr)
        self.Ax = self.pr.mm(self.p.A, self.x)
        lb, ub, Ax, t = self.p.lb, self.p.ub, self.Ax, self.ctr_type
        v = np.where(Ax <= lb, Ax - lb, np.where(Ax >= ub, Ax - ub, 0.0))
        v = np.where(t == int(CtrType.ACTIVE_EQ), Ax - ub, v)
        self.v = v
        self.dx = np.zeros(self.n)
        self._form_step()
        self.n_factorizations += 1

    def _check_blocking(self) -> Tuple[float, int, int]:
        """Ratio test over the inactive rows (``objective.h:521-578``)."""
        tolf = self.prm.tol_feasibility
        alpha, row, typ = 1.0, -1, int(CtrType.INACTIVE)
        for i in np.nonzero(self.ctr_type == int(CtrType.INACTIVE))[0]:
            den = self.Adx[i] - self.dv[i]
            if den < -tolf:
                t, rhs = int(CtrType.ACTIVE_LB), self.p.lb[i]
            elif den > tolf:
                t, rhs = int(CtrType.ACTIVE_UB), self.p.ub[i]
            else:
                continue
            ratio = max((rhs - self.Ax[i] + self.v[i]) / den, 0.0)
            if ratio < alpha:
                alpha, row, typ = ratio, int(i), t
        return alpha, row, typ

    def _lambda_sweep(self) -> Tuple[bool, int]:
        """An active row to remove (``lexlsi.h:1048-1139``), with the
        CORRECT_SIGN_OF_LAMBDA marks carried across objectives."""
        f, prm, p = self.f, self.prm, self.p
        sense = self.ctr_type.copy()
        d0 = p.dims[0] if p.simple_bounds else 0
        wrong: List[int] = []
        best_val, best_row = 0.0, -1
        for j in range(len(p.dims) - self.obj_offset):
            lam_fixed, lam = objective_sensitivity(f, j, self.pr)
            found = False
            for k in list(range(j, -1, -1)) + ["fixed"]:
                if k == "fixed":
                    rows, vals = self._fixed_rows, lam_fixed
                else:
                    lvl = k + self.obj_offset
                    fr = self.first_row[lvl]
                    rows = np.arange(fr, fr + p.dims[lvl])
                    vals = lam[fr - d0:fr - d0 + p.dims[lvl]]
                for idx, i in enumerate(rows):
                    t = sense[i]
                    if t in (int(CtrType.ACTIVE_EQ), int(CtrType.CORRECT_SIGN_OF_LAMBDA),
                             int(CtrType.INACTIVE)):
                        continue
                    a = -vals[idx] if t == int(CtrType.ACTIVE_LB) else vals[idx]
                    if a > prm.tol_correct_sign_lambda:
                        sense[i] = int(CtrType.CORRECT_SIGN_OF_LAMBDA)
                    elif a < -prm.tol_wrong_sign_lambda:
                        found = True
                        wrong.append(int(i))
                        if a < best_val:
                            best_val, best_row = a, int(i)
            if found:
                break
        if not wrong:
            return False, -1
        if prm.deactivate_first_wrong_sign:
            return True, wrong[int(np.argmin([self.stamp[r] for r in wrong]))]
        return True, best_row

    def _iterate(self) -> None:
        """One active-set iteration (``lexlsi.h:1144-1265``)."""
        if self.n_iterations != 0:
            self.dx = solve_basic(self._factorize(), self.pr) - self.x
            self._form_step()
            self.n_factorizations += 1
        alpha, row, typ = self._check_blocking()
        if row >= 0:
            self._activate(row, typ)
        else:
            alpha = 1.0
            found, rrow = self._lambda_sweep()
            if found:
                self.ctr_type[rrow] = int(CtrType.INACTIVE)
                self.stamp[rrow] = -1
            else:
                self.status = TerminationStatus.PROBLEM_SOLVED
        if alpha > 0.0:
            self.x = self.x + alpha * self.dx
            self.v = self.v + alpha * self.dv
            self.Ax = self.Ax + alpha * self.Adx
        self.n_iterations += 1

    def solve(self) -> Result:
        self._phase1()
        while True:
            self._iterate()
            if self.status == TerminationStatus.PROBLEM_SOLVED:
                break
            if self.n_factorizations >= self.prm.max_number_of_factorizations:
                self.status = TerminationStatus.MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED
                break
        return Result(x=self.x.copy(), status=self.status, ctr_type=self.ctr_type.copy(),
                      n_iterations=self.n_iterations, n_factorizations=self.n_factorizations)


def solve(prob: Hierarchy, params: Params, precision: str = "float64") -> Result:
    """A cold solve of ``prob``, its products in ``precision`` (``float64``
    or ``tf32``)."""
    return _Solver(prob, params, Products(precision)).solve()


def level_residuals(prob: Hierarchy, x: np.ndarray) -> np.ndarray:
    """Per level, the norm of the least v that makes ``x`` feasible:
    each row's distance from A x to [lb, ub], in float64 (a simple-bounds
    level's rows are unit rows of A).  Unique at a lexicographic optimum,
    whichever x attains it."""
    Ax = np.asarray(prob.A, np.float64) @ np.asarray(x, np.float64)
    d = np.maximum(prob.lb - Ax, 0.0) + np.maximum(Ax - prob.ub, 0.0)
    edges = np.cumsum((0,) + tuple(prob.dims))
    return np.array([np.linalg.norm(d[a:b]) for a, b in zip(edges[:-1], edges[1:])])
