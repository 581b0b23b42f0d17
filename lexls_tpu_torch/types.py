"""Enums, solver parameters and problem containers (NumPy only).

A copy of the part of ``lexls_tpu/types.py`` that the port needs, so that
the port imports without JAX (the machine with the GPU has none).  The
enum codes and parameter defaults are identical to the JAX package's,
which ``tests/test_torch_types.py`` checks field by field.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

import numpy as np


class RegularizationType(enum.IntEnum):
    """Mirrors reference ``typedefs.h:32-44`` (same codes)."""

    NONE = 0
    TIKHONOV = 1
    TIKHONOV_CG = 2
    R = 3
    R_NO_Z = 4
    RT_NO_Z = 5
    RT_NO_Z_CG = 6
    TIKHONOV_1 = 7
    TIKHONOV_2 = 8
    TEST = 9


class TerminationStatus(enum.IntEnum):
    """Mirrors reference ``typedefs.h:49-55`` (same codes)."""

    UNKNOWN = -1
    PROBLEM_SOLVED = 0
    PROBLEM_SOLVED_CYCLING_HANDLING = 1
    MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED = 2


class ObjectiveType(enum.IntEnum):
    """Mirrors reference ``typedefs.h:60-64``."""

    GENERAL = 0
    SIMPLE_BOUNDS = 1


class CtrType(enum.IntEnum):
    """Constraint activation types, reference ``typedefs.h:69-76``."""

    INACTIVE = 0
    ACTIVE_LB = 1
    ACTIVE_UB = 2
    ACTIVE_EQ = 3
    CORRECT_SIGN_OF_LAMBDA = 4  # internal marker used during the λ sweep


class OperationType(enum.IntEnum):
    """Mirrors reference ``typedefs.h:537-542``."""

    UNDEFINED = 0
    ADD = 1
    REMOVE = 2


@dataclasses.dataclass(frozen=True)
class ParametersLexLSE:
    """Parameters of the equality solver (reference ``typedefs.h:118-124``)."""

    tol_linear_dependence: float = 1e-12
    max_number_of_CG_iterations: int = 10
    regularization_type: RegularizationType = RegularizationType.NONE
    variable_regularization_factor: float = 0.0


@dataclasses.dataclass(frozen=True)
class ParametersLexLSI:
    """Parameters of the active-set solver (reference ``typedefs.h:268-294``)."""

    max_number_of_factorizations: int = 200

    tol_linear_dependence: float = 1e-12
    tol_wrong_sign_lambda: float = 1e-8
    tol_correct_sign_lambda: float = 1e-12
    tol_feasibility: float = 1e-13

    cycling_handling_enabled: bool = False
    cycling_max_counter: int = 50
    cycling_relax_step: float = 1e-8

    regularization_type: RegularizationType = RegularizationType.NONE
    max_number_of_CG_iterations: int = 10
    variable_regularization_factor: float = 0.0

    modify_x_guess_enabled: bool = False
    modify_type_active_enabled: bool = False
    modify_type_inactive_enabled: bool = False
    set_min_init_ctr_violation: bool = True

    use_phase1_v0: bool = False
    log_working_set_enabled: bool = False

    deactivate_first_wrong_sign: bool = False

    trace_enabled: bool = False

    def lexlse_parameters(self) -> ParametersLexLSE:
        """Forward the shared subset, mirrors reference ``lexlsi.h:325-342``."""
        return ParametersLexLSE(
            tol_linear_dependence=self.tol_linear_dependence,
            max_number_of_CG_iterations=self.max_number_of_CG_iterations,
            regularization_type=self.regularization_type,
            variable_regularization_factor=self.variable_regularization_factor,
        )


class LexLSError(ValueError):
    """Host-side API-misuse error (reference throws ``LexLS::Exception``)."""


@dataclasses.dataclass
class WorkingSetLogEntry:
    """One working-set change of a solve (``typedefs.h:380-432``): the
    constraint as (objective, row within it), its type when added or
    INACTIVE when removed, the step length of an addition or the selected
    multiplier of a removal, the total rank of the iteration's
    factorization, and whether cycling handling flagged it."""

    obj_index: int
    ctr_index: int
    ctr_type: int
    alpha_or_lambda: float
    rank: int
    cycling_detected: bool = False


@dataclasses.dataclass
class EqualityHierarchy:
    """An equality-constrained lexicographic LS problem (LexLSE input):
    the stacked ``A`` (sum(dims), n_var) and ``b``, the level sizes, and
    optional fixed variables (``lexlse.h:1381-1419``)."""

    A: np.ndarray
    b: np.ndarray
    dims: Tuple[int, ...]
    fixed_idx: Optional[np.ndarray] = None
    fixed_val: Optional[np.ndarray] = None
    fixed_type: Optional[np.ndarray] = None  # CtrType per fixed variable

    def __post_init__(self):
        self.A = np.asarray(self.A, dtype=np.float64)
        self.b = np.asarray(self.b, dtype=np.float64)
        self.dims = tuple(int(d) for d in self.dims)
        if self.A.shape[0] != sum(self.dims):
            raise LexLSError("A row count does not match sum(dims)")
        if self.b.shape[0] != self.A.shape[0]:
            raise LexLSError("b length does not match A row count")
        if self.fixed_idx is not None:
            self.fixed_idx = np.asarray(self.fixed_idx, dtype=np.int64)
            self.fixed_val = np.asarray(self.fixed_val, dtype=np.float64)
            if self.fixed_type is None:
                self.fixed_type = np.full(self.fixed_idx.shape, int(CtrType.ACTIVE_UB),
                                          dtype=np.int64)
            else:
                self.fixed_type = np.asarray(self.fixed_type, dtype=np.int64)
            if len(self.fixed_idx) > self.n_var:
                raise LexLSError("Cannot fix more than n_var variables")

    @property
    def n_var(self) -> int:
        return self.A.shape[1]

    @property
    def n_obj(self) -> int:
        return len(self.dims)

    @property
    def n_fixed(self) -> int:
        return 0 if self.fixed_idx is None else len(self.fixed_idx)

    def level_slice(self, k: int) -> slice:
        start = sum(self.dims[:k])
        return slice(start, start + self.dims[k])


@dataclasses.dataclass
class InequalityHierarchy:
    """An inequality-constrained lexicographic LS problem (LexLSI input).

    Levels are general objectives ``lb <= A x - v <= ub``, stacked
    row-wise; optionally the first level is a simple-bounds objective
    ``lb <= x[var_idx] - v <= ub`` stored with unit rows in ``A``.
    """

    A: np.ndarray  # stacked (sum(dims), n_var)
    lb: np.ndarray
    ub: np.ndarray
    dims: Tuple[int, ...]
    n_var: int
    simple_bounds: bool = False
    var_idx: Optional[np.ndarray] = None
    regularization: Optional[np.ndarray] = None  # per-level factors

    def __post_init__(self):
        self.A = np.asarray(self.A, dtype=np.float64)
        self.lb = np.asarray(self.lb, dtype=np.float64)
        self.ub = np.asarray(self.ub, dtype=np.float64)
        self.dims = tuple(int(d) for d in self.dims)
        m = sum(self.dims)
        if self.A.shape != (m, self.n_var):
            raise LexLSError("A must be (sum(dims), n_var)")
        if self.lb.shape[0] != m or self.ub.shape[0] != m:
            raise LexLSError("lb/ub length must equal sum(dims)")
        if np.any(self.lb > self.ub):
            # mirrors reference ``lexlsi.h:430,474``
            raise LexLSError("Lower bound is greater than upper bound.")
        if self.simple_bounds:
            if self.var_idx is None:
                raise LexLSError("simple_bounds level requires var_idx")
            self.var_idx = np.asarray(self.var_idx, dtype=np.int64)
            if len(self.var_idx) != self.dims[0]:
                raise LexLSError("var_idx length must equal dims[0]")
            if len(np.unique(self.var_idx)) != len(self.var_idx):
                raise LexLSError("Elements of VarIndex are not unique.")
        if self.regularization is None:
            self.regularization = np.zeros(len(self.dims), dtype=np.float64)
        else:
            self.regularization = np.asarray(self.regularization, dtype=np.float64)

    @property
    def n_obj(self) -> int:
        return len(self.dims)

    @property
    def n_ctr(self) -> int:
        return sum(self.dims)

    def level_slice(self, k: int) -> slice:
        start = sum(self.dims[:k])
        return slice(start, start + self.dims[k])

    def level_of_row(self) -> np.ndarray:
        """int array: level index of each stacked constraint row."""
        return np.repeat(np.arange(self.n_obj, dtype=np.int64), self.dims)

    def initial_ctr_type(self, tol_equality: float = 1e-15) -> np.ndarray:
        """Equality constraints (lb == ub to ``tol_equality``) as
        ACTIVE_EQ, the rest INACTIVE (``lexlsi.h:367-385``): general rows
        with a zero normal stay inactive; simple bounds have none."""
        eq = np.abs(self.lb - self.ub) < tol_equality
        d0 = self.dims[0] if self.simple_bounds else 0
        eq[d0:] &= (self.A[d0:] ** 2).sum(axis=1) > 0
        return np.where(eq, int(CtrType.ACTIVE_EQ), int(CtrType.INACTIVE)).astype(np.int64)


def build_general_hierarchy(
    objectives: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
) -> InequalityHierarchy:
    """Build an :class:`InequalityHierarchy` from per-level (A, lb, ub)."""
    A = np.concatenate([np.atleast_2d(o[0]) for o in objectives], axis=0)
    lb = np.concatenate([np.atleast_1d(o[1]) for o in objectives])
    ub = np.concatenate([np.atleast_1d(o[2]) for o in objectives])
    dims = tuple(np.atleast_2d(o[0]).shape[0] for o in objectives)
    return InequalityHierarchy(A=A, lb=lb, ub=ub, dims=dims, n_var=A.shape[1])


def build_hierarchy_with_bounds(
    var_idx: np.ndarray,
    bounds_lb: np.ndarray,
    bounds_ub: np.ndarray,
    objectives: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    n_var: Optional[int] = None,
) -> InequalityHierarchy:
    """Build a hierarchy whose first level is a SIMPLE_BOUNDS objective."""
    if n_var is None:
        n_var = np.atleast_2d(objectives[0][0]).shape[1]
    var_idx = np.asarray(var_idx, dtype=np.int64)
    A0 = np.zeros((len(var_idx), n_var))
    A0[np.arange(len(var_idx)), var_idx] = 1.0
    A = np.concatenate([A0] + [np.atleast_2d(o[0]) for o in objectives], axis=0)
    lb = np.concatenate([np.atleast_1d(bounds_lb)] + [np.atleast_1d(o[1]) for o in objectives])
    ub = np.concatenate([np.atleast_1d(bounds_ub)] + [np.atleast_1d(o[2]) for o in objectives])
    dims = (len(var_idx),) + tuple(np.atleast_2d(o[0]).shape[0] for o in objectives)
    return InequalityHierarchy(
        A=A, lb=lb, ub=ub, dims=dims, n_var=n_var, simple_bounds=True, var_idx=var_idx
    )
