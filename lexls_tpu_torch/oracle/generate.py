"""Random problem generators with controlled per-level rank (NumPy only).

A copy of ``lexls_tpu/oracle/generate.py:23-117``.  For the same
``np.random.Generator`` state both return bit-identical arrays, so a
machine without JAX builds the same problems as the JAX package's tests
and ``bench.py``.  Level ``i`` contributes exactly rank ``ranks[i]`` on top
of the previous levels (its rows are random combinations of all previous
rows plus ``ranks[i]`` fresh random rows).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..types import (
    InequalityHierarchy,
    build_general_hierarchy,
    build_hierarchy_with_bounds,
)


def random_equality_hierarchy(
    rng: np.random.Generator,
    n_var: int,
    dims: Sequence[int],
    ranks: Optional[Sequence[int]] = None,
    fixed_variables: int = 0,
):
    """Return (A, b, dims, fixed_idx, fixed_val) with controlled ranks.

    ``ranks[i]`` = rank that level i contributes on top of levels < i.
    ``fixed_variables`` > 0 also draws that many fixed variables.
    """
    dims = list(dims)
    if ranks is None:
        ranks = list(dims)
    ranks = list(ranks)
    if len(ranks) != len(dims):
        raise ValueError("ranks and dims must have the same length")

    C = np.zeros((0, n_var))
    A_levels = []
    b_levels = []
    for m_i, r_i in zip(dims, ranks):
        prev_rows = C.shape[0]
        fresh = rng.standard_normal((r_i, n_var))
        mix = rng.standard_normal((m_i, prev_rows + r_i))
        A_i = mix @ np.concatenate([C, fresh], axis=0)
        b_i = rng.standard_normal(m_i)
        C = np.concatenate([C, A_i], axis=0)
        # rescale to keep magnitudes bounded across many levels
        s = np.abs(C).max()
        if s > 1.0:
            C = C / s
        A_levels.append(A_i)
        b_levels.append(b_i)

    if A_levels:
        A = np.concatenate(A_levels, axis=0)
        b = np.concatenate(b_levels)
    else:  # a bounds-only hierarchy: no general levels
        A = np.zeros((0, n_var))
        b = np.zeros(0)

    fixed_idx = fixed_val = None
    if fixed_variables > 0:
        fixed_idx = rng.permutation(n_var)[:fixed_variables]
        fixed_val = rng.standard_normal(fixed_variables)

    return A, b, tuple(dims), fixed_idx, fixed_val


def random_inequality_hierarchy(
    rng: np.random.Generator,
    n_var: int,
    dims: Sequence[int],
    ranks: Optional[Sequence[int]] = None,
    equality_fraction: float = 0.2,
    tight_fraction: float = 0.5,
    simple_bounds: bool = False,
) -> InequalityHierarchy:
    """Random inequality hierarchy.

    A fraction of rows become equalities (lb == ub); the rest get finite
    two-sided bounds around a random interior point, with ``tight_fraction``
    of them likely to be active at the optimum (narrow intervals).
    """
    gen_dims = list(dims)
    bound_idx = bound_lb = bound_ub = None
    if simple_bounds:
        n0 = gen_dims[0]
        bound_idx = rng.permutation(n_var)[:n0]
        center = rng.standard_normal(n0)
        half = np.abs(rng.standard_normal(n0)) * 0.5 + 0.05
        eq0 = rng.random(n0) < equality_fraction
        bound_lb = np.where(eq0, center, center - half)
        bound_ub = np.where(eq0, center, center + half)
        gen_dims = gen_dims[1:]

    gen_ranks = None if ranks is None else list(ranks)[1 if simple_bounds else 0:]
    A, b, _, _, _ = random_equality_hierarchy(rng, n_var, gen_dims, gen_ranks)

    eq = rng.random(len(b)) < equality_fraction
    width = np.where(rng.random(len(b)) < tight_fraction, 0.01, 1.0)
    half = np.abs(rng.standard_normal(len(b))) * width + 1e-3
    lb = np.where(eq, b, b - half)
    ub = np.where(eq, b, b + half)

    objectives = []
    ofs = 0
    for d in gen_dims:
        objectives.append((A[ofs : ofs + d], lb[ofs : ofs + d], ub[ofs : ofs + d]))
        ofs += d

    if simple_bounds:
        return build_hierarchy_with_bounds(bound_idx, bound_lb, bound_ub, objectives, n_var=n_var)
    return build_general_hierarchy(objectives)
