"""Random hierarchies with controlled per-level rank (NumPy only).

A frozen copy of ``lexls_tpu_torch/oracle/generate.py`` (itself a copy of
``lexls_tpu/oracle/generate.py:23-117``): for the same
``np.random.Generator`` state it draws the same numbers in the same order,
so a configuration's hierarchy is the one those generators give.  It
returns plain arrays rather than either package's hierarchy type.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


class RawHierarchy(NamedTuple):
    """Stacked ``lb <= A x - v <= ub``; with ``var_idx`` the first level
    is simple bounds on those variables (unit rows of ``A``)."""

    A: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    dims: Tuple[int, ...]
    var_idx: Optional[np.ndarray]


def _equality_rows(rng, n_var, dims):
    """Each level's rows: random combinations of all earlier rows plus
    ``dim`` fresh rows, rescaled to entries of at most 1."""
    C = np.zeros((0, n_var))
    A_levels, b_levels = [], []
    for m_i in dims:
        fresh = rng.standard_normal((m_i, n_var))
        mix = rng.standard_normal((m_i, C.shape[0] + m_i))
        A_i = mix @ np.concatenate([C, fresh], axis=0)
        b_levels.append(rng.standard_normal(m_i))
        C = np.concatenate([C, A_i], axis=0)
        s = np.abs(C).max()
        if s > 1.0:
            C = C / s
        A_levels.append(A_i)
    return np.concatenate(A_levels, axis=0), np.concatenate(b_levels)


def random_inequality_hierarchy(rng: np.random.Generator, n_var: int, dims: Sequence[int],
                                equality_fraction: float, tight_fraction: float,
                                simple_bounds: bool = False) -> RawHierarchy:
    """A share ``equality_fraction`` of the rows are equalities (lb == ub);
    the others get two-sided bounds around a random point, ``tight_fraction``
    of them narrow (likely active at the optimum)."""
    gen_dims = list(dims)
    var_idx = None
    if simple_bounds:
        n0 = gen_dims[0]
        var_idx = rng.permutation(n_var)[:n0]
        center = rng.standard_normal(n0)
        half0 = np.abs(rng.standard_normal(n0)) * 0.5 + 0.05
        eq0 = rng.random(n0) < equality_fraction
        lb0, ub0 = np.where(eq0, center, center - half0), np.where(eq0, center, center + half0)
        gen_dims = gen_dims[1:]
    A, b = _equality_rows(rng, n_var, gen_dims)
    eq = rng.random(len(b)) < equality_fraction
    width = np.where(rng.random(len(b)) < tight_fraction, 0.01, 1.0)
    half = np.abs(rng.standard_normal(len(b))) * width + 1e-3
    lb, ub = np.where(eq, b, b - half), np.where(eq, b, b + half)
    if simple_bounds:
        A0 = np.zeros((len(var_idx), n_var))
        A0[np.arange(len(var_idx)), var_idx] = 1.0
        A, lb, ub = np.concatenate([A0, A]), np.concatenate([lb0, lb]), np.concatenate([ub0, ub])
    return RawHierarchy(A=A, lb=lb, ub=ub, dims=tuple(int(d) for d in dims),
                        var_idx=None if var_idx is None else var_idx.astype(np.int64))
