"""The work a kernel's call needed, and the least time the card could
take for it: the yardstick of the ``*_roofline_pct`` metrics.

Frozen copies of ``chip_smoke.py``'s ``_sum_dc``, ``_panel_flops`` and
``_active_set_flops`` (the useful floating-point operations of the
reference algorithm, at the ranks each instance reached) and of its
``_bound``, with the peaks of ``lexls_tpu_torch/perf.py``: NVIDIA's H100
SXM data sheet, outside the tensor cores (the port's kernels use none).
``_active_set_flops`` takes arrays here rather than the kernel's result.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # FLOP/s, outside the tensor cores
HBM_BYTES_S = 3.35e12


def sum_dc(r, d, c):
    """sum over j < r of (d - j)(c - j), elementwise over arrays."""
    return r * d * c - (d + c) * r * (r - 1) / 2 + (r - 1) * r * (2 * r - 1) / 6


def panel_flops(r, dim, cols):
    """One level's pivot loop with r accepted steps over ``cols`` columns:
    the column norms, and per step the pivot norm, w = u^T block, the
    rank-1 update over the trailing columns and the rhs, and the norm
    downdate (kernel B1's work, and B2's inside every iteration)."""
    return 2 * dim * cols + 2 * sum_dc(r, dim, 1) + 4 * sum_dc(r, dim, cols + 1) \
        + 2 * sum_dc(r, 1, cols)


def active_set_flops(ranks: np.ndarray, its: np.ndarray, n_act: np.ndarray,
                     dims: Sequence[int], n: int, m: int) -> float:
    """Kernel B2's operations over general levels ``dims``: per instance,
    its iterations times one iteration at its final level ranks (factorize,
    eliminate, solve, step, ratio test), plus a multiplier sweep for each
    iteration that did not block.  ``ranks`` is (B, p), ``its`` and
    ``n_act`` (B,)."""
    ranks = np.asarray(ranks, np.float64)
    its = np.asarray(its, np.float64)
    sweeps = its - np.asarray(n_act, np.float64)
    p = len(dims)
    per_it = np.full(len(its), 2.0 * m * n + 8 * m)               # Adx, dv, ratio test
    per_sweep = np.zeros(len(its))
    fc = np.zeros(len(its))
    below = m
    for k, d in enumerate(dims):
        r = ranks[:, k]
        below -= d
        cols = n - fc
        per_it += panel_flops(r, d, cols)
        per_it += below * r * r + 2 * below * r * (cols + 1 - r)   # L, trailing update
        per_it += 2 * r * (cols - r) + r * r                      # backward substitution
        per_sweep += (p - k) * (4 * sum_dc(r, d, 1) + 2 * d * fc)  # replay, back-propagation
        fc = fc + r
    return float((its * per_it + sweeps * per_sweep).sum())


def bound_s(nbytes: float, flops: float, dtype: str):
    """(seconds, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate of ``dtype``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
