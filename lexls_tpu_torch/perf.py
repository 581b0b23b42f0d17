"""Roofline accounting: the algorithmic floating-point operations of one
active-set solve, against the peaks of the card the port runs on.

Counterpart of ``lexls_tpu/perf.py``: the same counts of the *useful*
work of the reference algorithm (the Householder panel and the Gauss
elimination of ``lexlse.h:117-506``, the back substitution of
``:1015-1045`` and the multiplier back-propagation of ``:611-762``), not
the masked work that a static-shape realization adds.  Measured solves/s
times these counts, over the card's peaks, give the model-flops
utilization and the share of the memory rate.

The card: NVIDIA H100 80GB HBM3 (SXM, 700 W).  NVIDIA's H100 SXM data sheet
gives 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the tensor
cores, and 3.35 TB/s of HBM3.  The port's kernels use no tensor cores,
and its float32 matmuls are held at full precision
(:func:`lexls_tpu_torch.active_set.full_fp32`), so a TF32 or bf16 rate is no
ceiling of this code and is not reported.  A card set below 700 W runs
below these rates.
"""

from __future__ import annotations

from typing import Dict, Sequence

H100_PEAK_F32 = 67e12      # FLOP/s, float32 outside the tensor cores
H100_PEAK_F64 = 34e12      # FLOP/s, float64 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12  # bytes/s


def factorize_flops(n: int, dims: Sequence[int]) -> float:
    """FLOPs of one l-QR factorization (reference ``lexlse.h:117-506``),
    assuming full per-level ranks.  Per accepted pivot step the Householder
    reflection updates the remaining rows of the level over the trailing
    columns and the rhs (about 4 d_rem c_rem) plus the column-norm
    bookkeeping and the norm downdate; per level the Gauss elimination
    forms L = B R^-1 and updates the rows below."""
    total = 0.0
    rows_below = sum(dims)
    fc = 0  # columns taken by the levels above
    for dim in dims:
        K = min(dim, max(n - fc, 0))
        rows_below -= dim
        for j in range(K):
            d_rem = dim - j
            c_rem = (n - fc - j) + 1
            total += 4.0 * d_rem * c_rem   # w = u^T B; B -= tau u w
            total += 2.0 * d_rem           # the pivot column's norm
            total += 2.0 * (n - fc - j)    # norm downdate
        if rows_below > 0 and K > 0:
            total += rows_below * K * K                      # triangular solve
            total += 2.0 * rows_below * K * ((n - fc - K) + 1)  # trailing update
        fc += K
        if fc >= n:
            break
    return total


def solve_flops(n: int) -> float:
    """Back substitution through the staircase (about n^2)."""
    return float(n * n)


def sweep_flops(n: int, dims: Sequence[int]) -> float:
    """All objectives' multiplier back-propagation: per level k, a
    Householder replay over the p - k higher right-hand sides (4 d K
    each) and the coupling product (2 (p - k) d n)."""
    p = len(dims)
    total = 0.0
    fc = 0
    for k, dim in enumerate(dims):
        K = min(dim, max(n - fc, 0))
        total += 4.0 * (p - k) * dim * K
        total += 2.0 * (p - k) * dim * n
        fc += K
    return total


def iteration_flops(n: int, dims: Sequence[int]) -> float:
    """One active-set iteration: factorize, solve, the step A dx, the ratio
    test and the sweep (the sweep runs on non-blocking iterations only, so
    counting it every iteration over-credits blocking-heavy solves a
    little)."""
    m = sum(dims)
    return (factorize_flops(n, dims) + solve_flops(n)
            + 2.0 * m * n          # A dx
            + 6.0 * m              # ratio test
            + sweep_flops(n, dims))


def mfu_report(solves_per_s: float, n: int, dims: Sequence[int], mean_iterations: float,
               itemsize: int = 4) -> Dict[str, float]:
    """Achieved algorithmic FLOP/s and its share of the H100's float32 and
    float64 peaks, and the share of the HBM rate that the least traffic of
    a solve takes (A read once, x and the working set written once, in
    elements of ``itemsize`` bytes)."""
    per_solve = iteration_flops(n, dims) * mean_iterations
    flops_s = solves_per_s * per_solve
    m = sum(dims)
    bytes_per_solve = float(itemsize) * (m * n + 2 * m + n)
    return {
        "flops_per_solve": per_solve,
        "flops_per_s": flops_s,
        "mfu_vs_f32_peak": flops_s / H100_PEAK_F32,
        "mfu_vs_f64_peak": flops_s / H100_PEAK_F64,
        "hbm_fraction": solves_per_s * bytes_per_solve / H100_HBM_BYTES_S,
    }
