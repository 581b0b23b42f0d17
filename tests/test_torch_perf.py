"""The port's FLOP model (``lexls_tpu_torch/perf.py``) against the JAX
package's (``lexls_tpu/perf.py``): the same algorithmic counts, and the
utilization against the H100's peaks.  Pure Python, no compilation."""

import ast
import pathlib

import pytest

from lexls_tpu import perf as jperf

from lexls_tpu_torch import perf

# n below, at and above sum(dims); a level that runs out of columns; the
# bench shape and config 1's
SHAPES = [
    (5, (3, 4)),
    (7, (3, 4)),
    (12, (3, 4)),
    (6, (4, 5, 2)),
    (3, (2, 9, 3)),
    (100, (30, 30, 30, 30)),
    (88, (33, 3, 2, 97)),
]


@pytest.mark.parametrize("n,dims", SHAPES, ids=str)
def test_flop_counts_match_jax(n, dims):
    assert perf.factorize_flops(n, dims) == jperf.factorize_flops(n, dims)
    assert perf.solve_flops(n) == jperf.solve_flops(n)
    assert perf.sweep_flops(n, dims) == jperf.sweep_flops(n, dims)
    assert perf.iteration_flops(n, dims) == jperf.iteration_flops(n, dims)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_mfu_report_against_the_card_peaks(itemsize):
    n, dims, rate, its = 100, (30, 30, 30, 30), 3.5e5, 1.43
    got = perf.mfu_report(rate, n, dims, its, itemsize=itemsize)
    per_solve = perf.iteration_flops(n, dims) * its
    m = sum(dims)
    assert set(got) == {"flops_per_solve", "flops_per_s", "mfu_vs_f32_peak", "mfu_vs_f64_peak",
                        "hbm_fraction"}
    assert got["flops_per_solve"] == per_solve
    assert got["flops_per_s"] == pytest.approx(rate * per_solve, rel=1e-15)
    assert got["mfu_vs_f32_peak"] == pytest.approx(rate * per_solve / 67e12, rel=1e-15)
    assert got["mfu_vs_f64_peak"] == pytest.approx(rate * per_solve / 34e12, rel=1e-15)
    assert got["hbm_fraction"] == pytest.approx(
        rate * itemsize * (m * n + 2 * m + n) / 3.35e12, rel=1e-15)
    # the same solves and FLOPs as the JAX package's report, other peaks
    want = jperf.mfu_report(rate, n, dims, its)
    assert got["flops_per_s"] == want["flops_per_s"]
    if itemsize == 4:
        assert got["hbm_fraction"] == pytest.approx(want["hbm_fraction"] * 0.8e12 / 3.35e12,
                                                    rel=1e-12)


def test_perf_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse(pathlib.Path(perf.__file__).read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "lexls_tpu")], names
    assert (perf.H100_PEAK_F32, perf.H100_PEAK_F64, perf.H100_HBM_BYTES_S) == (67e12, 34e12,
                                                                              3.35e12)
