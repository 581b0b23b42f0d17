"""The reference agrees with the port's plain versions on tiny instances of
both configurations' kinds, and the comparison fails a perturbed answer."""

import json
from pathlib import Path

import numpy as np
import pytest

from conftest import F32_PARAMS, F64_PARAMS

from lexbench.harness import check
from lexbench.harness.generate import random_inequality_hierarchy
from lexbench.reference import lexls_ref as ref


def port_solve(raw, params, dtype):
    import torch

    import lexls_tpu_torch as lt

    prob = lt.InequalityHierarchy(A=raw.A, lb=raw.lb, ub=raw.ub, dims=raw.dims,
                                  n_var=raw.A.shape[1], simple_bounds=raw.var_idx is not None,
                                  var_idx=raw.var_idx)
    return lt.solve(prob, lt.ParametersLexLSI(**params), dtype=getattr(torch, dtype),
                    device="cpu")


@pytest.mark.parametrize("kind", ["general_f32", "bounds_f64"])
def test_reference_agrees_with_the_port_and_a_perturbed_answer_fails(kind):
    sb = kind == "bounds_f64"
    params, limit, dtype = (F64_PARAMS, 1e-8, "float64") if sb else (F32_PARAMS, 1e-3, "float32")
    config = {"dims": [5, 6, 4, 6] if sb else [6, 6, 6], "simple_bounds": sb, "params": params,
              "n_var": 14, "hierarchy": {"seed": 21, "equality_fraction": 0.1,
                                         "tight_fraction": 0.3}}
    for seed in range(3):
        raw = random_inequality_hierarchy(np.random.default_rng(seed), 14, config["dims"],
                                          0.1, 0.3, sb)
        config["hierarchy"]["seed"] = seed
        res = port_solve(raw, params, dtype)
        ours = ref.solve(ref.Hierarchy(raw.A, raw.lb, raw.ub, raw.dims, raw.var_idx),
                         ref.Params(**check.reference_params(config)))
        assert int(res.status) == 0 and ours.status == 0
        g = check.gap(raw.A, raw.lb, raw.ub, raw.dims, res.x, ours.x)
        assert g < limit / 10, (seed, g)
        bad = res.x.copy()
        bad[0] += 0.05
        assert check.gap(raw.A, raw.lb, raw.ub, raw.dims, bad, ours.x) > limit


def test_the_reference_is_the_oracle_it_was_copied_from():
    """Bit for bit the answer of the JAX package's NumPy oracle on a cold
    solve, kept as data (``oracle_cold_solve.json``) so that nothing here
    imports the JAX package."""
    want = json.loads((Path(__file__).parent / "oracle_cold_solve.json").read_text())
    A, lb, ub = (np.array(want[k], np.float64) for k in ("A", "lb", "ub"))
    raw = random_inequality_hierarchy(np.random.default_rng(4), 12, [4, 5, 4], 0.1, 0.3, True)
    assert np.array_equal(raw.A, A) and np.array_equal(raw.lb, lb) and np.array_equal(raw.ub, ub)
    got = ref.solve(ref.Hierarchy(A, lb, ub, tuple(want["dims"]), np.array(want["var_idx"])),
                    ref.Params(**want["params"]))
    assert np.array_equal(got.x, np.array(want["x"], np.float64))
    assert int(got.status) == want["status"] and got.n_iterations == want["n_iterations"]


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.array([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0, 0.0])
    assert list(ref._tf32(x)) == [1.0, 1.0 + 2.0 ** -10, -3.0, 0.0]
