"""The port's whole-solve tier against the JAX package's.

On the CPU ``solve_core_fused`` runs kernel B2's plain version; the JAX
side runs ``solve_core_fused(interpret=True)``, its Pallas kernel in
interpret mode (as ``tests/test_fused.py`` runs it).  Float64: statuses,
iteration counts, working sets, stamps and counters equal; x and v to
atol 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlsi as jli
from lexls_tpu import types as JT
from lexls_tpu.oracle import generate as jgen
from lexls_tpu.parallel import batched_initial_arrays

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert
from torch_parity import assert_state_match

torch.set_num_threads(1)


def _inputs(prob, B, rng, x0=None, drift=1e-2):
    """Batched NumPy inputs of one solve: drifting copies of A, shared
    bounds, cold activation, and the initial x (zeros unless ``x0``)."""
    m, n = prob.n_ctr, prob.n_var
    c0, s0, n0, _, _ = batched_initial_arrays(prob, B, jnp.float64)
    As = np.stack([prob.A + drift * rng.standard_normal(prob.A.shape) for _ in range(B)])
    x = np.zeros((B, n)) if x0 is None else np.tile(x0, (B, 1))
    return (As, np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1)), np.asarray(c0),
            np.asarray(s0), np.asarray(n0), x, np.zeros((B, m)), prob.regularization)


def _run_pair(prob, params, inputs, x_guess):
    ref = jli.solve_core_fused(
        *(jnp.asarray(a) for a in inputs), struct=jli.Structure.of(prob), params=params,
        x_guess_specified=x_guess, v0_specified=False, tile=inputs[0].shape[0],
        interpret=True)
    got = lt.solve_core_fused(
        *convert.to_torch(inputs, "cpu"), struct=lt.Structure.of(prob),
        params=convert.params_from(params), x_guess_specified=x_guess, v0_specified=False)
    return ref, got


@pytest.mark.parametrize("trial", range(6))
def test_fused_matches_jax_fuzz(trial):
    """Random shapes, rank deficiency, cold and warm guesses (as
    test_fused.py:62-86, no simple bounds); even trials remove the largest
    wrong-sign multiplier, odd ones the first activated
    (deactivate_first_wrong_sign)."""
    seed = int(np.random.default_rng(4321 + trial).integers(2**31))
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 14))
    dims = [int(rng.integers(1, 7)) for _ in range(int(rng.integers(1, 5)))]
    ranks = None
    if rng.random() < 0.5:
        ranks = [min(d, int(rng.integers(1, d + 1))) for d in dims]
    prob = jgen.random_inequality_hierarchy(
        rng, n, dims, ranks=ranks, equality_fraction=float(rng.random() * 0.4),
        tight_fraction=float(rng.random() * 0.6))
    # trials 2-4 also turn on the phase-1 options: v0 without the minimal
    # initial violation, and the hot-start guess repair (which needs x0)
    params = JT.ParametersLexLSI(max_number_of_factorizations=80,
                                 deactivate_first_wrong_sign=trial % 2 == 1,
                                 set_min_init_ctr_violation=trial != 2,
                                 modify_type_active_enabled=trial in (3, 4),
                                 modify_type_inactive_enabled=trial == 4)
    x0 = rng.standard_normal(n) if rng.random() < 0.4 or trial in (3, 4) else None
    ref, got = _run_pair(prob, params, _inputs(prob, 3, rng, x0), x0 is not None)
    assert_state_match(ref, got, seed)


@pytest.mark.parametrize("deact_first", [False, True])
def test_fused_removals_match_jax(deact_first):
    """Both removal strategies on a shape that removes constraints (the
    λ sweep and the selection must run)."""
    rng = np.random.default_rng(5)
    prob = jgen.random_inequality_hierarchy(rng, 10, [4, 4, 4], equality_fraction=0.0,
                                            tight_fraction=0.8)
    params = JT.ParametersLexLSI(max_number_of_factorizations=120,
                                 deactivate_first_wrong_sign=deact_first)
    x0 = 2.0 * rng.standard_normal(10)
    ref, got = _run_pair(prob, params, _inputs(prob, 4, rng, x0), True)
    assert int(got.n_deact.sum()) > 0
    assert_state_match(ref, got)


def test_fused_budget_exhaustion_matches_jax():
    """A tiny factorization budget ends in
    MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED, mapped from the kernel's
    UNKNOWN exactly as the JAX package maps it."""
    rng = np.random.default_rng(11)
    prob = jgen.random_inequality_hierarchy(rng, 10, [4, 4], equality_fraction=0.0,
                                            tight_fraction=0.9)
    params = JT.ParametersLexLSI(max_number_of_factorizations=2)
    ref, got = _run_pair(prob, params, _inputs(prob, 2, rng), False)
    assert int(JT.TerminationStatus.MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED) in got.status.tolist()
    assert_state_match(ref, got)


@pytest.mark.parametrize("bad", [
    dict(regularization_type=lt.RegularizationType.TIKHONOV),
    dict(trace_enabled=True),
    dict(use_phase1_v0=True),
    dict(log_working_set_enabled=True),
    dict(cycling_handling_enabled=True),
    "simple_bounds",
])
def test_fused_rejects_unsupported(bad):
    rng = np.random.default_rng(13)
    simple = bad == "simple_bounds"
    prob = jgen.random_inequality_hierarchy(rng, 8, [3, 3], simple_bounds=simple)
    params = lt.ParametersLexLSI(**({} if simple else bad))
    args = convert.to_torch(_inputs(prob, 2, rng), "cpu")
    with pytest.raises(lt.LexLSError):
        lt.solve_core_fused(*args, struct=lt.Structure.of(prob), params=params,
                            x_guess_specified=False, v0_specified=False)
