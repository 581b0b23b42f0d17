"""The port's regularized exact tier against the JAX package's.

``solve_core_batched`` and ``parallel.solve_batched`` with the damping
between each level's kernel-B1 launch (its plain version on the CPU) and
its Gauss elimination, against the JAX package's XLA tier under
regularization (its Pallas panel does not take regularization), as its
own tests run it.  Float64: statuses, iterations and working sets equal,
per-level ||v|| to 1e-8, x to 1e-7 (CG 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlsi as jli
from lexls_tpu import types as JT
from lexls_tpu.oracle import generate as jgen
from lexls_tpu.parallel import batched_initial_arrays as jax_initial_arrays
from lexls_tpu.parallel import solve_batched as jax_solve_batched

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert

torch.set_num_threads(1)

RT = JT.RegularizationType


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0, err_msg=msg)


def _level_norms(v, dims):
    edges = np.cumsum([0] + list(dims))
    return np.stack([np.linalg.norm(v[:, a:b], axis=1) for a, b in zip(edges, edges[1:])], 1)


def _solve_inputs(simple, rt):
    """One small rank-deficient hierarchy (n=10) and B drifting
    copies; well enough conditioned that 10 CGLS trips reach the damped
    minimizer (config 3's shape does not: there a 1e-15 change of A moves
    the JAX package's own CG x by up to 7e-2)."""
    rng = np.random.default_rng(9 if simple else 7)
    n, dims, ranks = (10, [4, 4, 3, 3], [4, 3, 2, 2]) if simple else (10, [4, 4, 3], [3, 3, 2])
    prob = jgen.random_inequality_hierarchy(rng, n, dims, ranks=ranks, equality_fraction=0.1,
                                            tight_fraction=0.5, simple_bounds=simple)
    prob.regularization = np.full(len(dims), 0.3)
    B = 6
    d0 = prob.dims[0] if simple else 0
    As = np.stack([prob.A for _ in range(B)])
    As[:, d0:] += 1e-2 * rng.standard_normal(As[:, d0:].shape)
    c0, s0, n0, x0, v0 = (np.array(a) for a in jax_initial_arrays(prob, B))
    inputs = (As, np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1)), c0, s0, n0, x0, v0,
              prob.regularization)
    params = JT.ParametersLexLSI(regularization_type=rt, max_number_of_factorizations=64)
    return prob, params, inputs


def _assert_solves_match(ref, got, prob, x_tol):
    for f in ("status", "it", "ctr_type", "n_act", "n_deact", "n_fact"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_allclose(_level_norms(got.v.numpy(), prob.dims),
                               _level_norms(np.asarray(ref.v), prob.dims), atol=1e-8, rtol=0)
    _close(got.x, ref.x, x_tol, "x")


@pytest.mark.parametrize("rt,simple", [(RT.TIKHONOV, False), (RT.TIKHONOV_1, False),
                                       (RT.TIKHONOV_CG, False), (RT.TIKHONOV, True)],
                         ids=["TIKHONOV", "TIKHONOV_1", "TIKHONOV_CG", "TIKHONOV-simple_bounds"])
def test_solve_core_batched_regularized_matches_jax(rt, simple):
    """The exact tier under regularization (phase 1 damped too; TIKHONOV_1
    selects removals from its regularized multipliers) against the JAX
    package's XLA tier; with simple bounds the bound level takes no
    factor."""
    prob, params, inputs = _solve_inputs(simple, rt)
    ref = jli.solve_core_batched(*(jnp.asarray(a) for a in inputs),
                                 struct=jli.Structure.of(prob), params=params,
                                 x_guess_specified=False, v0_specified=False)
    got = lt.solve_core_batched(*convert.to_torch(inputs, "cpu"), struct=lt.Structure.of(prob),
                                params=convert.params_from(params), x_guess_specified=False,
                                v0_specified=False)
    assert (got.status == 0).any() and int(got.n_deact.sum()) > 0
    _assert_solves_match(ref, got, prob, 1e-6 if rt == RT.TIKHONOV_CG else 1e-7)


def test_solve_batched_matches_jax():
    """``parallel.solve_batched`` (the JAX package's ``vmap`` of its
    single-instance solver) under the R variant."""
    prob, params, inputs = _solve_inputs(False, RT.R)
    ref = jax_solve_batched(*(jnp.asarray(a) for a in inputs), struct=jli.Structure.of(prob),
                            params=params)
    got = lt.solve_batched(*convert.to_torch(inputs, "cpu"), struct=lt.Structure.of(prob),
                           params=convert.params_from(params))
    assert (got.status == 0).any()
    _assert_solves_match(ref, got, prob, 1e-7)
