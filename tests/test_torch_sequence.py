"""The fused sequence end to end: warm-started sequences through the
whole-solve tier against the JAX package's
``solve_sequence_batched_fused(tracked=False)`` (its Pallas kernel in
interpret mode; the tracked sequence is in ``test_torch_tracker.py``).
Float64: statuses, iterations, factorizations and final working sets
equal; x and v to atol 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlsi as jli
from lexls_tpu import sequence as jseq
from lexls_tpu import types as JT
from lexls_tpu.oracle import generate as jgen

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert
from lexls_tpu_torch.sequence import _device_initial_activation

torch.set_num_threads(1)


def _sequence(seed, B, T, n, dims, drift=1e-2):
    rng = np.random.default_rng(seed)
    prob = jgen.random_inequality_hierarchy(rng, n, dims, equality_fraction=0.15,
                                            tight_fraction=0.5)
    A_seq = prob.A + drift * np.cumsum(rng.standard_normal((B, T) + prob.A.shape), axis=1)
    lb_seq = np.broadcast_to(prob.lb, (B, T, prob.n_ctr)).copy()
    ub_seq = np.broadcast_to(prob.ub, (B, T, prob.n_ctr)).copy()
    return prob, A_seq, lb_seq, ub_seq


def test_device_initial_activation_matches_jax():
    prob, A_seq, lb_seq, ub_seq = _sequence(1, 4, 1, 8, [3, 4])
    A, lb, ub = A_seq[:, 0], lb_seq[:, 0], ub_seq[:, 0]
    A[1, 2] = 0.0  # a zero normal stays inactive even as an equality
    guess = np.random.default_rng(2).integers(0, 4, size=lb.shape).astype(np.int32)
    struct = jli.Structure.of(prob)
    want = jax.vmap(lambda a, l, u, g: jseq._device_initial_activation(a, l, u, g, struct))(
        jnp.asarray(A), jnp.asarray(lb), jnp.asarray(ub), jnp.asarray(guess))
    got = _device_initial_activation(*convert.to_torch((A, lb, ub, guess), "cpu"),
                                     lt.Structure.of(prob))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("deact_first", [False, True])
def test_sequence_matches_jax(deact_first):
    prob, A_seq, lb_seq, ub_seq = _sequence(3 + deact_first, 4, 3, 12, [4, 4, 4])
    params = JT.ParametersLexLSI(max_number_of_factorizations=80,
                                 deactivate_first_wrong_sign=deact_first)
    want = jseq.solve_sequence_batched_fused(
        jnp.asarray(A_seq), jnp.asarray(lb_seq), jnp.asarray(ub_seq),
        jnp.asarray(prob.regularization), struct=jli.Structure.of(prob), params=params,
        interpret=True)
    got = lt.solve_sequence_batched_fused(
        *convert.to_torch((A_seq, lb_seq, ub_seq, prob.regularization), "cpu"),
        struct=lt.Structure.of(prob), params=convert.params_from(params))
    assert got[0].shape == (4, 3, 12)
    assert bool((got[2] == 0).all())
    assert int(got[3][:, 1:].max()) >= 1
    for i, (w, g) in enumerate(zip(want, got)):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9, rtol=0,
                                       err_msg=str(i))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(i))

