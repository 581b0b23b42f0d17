"""The port's natively batched exact tier against the JAX package's.

``solve_core_batched`` factorizes every iteration through kernel B1: on
the CPU the port runs B1's plain version, and the JAX side runs
``solve_core_batched(use_pallas=True)``, its Pallas panel kernel in
interpret mode (as ``tests/test_parallel.py:236-305`` runs it).  Float64:
statuses, iteration counts, working sets, stamps and counters equal; x and
v to atol 1e-10 (the same factorization steps in both packages, so only
the summation order of the matrix products differs)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlse as jlexlse
import lexls_tpu.lexlsi as jli
import lexls_tpu.sequence as jseq
from lexls_tpu import types as JT
from lexls_tpu.ops import factorize_fast_batched as jax_factorize
from lexls_tpu.oracle import generate as jgen
from lexls_tpu.parallel import batched_initial_arrays as jax_initial_arrays

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert, lexlse
from lexls_tpu_torch.active_set import _masked_general
from lexls_tpu_torch.ops import factorize_fast_batched
from torch_parity import INT_FIELDS, assert_log_match

torch.set_num_threads(1)


def _batch(prob, B, rng, drift=1e-2):
    """NumPy inputs of one cold batched solve: B drifting copies of the
    general rows of A (bound rows stay unit rows), shared bounds."""
    d0 = prob.dims[0] if prob.simple_bounds else 0
    As = np.stack([prob.A for _ in range(B)])
    As[:, d0:] += drift * rng.standard_normal(As[:, d0:].shape)
    c0, s0, n0, x0, v0 = (np.array(a) for a in jax_initial_arrays(prob, B))
    return (As, np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1)), c0, s0, n0, x0, v0,
            prob.regularization)


def _run_pair(prob, params, inputs, x_guess=False):
    ref = jli.solve_core_batched(
        *(jnp.asarray(a) for a in inputs), struct=jli.Structure.of(prob), params=params,
        x_guess_specified=x_guess, v0_specified=False, use_pallas=True)
    got = lt.solve_core_batched(
        *convert.to_torch(inputs, "cpu"), struct=lt.Structure.of(prob),
        params=convert.params_from(params), x_guess_specified=x_guess, v0_specified=False)
    return ref, got


def _assert_match(ref, got, msg=""):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f"{msg}:{f}")
    for f in ("x", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-10, rtol=0, err_msg=f"{msg}:{f}")


@pytest.mark.parametrize("deact_first", [False, True])
@pytest.mark.parametrize("options", [False, True])
def test_solve_core_batched_matches_jax(deact_first, options):
    """General levels, both removal strategies, on a shape that removes
    constraints; with ``options`` the working-set log and cycling handling
    are on and their state is compared too."""
    rng = np.random.default_rng(9)
    prob = jgen.random_inequality_hierarchy(rng, 10, [4, 4, 4], equality_fraction=0.1,
                                            tight_fraction=0.7)
    params = JT.ParametersLexLSI(max_number_of_factorizations=60,
                                 deactivate_first_wrong_sign=deact_first,
                                 log_working_set_enabled=options,
                                 cycling_handling_enabled=options)
    ref, got = _run_pair(prob, params, _batch(prob, 4, rng))
    assert int(got.n_deact.sum()) > 0 and set(got.status.tolist()) == {0}
    _assert_match(ref, got)
    assert_log_match(ref, got, cycling=options)


@pytest.mark.parametrize("deact_first", [False, True])
def test_solve_core_batched_simple_bounds_matches_jax(deact_first):
    """A simple-bounds level: fixed variables flow through the panel
    factorization, their multipliers decide removals of bound rows, and
    the log names them as objective 0."""
    rng = np.random.default_rng(21)
    prob = jgen.random_inequality_hierarchy(rng, 8, [5, 3, 3, 2], simple_bounds=True,
                                            equality_fraction=0.1, tight_fraction=0.7)
    params = JT.ParametersLexLSI(max_number_of_factorizations=60,
                                 deactivate_first_wrong_sign=deact_first,
                                 log_working_set_enabled=True)
    ref, got = _run_pair(prob, params, _batch(prob, 4, rng))
    assert int(got.it.max()) > 2
    assert bool(((got.log_obj == 0) & (torch.arange(62) < got.log_len[:, None])).any())
    _assert_match(ref, got)
    assert_log_match(ref, got)


def test_solve_core_batched_budget_and_warm_guess_match_jax():
    """A warm guess with the hot-start repair, and a budget of two
    factorizations that ends MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED."""
    rng = np.random.default_rng(33)
    prob = jgen.random_inequality_hierarchy(rng, 9, [4, 4, 4], equality_fraction=0.0,
                                            tight_fraction=0.9)
    params = JT.ParametersLexLSI(max_number_of_factorizations=2,
                                 modify_type_active_enabled=True,
                                 modify_type_inactive_enabled=True)
    inputs = list(_batch(prob, 3, rng))
    inputs[6] = np.tile(3.0 * rng.standard_normal(9), (3, 1))
    ref, got = _run_pair(prob, params, inputs, x_guess=True)
    assert int(JT.TerminationStatus.MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED) in got.status.tolist()
    _assert_match(ref, got)


_CYC_NPZ = os.path.join(os.path.dirname(__file__), "golden", "cycling_fixtures.npz")


@pytest.mark.parametrize("max_counter", [50, 0])
def test_solve_core_batched_cycling_fixture_matches_jax(max_counter):
    """The frozen degenerate instance (n=4, dims (2, 3)) that re-adds the
    constraint it just removed: one relaxation and PROBLEM_SOLVED, or with
    ``cycling_max_counter=0`` PROBLEM_SOLVED_CYCLING_HANDLING."""
    fz = np.load(_CYC_NPZ)
    A, lb, ub, guess = (fz[f"relax_once_{k}"] for k in ("A", "lb", "ub", "guess"))
    prob = JT.InequalityHierarchy(A=A, lb=lb, ub=ub, dims=(2, 3), n_var=4)
    params = JT.ParametersLexLSI(max_number_of_factorizations=60, cycling_handling_enabled=True,
                                 log_working_set_enabled=True, cycling_max_counter=max_counter)
    c0, s0, n0 = lt.initial_activation(prob, guess)
    inputs = (A[None], lb[None], ub[None], c0[None], s0[None], np.asarray([n0]),
              np.zeros((1, 4)), np.zeros((1, 5)), prob.regularization)
    ref, got = _run_pair(prob, params, inputs)
    want = ([1], [0]) if max_counter else (
        [0], [int(JT.TerminationStatus.PROBLEM_SOLVED_CYCLING_HANDLING)])
    assert (got.cyc_counter.tolist(), got.status.tolist()) == want
    _assert_match(ref, got)
    assert_log_match(ref, got, cycling=True)


def test_exact_tier_and_whole_solve_tier_agree():
    """The two tiers of the port on one problem with both options on: the
    same trajectory, log and detector (their factorizations differ only in
    rounding)."""
    rng = np.random.default_rng(17)
    prob = jgen.random_inequality_hierarchy(rng, 10, [3, 5, 4], tight_fraction=0.7)
    params = lt.ParametersLexLSI(max_number_of_factorizations=60, log_working_set_enabled=True,
                                 cycling_handling_enabled=True)
    args = convert.to_torch(_batch(prob, 3, rng), "cpu")
    kw = dict(struct=lt.Structure.of(prob), params=params, x_guess_specified=False,
              v0_specified=False)
    exact, fused = lt.solve_core_batched(*args, **kw), lt.solve_core_fused(*args, **kw)
    for f, a in convert.state_to_numpy(exact).items():
        b = getattr(fused, f).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("option", ["trace_enabled", "use_phase1_v0"])
def test_solve_core_batched_trace_and_phase1_v0_match_jax(option):
    """The per-iteration trace, and ``use_phase1_v0`` from a guess (phase 1
    counts no factorization, iteration 0 keeps its step and sweeps
    nothing), against the JAX package's exact tier: every state field, the
    trace's arrays to 1e-10 and its operations and rows equal.  Instances
    that end early keep their trace while the others run on."""
    rng = np.random.default_rng(13)
    prob = jgen.random_inequality_hierarchy(rng, 8, [3, 3], tight_fraction=0.6)
    params = JT.ParametersLexLSI(max_number_of_factorizations=40,
                                 **{"trace_enabled": True, option: True})
    inputs = list(_batch(prob, 3, rng, drift=0.5))
    guess = option == "use_phase1_v0"
    if guess:
        inputs[6] = 2.0 * rng.standard_normal((3, 8))
    ref, got = _run_pair(prob, params, inputs, x_guess=guess)
    assert got.trace_x.shape == (3, 42, 8) and len(set(got.it.tolist())) > 1
    _assert_match(ref, got)
    for f in ("trace_op", "trace_row"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("trace_x", "trace_v", "trace_dx", "trace_dv", "trace_alpha"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-10, rtol=0, err_msg=f)
    if guess:
        np.testing.assert_array_equal(got.n_fact.numpy(), got.it.numpy() - 1)


def test_sequence_batched_native_matches_jax():
    """``solve_sequence_batched_native`` (test_parallel.py:258-276): three
    warm-started steps, every output of every step."""
    rng = np.random.default_rng(12)
    prob = jgen.random_inequality_hierarchy(rng, 6, [3, 3], tight_fraction=0.5)
    B, Tn, m = 3, 3, prob.n_ctr
    As = np.stack([np.stack([prob.A + 2e-3 * (t + 1) * rng.standard_normal(prob.A.shape)
                             for t in range(Tn)]) for _ in range(B)])
    lbs, ubs = (np.broadcast_to(b, (B, Tn, m)).copy() for b in (prob.lb, prob.ub))
    params = JT.ParametersLexLSI(max_number_of_factorizations=60)
    ref = jseq.solve_sequence_batched_native(
        *(jnp.asarray(a) for a in (As, lbs, ubs, prob.regularization)),
        struct=jli.Structure.of(prob), params=params)
    got = lt.solve_sequence_batched_native(
        *convert.to_torch((As, lbs, ubs, prob.regularization), "cpu"),
        struct=lt.Structure.of(prob), params=convert.params_from(params))
    assert got[0].shape == (B, Tn, prob.n_var) and set(got[2].flatten().tolist()) == {0}
    for g, r, name in zip(got, ref, ("x", "v", "status", "it", "n_fact", "ctr_type")):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-10, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("simple", [False, True])
def test_sensitivities_all_matches_jax(simple):
    """Every objective's multipliers from one factorization of a partly
    active working set (inactive rows are zero rows, so levels lose rank),
    against the JAX function on the JAX package's factorization of the
    same subproblem (atol 1e-10 on multipliers up to order 1e3: compact WY
    in both, another summation order)."""
    rng = np.random.default_rng(50 + simple)
    prob = jgen.random_inequality_hierarchy(rng, 8, [4, 3, 4], simple_bounds=simple)
    ts = lt.Structure.of(prob)
    B, m = 3, prob.n_ctr
    As = _batch(prob, B, rng)[0]
    ct = rng.integers(0, 3, (B, m)).astype(np.int32)
    ct[:, -2:] = 3
    A, lb, ub, ctt = convert.to_torch((As, np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1)),
                                       ct), "cpu")
    Ag, bg, fm, fv = _masked_general(A, lb, ub, ctt, d0=ts.d0, var_idx=ts.var_idx)
    f = factorize_fast_batched(Ag, bg, ts.lexlse_dims, fixed_mask=fm, fixed_val=fv)
    jf = jax_factorize(jnp.asarray(Ag.numpy()), jnp.asarray(bg.numpy()), ts.lexlse_dims,
                       JT.ParametersLexLSE(), jnp.asarray(fm.numpy()), jnp.asarray(fv.numpy()),
                       use_pallas=True, interpret=True)
    np.testing.assert_array_equal(f.ranks.numpy(), np.asarray(jf.ranks))
    _, want = jax.vmap(jlexlse.sensitivities_all)(jf, jnp.asarray(Ag.numpy()))
    got = lexlse.sensitivities_all(f)
    assert float(got.abs().max()) > 1e-3
    assert bool((f.ranks < torch.tensor(ts.lexlse_dims)).any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10, rtol=0)


@pytest.mark.parametrize("simple", [False, True])
def test_initial_activation_and_arrays_match_jax(simple):
    """The cold batch entry's host helpers: equality rows activate in row
    order (a general row with a zero normal does not), then the LB/UB
    rows of a guess; and the arrays broadcast to a batch."""
    rng = np.random.default_rng(60 + simple)
    prob = jgen.random_inequality_hierarchy(rng, 7, [4, 4, 3], simple_bounds=simple,
                                            equality_fraction=0.4)
    prob.A[-1] = 0.0
    prob.lb[-1] = prob.ub[-1] = 0.5
    guess = rng.integers(0, 4, prob.n_ctr)
    for g in (None, guess):
        for a, b in zip(lt.initial_activation(prob, g), jli.initial_activation(prob, g)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    got = lt.batched_initial_arrays(prob, 3, "cpu")
    want = jax_initial_arrays(prob, 3)
    assert [t.dtype for t in got] == [torch.int32] * 3 + [torch.float64] * 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
