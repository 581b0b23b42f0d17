"""The port's whole-solve tier against the JAX package's.

On the CPU ``solve_core_fused`` runs kernel B2's plain version; the JAX
side runs ``solve_core_fused(interpret=True)``, its Pallas kernel in
interpret mode (as ``tests/test_fused.py`` runs it).  Float64: statuses,
iteration counts, working sets, stamps and counters equal; x and v to
atol 1e-9.  With the working-set log and cycling handling on: log
entries, lengths, flags, the detector's state and the relaxed bounds
equal, the logged values to 1e-9."""

import os

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
from lexls_tpu_torch.sequence import _device_initial_activation
from torch_parity import assert_log_match, assert_state_match

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
])
def test_fused_rejects_unsupported(bad):
    rng = np.random.default_rng(13)
    prob = jgen.random_inequality_hierarchy(rng, 8, [3, 3])
    params = lt.ParametersLexLSI(**bad)
    args = convert.to_torch(_inputs(prob, 2, rng), "cpu")
    with pytest.raises(lt.LexLSError):
        lt.solve_core_fused(*args, struct=lt.Structure.of(prob), params=params,
                            x_guess_specified=False, v0_specified=False)


@pytest.mark.parametrize("trial", range(4))
def test_fused_simple_bounds_match_jax(trial):
    """Hierarchies whose level 0 is simple bounds (d0 > 0): fixed
    variables in phase 1 and in the active-set loop, their multipliers on
    the bound rows; cold (even trials) and from a guess, which also runs
    the x-guess repair on the bounded variables.  Trial 3 has a level
    with more rows than variables (K = n, as the test_01 shape)."""
    rng = np.random.default_rng(7100 + trial)
    n = 7 if trial == 3 else int(rng.integers(6, 12))
    dims = [int(rng.integers(2, n + 1))] + ([3, 9] if trial == 3 else
                                            [int(rng.integers(2, 6)) for _ in range(2)])
    prob = jgen.random_inequality_hierarchy(rng, n, dims, simple_bounds=True,
                                            equality_fraction=0.2, tight_fraction=0.6)
    params = JT.ParametersLexLSI(max_number_of_factorizations=100,
                                 deactivate_first_wrong_sign=trial == 1)
    x0 = rng.standard_normal(n) if trial % 2 else None
    inputs = _inputs(prob, 3, rng, x0)
    inputs[0][:, :prob.dims[0]] = prob.A[:prob.dims[0]]  # bound rows stay unit rows
    ref, got = _run_pair(prob, params, inputs, x0 is not None)
    assert int(got.it.max()) > 1
    assert_state_match(ref, got, trial)


@pytest.mark.parametrize("trial", range(4))
def test_fused_working_set_log_matches_jax(trial):
    """The working-set log entry for entry (test_fused.py:186-203) on
    shapes that add and remove constraints; odd trials have a
    simple-bounds level (objective 0 of the log) and remove the first
    activated constraint, whose logged value is 0."""
    rng = np.random.default_rng(500 + trial)
    n, dims = 9, [4, 3, 4]  # one shape: trials with equal options share a compilation
    simple = trial % 2 == 1
    prob = jgen.random_inequality_hierarchy(
        rng, n, dims, equality_fraction=0.1, tight_fraction=0.5 + 0.2 * rng.random(),
        simple_bounds=simple)
    params = JT.ParametersLexLSI(max_number_of_factorizations=60, log_working_set_enabled=True,
                                 deactivate_first_wrong_sign=trial == 3)
    inputs = _inputs(prob, 3, rng)
    inputs[0][:, :prob.dims[0] * simple] = prob.A[:prob.dims[0] * simple]
    ref, got = _run_pair(prob, params, inputs, False)
    assert int(got.log_len.sum()) > 0 and got.log_obj.shape == (3, 62)
    assert_state_match(ref, got, trial)
    assert_log_match(ref, got, trial)


@pytest.mark.parametrize("trial", range(4))
def test_fused_cycling_state_matches_jax(trial):
    """Cycling handling with the log on (test_fused.py:206-232): the
    detector's state and the bounds, relaxed or not, on trajectories that
    add and remove; trial 3 also has a simple-bounds level."""
    rng = np.random.default_rng(700 + trial)
    n, dims = 9, [4, 3, 4]  # one shape: trials with equal options share a compilation
    simple = trial == 3
    prob = jgen.random_inequality_hierarchy(
        rng, n, dims, equality_fraction=0.1, tight_fraction=0.5 + 0.2 * rng.random(),
        simple_bounds=simple)
    params = JT.ParametersLexLSI(max_number_of_factorizations=60, cycling_handling_enabled=True,
                                 log_working_set_enabled=trial != 2)
    inputs = _inputs(prob, 3, rng)
    inputs[0][:, :prob.dims[0] * simple] = prob.A[:prob.dims[0] * simple]
    ref, got = _run_pair(prob, params, inputs, False)
    assert_state_match(ref, got, trial)
    assert_log_match(ref, got, trial, cycling=True)
    assert bool((got.cyc_prev_op != 0).any())


_CYC_NPZ = os.path.join(os.path.dirname(__file__), "golden", "cycling_fixtures.npz")


def _cycling_fixture(max_counter):
    """The frozen degenerate instance (n=4, dims (2, 3)) whose removal is
    followed by the addition of the same row and type
    (test_fused.py:235-254): problem, parameters and NumPy inputs."""
    fz = np.load(_CYC_NPZ)
    A, lb, ub, guess = (fz["relax_once_A"], fz["relax_once_lb"], fz["relax_once_ub"],
                        fz["relax_once_guess"])
    prob = JT.InequalityHierarchy(A=A, lb=lb, ub=ub, dims=(2, 3), n_var=4)
    params = JT.ParametersLexLSI(max_number_of_factorizations=60, cycling_handling_enabled=True,
                                 log_working_set_enabled=True, cycling_max_counter=max_counter)
    tA, tlb, tub, tguess = convert.to_torch((A[None], lb[None], ub[None], guess[None]), "cpu")
    c0, s0, n0 = _device_initial_activation(tA, tlb, tub, tguess, lt.Structure.of(prob))
    inputs = (A[None], lb[None], ub[None], c0.numpy(), s0.numpy(), n0.numpy(),
              np.zeros((1, 4)), np.zeros((1, 5)), prob.regularization)
    return prob, params, inputs


@pytest.mark.parametrize("fix", ["relax_once", "over_max_counter"])
def test_fused_cycling_relax_matches_jax(fix):
    """A forced cycle (test_fused.py:255-311): one relaxation of the
    removed bound by ``cycling_relax_step``, counter 1 and the log entry
    flagged; with ``cycling_max_counter=0`` the first detection ends the
    solve as PROBLEM_SOLVED_CYCLING_HANDLING."""
    prob, params, inputs = _cycling_fixture(50 if fix == "relax_once" else 0)
    ref, got = _run_pair(prob, params, inputs, False)
    if fix == "relax_once":
        assert got.cyc_counter.tolist() == [1] and got.status.tolist() == [0]
        assert int(got.log_cycling.sum()) == 1
        assert float((got.lb - torch.as_tensor(inputs[1])).abs().sum()
                     + (got.ub - torch.as_tensor(inputs[2])).abs().sum()) > 0
    else:
        assert got.cyc_counter.tolist() == [0]
        assert got.status.tolist() == [int(JT.TerminationStatus.PROBLEM_SOLVED_CYCLING_HANDLING)]
    assert_state_match(ref, got, fix)
    assert_log_match(ref, got, fix, cycling=True)


def test_fused_sequence_honours_log_and_cycling():
    """``solve_sequence_batched_fused(tracked=False)`` takes both options
    through ``params`` and returns what it returns without them when no
    cycle occurs (the options only record)."""
    rng = np.random.default_rng(41)
    prob = jgen.random_inequality_hierarchy(rng, 8, [3, 4], tight_fraction=0.5)
    A_seq = np.stack([np.stack([prob.A + 2e-3 * (t + 1) * rng.standard_normal(prob.A.shape)
                                for t in range(3)]) for _ in range(2)])
    bounds = [np.broadcast_to(b, (2, 3, prob.n_ctr)).copy() for b in (prob.lb, prob.ub)]
    args = convert.to_torch((A_seq, *bounds, prob.regularization), "cpu")
    struct = lt.Structure.of(prob)
    plain = lt.solve_sequence_batched_fused(*args, struct=struct, params=lt.ParametersLexLSI())
    both = lt.solve_sequence_batched_fused(
        *args, struct=struct, params=lt.ParametersLexLSI(log_working_set_enabled=True,
                                                         cycling_handling_enabled=True))
    for a, b in zip(plain, both):
        assert torch.equal(a, b)


def _active_set_pair(prob, params, B, rng, inputs=None, **kw):
    """Kernel B2 of both packages from one phase-1 state (the port's plain
    version; the JAX kernel in interpret mode): returns a function
    ``run(state_arrays, it0, iter_cap, log_state, cyc_state, bounds) ->
    (jax outputs, port result)``; the last three default to an empty log,
    the initial detector and the problem's bounds."""
    from lexls_tpu.ops import fused as jfused
    from lexls_tpu_torch.active_set import active_set_kwargs
    from lexls_tpu_torch.lexlsi import _initial_state
    from lexls_tpu_torch.ops import fused_active_set

    if inputs is None:
        inputs = _inputs(prob, B, rng)
        d0 = prob.dims[0] * prob.simple_bounds
        inputs[0][:, :d0] = prob.A[:d0]
    A, lb, ub, c0, s0, n0, x0, v0, _ = convert.to_torch(inputs, "cpu")
    tstruct, tparams = lt.Structure.of(prob), convert.params_from(params)
    s = _initial_state(A, lb, ub, c0, s0, n0, x0, v0, tstruct, tparams, False, False)
    jstruct = jli.Structure.of(prob)
    p = len(jstruct.lexlse_dims)
    jkw = dict(
        dims=jstruct.lexlse_dims, d0=jstruct.d0,
        var_idx=jstruct.var_idx if jstruct.simple_bounds else (),
        tol_ld=params.tol_linear_dependence, tol_feas=params.tol_feasibility,
        tol_wrong=params.tol_wrong_sign_lambda, tol_correct=params.tol_correct_sign_lambda,
        max_fact=params.max_number_of_factorizations,
        deact_first=params.deactivate_first_wrong_sign,
        prio=tuple(tuple(int(q) for q in jstruct.sweep_priority(j)) for j in range(p)),
        elig=tuple(tuple(bool(e) for e in jstruct.sweep_eligible(j)) for j in range(p)),
        tile=B, interpret=True,
        log_cap=(params.max_number_of_factorizations + 2
                 if params.log_working_set_enabled else 0),
        cycling=params.cycling_handling_enabled, cyc_max=params.cycling_max_counter,
        cyc_relax=params.cycling_relax_step)
    tkw = active_set_kwargs(tstruct, tparams, "cpu")

    def run(state, it0, iter_cap, log_state=None, cyc_state=None, bounds=(lb, ub), jax=True):
        ct, st, ns, x, v, Ax, nf = state
        got = fused_active_set(A, *bounds, ct, st, ns, x, v, Ax, nf, it0, log_state, cyc_state,
                               iter_cap=iter_cap, **tkw)
        if not jax:
            return None, got
        # the JAX kernel takes per-instance scalars as (B, 1)
        jstate = lambda ts: None if ts is None else tuple(  # noqa: E731
            jnp.asarray(t.numpy().reshape(B, -1)) for t in ts)
        want = jfused.fused_active_set(
            jnp.asarray(A.numpy()), *(jnp.asarray(b.numpy()) for b in bounds),
            *(jnp.asarray(a.numpy()) for a in (ct, st, ns, x, v, Ax, nf)),
            it0=None if it0 is None else jnp.asarray(it0.numpy()), iter_cap=iter_cap,
            log_state=jstate(log_state), cyc_state=jstate(cyc_state), **jkw)
        return want, got

    return run, (s.ctr_type, s.stamp, s.next_stamp, s.x, s.v, s.Ax, s.n_fact)


def _assert_active_set_match(want, got, msg):
    """JAX kernel outputs (a tuple, scalars as (B, 1)) against the port's
    ActiveSetResult: ints exactly, floats to 1e-9, the exported R on
    [:rank, :rank] to 1e-9."""
    for i, f in enumerate(got._fields[:14]):
        w, g = np.asarray(want[i]), getattr(got, f).numpy()
        w = w.reshape(g.shape)
        if g.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}:{f}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-9, rtol=0, err_msg=f"{msg}:{f}")
    rpad, posf, ranks = (np.asarray(a) for a in want[14:17])
    np.testing.assert_array_equal(got.posf.numpy(), posf, err_msg=f"{msg}:posf")
    np.testing.assert_array_equal(got.ranks.numpy(), ranks, err_msg=f"{msg}:ranks")
    assert got.rpad.shape == rpad.shape
    for b in range(ranks.shape[0]):
        for k in range(ranks.shape[1]):
            r = ranks[b, k]
            np.testing.assert_allclose(got.rpad[b, k, :r, :r].numpy(), rpad[b, k, :r, :r],
                                       atol=1e-9, rtol=0, err_msg=f"{msg}:rpad[{b},{k}]")
    # the bounds, the log and the detector (the JAX kernel pads a log that
    # is off to one unused entry; the port's is empty)
    for i, f in enumerate(got._fields[17:], start=17):
        g = getattr(got, f).numpy()
        if g.size == 0:
            continue
        w = np.asarray(want[i]).reshape(g.shape)
        if g.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}:{f}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-9 if f == "log_value" else 0, rtol=0,
                                       err_msg=f"{msg}:{f}")


@pytest.mark.parametrize("simple", [False, True])
def test_active_set_pause_resume_and_export_match_jax(simple):
    """``iter_cap=1`` pauses after one iteration with status UNKNOWN and
    exports the factorization of the initial working set; resuming with
    ``it0`` runs to the end and counts a factorization per resumed
    iteration.  Both calls against the JAX kernel, and their sum against
    one uninterrupted call."""
    rng = np.random.default_rng(8200 + simple)
    prob = jgen.random_inequality_hierarchy(rng, 9, [4, 3, 4], simple_bounds=simple,
                                            equality_fraction=0.4, tight_fraction=0.6)
    params = JT.ParametersLexLSI(max_number_of_factorizations=60)
    run, state0 = _active_set_pair(prob, params, 4, rng)
    want1, got1 = run(state0, None, 1)
    _assert_active_set_match(want1, got1, "capped")
    assert bool((got1.it == 1).all()) and bool((got1.ranks.sum(1) > 0).all())
    assert set(got1.status.tolist()) <= {-1, 0}
    state1 = (got1.ctr_type, got1.stamp, got1.next_stamp, got1.x, got1.v, got1.Ax, got1.n_fact)
    want2, got2 = run(state1, got1.it, 0)
    _assert_active_set_match(want2, got2, "resumed")
    _, whole = run(state0, None, 0, jax=False)  # the port alone: its JAX side is unused
    unfinished = got1.status == -1
    assert bool(unfinished.any())
    for f in ("status", "it", "ctr_type", "stamp", "next_stamp", "n_fact", "posf", "ranks"):
        a, b = getattr(got2, f)[unfinished], getattr(whole, f)[unfinished]
        assert torch.equal(a, b), f
    assert torch.equal((got1.n_act + got2.n_act)[unfinished], whole.n_act[unfinished])
    assert torch.equal((got1.n_deact + got2.n_deact)[unfinished], whole.n_deact[unfinished])
    torch.testing.assert_close(got2.x[unfinished], whole.x[unfinished], atol=1e-12, rtol=0)


def test_active_set_parked_instance_keeps_its_inputs():
    """An instance with ``it0 > 0`` and its factorization budget spent is
    not alive: the call returns its inputs, zero counters, status UNKNOWN
    and the empty export, as the JAX kernel does."""
    rng = np.random.default_rng(8300)
    prob = jgen.random_inequality_hierarchy(rng, 8, [3, 4], tight_fraction=0.6)
    params = JT.ParametersLexLSI(max_number_of_factorizations=40)
    run, state0 = _active_set_pair(prob, params, 3, rng)
    ct, st, ns, x, v, Ax, nf = state0
    it0 = torch.tensor([0, 2, 0], dtype=torch.int32)
    nf = torch.where(it0 > 0, 40, nf).to(torch.int32)
    want, got = run((ct, st, ns, x, v, Ax, nf), it0, 0)
    _assert_active_set_match(want, got, "parked")
    assert got.status.tolist()[1] == -1 and got.it.tolist()[1] == 2
    assert torch.equal(got.x[1], x[1]) and torch.equal(got.ctr_type[1], ct[1])
    assert torch.equal(got.posf[1], torch.arange(8, dtype=torch.int32))
    assert float(got.rpad[1].abs().max()) == 0.0 and int(got.ranks[1].sum()) == 0


def _log_of(r):
    return (r.log_obj, r.log_ctr, r.log_type, r.log_value, r.log_rank, r.log_cycling,
            r.log_len, r.log_overflow)


def _cyc_of(r):
    return (r.cyc_counter, r.cyc_prev_op, r.cyc_prev_row, r.cyc_prev_type)


def _state_of(r):
    return (r.ctr_type, r.stamp, r.next_stamp, r.x, r.v, r.Ax, r.n_fact)


def test_active_set_pause_resume_with_log_and_cycling_match_jax():
    """A call paused by ``iter_cap`` and resumed with ``it0``,
    ``log_state`` and ``cyc_state`` retraces the uninterrupted call, log
    and detector included; both calls against the JAX kernel."""
    rng = np.random.default_rng(8400)
    prob = jgen.random_inequality_hierarchy(rng, 9, [4, 3, 4], equality_fraction=0.1,
                                            tight_fraction=0.6)
    params = JT.ParametersLexLSI(max_number_of_factorizations=60, log_working_set_enabled=True,
                                 cycling_handling_enabled=True)
    run, state0 = _active_set_pair(prob, params, 3, rng)
    want1, got1 = run(state0, None, 3)
    _assert_active_set_match(want1, got1, "capped")
    unfinished = got1.status == -1
    assert bool(unfinished.any()) and int(got1.log_len.sum()) > 0
    want2, got2 = run(_state_of(got1), got1.it, 0, _log_of(got1), _cyc_of(got1),
                      (got1.lb, got1.ub))
    _assert_active_set_match(want2, got2, "resumed")
    _, whole = run(state0, None, 0, jax=False)
    for f in ("status", "it", "ctr_type", "stamp", "lb", "ub") + whole._fields[19:]:
        a, b = getattr(got2, f)[unfinished], getattr(whole, f)[unfinished]
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0, msg=f)


def test_active_set_cycle_detected_across_a_pause():
    """The forced cycle with a pause after every iteration: the removal
    and the addition that completes the pair fall into different calls,
    and the chain ends where the uninterrupted call ends (which
    ``test_fused_cycling_relax_matches_jax`` holds against the JAX
    package)."""
    prob, params, inputs = _cycling_fixture(50)
    run, state0 = _active_set_pair(prob, params, 1, None, inputs=inputs)
    _, whole = run(state0, None, 0, jax=False)
    assert whole.cyc_counter.tolist() == [1] and whole.status.tolist() == [0]
    _, r = run(state0, None, 1, jax=False)
    calls = 1
    while r.status.tolist() == [-1]:
        _, r = run(_state_of(r), r.it, 1, _log_of(r), _cyc_of(r), (r.lb, r.ub), jax=False)
        calls += 1
    assert calls == int(whole.it) > 2
    for f in ("status", "it", "ctr_type", "stamp", "x", "lb", "ub") + whole._fields[19:]:
        torch.testing.assert_close(getattr(r, f), getattr(whole, f), atol=1e-12, rtol=0, msg=f)
