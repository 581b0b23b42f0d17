"""The port's host API against the JAX package's, in float64 on the CPU.

``lexls_tpu_torch.solve`` (the exact tier on a batch of one, kernel B1's
plain version on the CPU) against ``lexls_tpu.solve`` on the shapes of
``test_jax_lexlsi.py``: status, working set, the four counters and the
log equal, x and v to 1e-10.  Then ``use_phase1_v0``, the trace and its
export (``test_aux_surface.py``), the multipliers and the wrong-sign
collection at arbitrary working sets (``test_collect_wrong_sign.py``), and
the working-set replay (``lexls_tpu/wset.py``).  One shape per option set,
so that the trials of a set share the JAX package's compilation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlsi as jli
import lexls_tpu.wset as jwset
from lexls_tpu import types as JT
from lexls_tpu.oracle import generate as jgen

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert, wset
from lexls_tpu_torch.lexlsi import collect_wrong_sign, get_lambda

torch.set_num_threads(1)

TOL = 1e-10


def _pair(prob, params=None, **kw):
    params = params or JT.ParametersLexLSI()
    ref = jli.solve(prob, params, **kw)
    got = lt.solve(prob, convert.params_from(params), device="cpu", **kw)
    return ref, got


def _assert_result_match(ref, got):
    assert got.status == ref.status
    np.testing.assert_array_equal(got.ctr_type, np.asarray(ref.ctr_type))
    for f in ("n_iterations", "n_activations", "n_deactivations", "n_factorizations",
              "cycling_counter", "log_overflow"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("x", "v", "lb", "ub"):
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(ref, f)), atol=TOL,
                                   rtol=0, err_msg=f)
    assert len(got.working_set_log) == len(ref.working_set_log)
    for a, b in zip(got.working_set_log, ref.working_set_log):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert abs(da.pop("alpha_or_lambda") - db.pop("alpha_or_lambda")) <= TOL
        assert da == db


def _perturbed(prob, rng, scale=1e-3):
    return JT.InequalityHierarchy(
        A=prob.A + scale * rng.standard_normal(prob.A.shape), lb=prob.lb, ub=prob.ub,
        dims=prob.dims, n_var=prob.n_var, simple_bounds=prob.simple_bounds,
        var_idx=prob.var_idx)


# (problem maker, parameters) per case; the seeds of test_jax_lexlsi.py
_LOG = dict(log_working_set_enabled=True)
_CASES = {
    "general": (lambda s: jgen.random_inequality_hierarchy(
        np.random.default_rng(s), 8, [4, 3, 3]), _LOG),
    "rank_deficient": (lambda s: jgen.random_inequality_hierarchy(
        np.random.default_rng(100 + s), 10, [5, 4, 4], ranks=[3, 2, 2]), _LOG),
    "simple_bounds": (lambda s: jgen.random_inequality_hierarchy(
        np.random.default_rng(200 + s), 8, [4, 4, 3], simple_bounds=True), _LOG),
    "deactivate_first": (lambda s: jgen.random_inequality_hierarchy(
        np.random.default_rng(300 + s), 8, [4, 3, 3]),
        dict(_LOG, deactivate_first_wrong_sign=True)),
    "cycling": (lambda s: jgen.random_inequality_hierarchy(
        np.random.default_rng(800 + s), 10, [4, 4, 4], equality_fraction=0.1,
        tight_fraction=0.7), dict(_LOG, cycling_handling_enabled=True)),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_solve_matches_jax(case):
    """Cold solves, two seeds a case (the second reuses the compilation)."""
    make, kw = _CASES[case]
    params = JT.ParametersLexLSI(**kw)
    for seed in range(2):
        prob = make(seed)
        ref, got = _pair(prob, params)
        assert got.status == lt.TerminationStatus.PROBLEM_SOLVED
        _assert_result_match(ref, got)
        if case == "general":
            assert len(got.working_set_log) == got.n_activations + got.n_deactivations


def test_solve_warm_start_and_repair_match_jax():
    """A warm start from the cold solve's working set and x on a perturbed
    problem, and a wrong guess under the hot-start repair flags
    (``test_jax_lexlsi.py:68-96``)."""
    rng = np.random.default_rng(400)
    prob = jgen.random_inequality_hierarchy(rng, 8, [4, 3, 3])
    cold = lt.solve(prob, device="cpu")
    guess = np.where(cold.ctr_type == int(lt.CtrType.ACTIVE_EQ), int(lt.CtrType.INACTIVE),
                     cold.ctr_type)
    ref, got = _pair(_perturbed(prob, rng), x0=cold.x.copy(), active_guess=guess)
    assert got.n_iterations <= 6
    _assert_result_match(ref, got)

    params = JT.ParametersLexLSI(modify_type_active_enabled=True,
                                 modify_type_inactive_enabled=True)
    guess = np.zeros(prob.n_ctr, dtype=np.int64)
    guess[::3] = int(JT.CtrType.ACTIVE_UB)
    ref, got = _pair(prob, params, x0=rng.standard_normal(prob.n_var), active_guess=guess)
    _assert_result_match(ref, got)


def test_solve_budget_matches_jax():
    """A budget of two factorizations ends MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED
    with a finite x."""
    prob = jgen.random_inequality_hierarchy(np.random.default_rng(0), 8, [4, 3, 3])
    ref, got = _pair(prob, JT.ParametersLexLSI(max_number_of_factorizations=2))
    assert got.status == lt.TerminationStatus.MAX_NUMBER_OF_FACTORIZATIONS_EXCEEDED
    assert np.isfinite(got.x).all()
    _assert_result_match(ref, got)


@pytest.mark.parametrize("seed", range(3))
def test_phase1_v0_matches_jax(seed):
    """``use_phase1_v0`` (``test_jax_lexlsi.py:99-104``): phase 1 takes the
    guess and counts no factorization; iteration 0 keeps its step."""
    rng = np.random.default_rng(600 + seed)
    prob = jgen.random_inequality_hierarchy(rng, 8, [4, 3, 3])
    params = JT.ParametersLexLSI(use_phase1_v0=True, trace_enabled=True)
    ref, got = _pair(prob, params, x0=rng.standard_normal(prob.n_var))
    _assert_result_match(ref, got)
    tr = got.trace()
    np.testing.assert_array_equal(tr["dx"][0], 0.0)
    assert tr["op"][0] != int(lt.OperationType.REMOVE)


def test_phase1_v0_needs_a_guess():
    prob = jgen.random_inequality_hierarchy(np.random.default_rng(600), 8, [4, 3, 3])
    with pytest.raises(lt.LexLSError):
        lt.solve(prob, lt.ParametersLexLSI(use_phase1_v0=True), device="cpu")


def test_trace_and_export_match_jax(tmp_path):
    """Every trace array against the JAX package's (x, v, dx, dv, alpha to
    1e-10; op and row equal), and the MATLAB export read back
    (``test_aux_surface.py:45-60``)."""
    rng = np.random.default_rng(7)
    prob = jgen.random_inequality_hierarchy(rng, 8, [3, 3], equality_fraction=0.1,
                                            tight_fraction=0.5)
    ref, got = _pair(prob, JT.ParametersLexLSI(trace_enabled=True))
    _assert_result_match(ref, got)
    want, tr = ref.trace(), got.trace()
    assert tr["x"].shape == (got.n_iterations, prob.n_var) and got.n_iterations > 2
    for key in ("op", "row"):
        np.testing.assert_array_equal(tr[key], want[key], err_msg=key)
    for key in ("x", "v", "dx", "dv", "alpha"):
        np.testing.assert_allclose(tr[key], want[key], atol=TOL, rtol=0, err_msg=key)

    out = tmp_path / "trace.m"
    got.export_trace(str(out))
    text = out.read_text()
    assert f"% nIterations     = {got.n_iterations}" in text
    assert text.count("stepLength_(") == got.n_iterations
    last = [ln for ln in text.splitlines() if ln.startswith(f"x_(:,{got.n_iterations})")][0]
    vals = [float(v) for v in last.split("[ ")[1].split(" ];")[0].split("; ")]
    np.testing.assert_allclose(vals, got.x, atol=1e-12)
    ref.export_trace(str(tmp_path / "ref.m"))
    assert [ln for ln in text.splitlines() if ln.startswith("operation_(")] == [
        ln for ln in (tmp_path / "ref.m").read_text().splitlines()
        if ln.startswith("operation_(")]
    with pytest.raises(lt.LexLSError):
        lt.solve(prob, device="cpu").trace()


def _random_active_set(rng, prob, share=0.5):
    """An arbitrary (not optimal) working set, as ``test_collect_wrong_sign.py``
    draws it: EQ rows stay, a ``share`` of the rest at a random side."""
    ct = prob.initial_ctr_type().astype(np.int32)
    free = np.where(ct == int(JT.CtrType.INACTIVE))[0]
    pick = rng.choice(free, size=max(1, int(len(free) * share)), replace=False)
    ct[pick] = rng.choice([int(JT.CtrType.ACTIVE_LB), int(JT.CtrType.ACTIVE_UB)],
                          size=len(pick))
    return ct


def _at(prob, ct):
    """The port's (A, lb, ub, ctr_type) of one working set, batch of one."""
    return convert.to_torch((prob.A[None], prob.lb[None], prob.ub[None], ct[None]), "cpu")


# the JAX package runs it op by op; compiled, the trials share one program
_jax_collect = jax.jit(jli.collect_wrong_sign, static_argnames=("struct", "params"))


def _compare_collect(prob, ct, params):
    """``collect_wrong_sign`` of both packages at one working set: identical
    booleans, λ to 1e-9.  Returns whether any wrong sign was found."""
    struct = jli.Structure.of(prob)
    want = _jax_collect(
        jnp.asarray(prob.A), jnp.asarray(prob.lb), jnp.asarray(prob.ub), jnp.asarray(ct),
        jnp.asarray(prob.regularization), struct, params)
    got = collect_wrong_sign(*_at(prob, ct), torch.as_tensor(prob.regularization),
                             lt.Structure.of(prob), convert.params_from(params))
    assert got[0].shape == (1, prob.n_ctr, prob.n_obj)
    for g, w, name in zip(got[:2], want[:2], ("wrong", "marked")):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(want[2]), atol=1e-9, rtol=1e-9)
    return bool(got[0].any())


@pytest.mark.parametrize("seed", range(3))
def test_collect_parity_general(seed):
    rng = np.random.default_rng(900 + seed)
    prob = jgen.random_inequality_hierarchy(rng, 8, [4, 3, 3])
    _compare_collect(prob, _random_active_set(rng, prob), JT.ParametersLexLSI())


def test_collect_parity_simple_bounds():
    rng = np.random.default_rng(910)
    prob = jgen.random_inequality_hierarchy(rng, 8, [5, 4, 3], simple_bounds=True)
    _compare_collect(prob, _random_active_set(rng, prob), JT.ParametersLexLSI())


def test_collect_finds_wrong_signs_somewhere():
    """Fully activated working sets give wrong-sign multipliers (m > n), so
    the parity above is not vacuous."""
    found = False
    for seed in range(3):
        rng = np.random.default_rng(920 + seed)
        prob = jgen.random_inequality_hierarchy(rng, 8, [4, 3, 3])
        ct = prob.initial_ctr_type().astype(np.int32)
        free = np.where(ct == int(JT.CtrType.INACTIVE))[0]
        ct[free] = rng.choice([int(JT.CtrType.ACTIVE_LB), int(JT.CtrType.ACTIVE_UB)],
                              size=len(free))
        found = _compare_collect(prob, ct, JT.ParametersLexLSI()) or found
    assert found


def test_collect_empty_at_optimum():
    """At the solved working set no wrong-sign multiplier is left (the
    solver's own termination test, ``lexlsi.h:1229``), through the host
    wrapper."""
    prob = jgen.random_inequality_hierarchy(np.random.default_rng(930), 8, [4, 3, 3])
    res = lt.solve(prob, device="cpu")
    assert res.status == lt.TerminationStatus.PROBLEM_SOLVED
    wrong, marked, lam = lt.solve_collect_wrong_sign(prob, res, device="cpu")
    assert wrong.shape == marked.shape == lam.shape == (prob.n_ctr, prob.n_obj)
    assert not wrong.any()


@pytest.mark.parametrize("case", ["general", "simple_bounds", "tikhonov"])
def test_lambda_matches_jax(case):
    """``get_lambda`` at an arbitrary working set of more active rows than
    variables (1e-9), and
    ``solve_lambda`` at a solve's final one, against the JAX package's:
    general levels, a simple-bounds level (its rows take the fixed
    variables' multipliers, its column is zero), and a TIKHONOV working
    set (the damped factorization's multipliers)."""
    rng = np.random.default_rng({"general": 940, "simple_bounds": 941, "tikhonov": 942}[case])
    prob = jgen.random_inequality_hierarchy(rng, 8, [4, 4, 3],
                                            simple_bounds=case == "simple_bounds")
    params = JT.ParametersLexLSI()
    if case == "tikhonov":
        params = JT.ParametersLexLSI(regularization_type=JT.RegularizationType.TIKHONOV)
        prob.regularization = np.array([0.3, 0.2, 0.1])
    struct, ct = jli.Structure.of(prob), _random_active_set(rng, prob, share=0.9)
    want = jli.get_lambda(jnp.asarray(prob.A), jnp.asarray(prob.lb), jnp.asarray(prob.ub),
                          jnp.asarray(ct), jnp.asarray(prob.regularization), struct, params)
    got = get_lambda(*_at(prob, ct), torch.as_tensor(prob.regularization),
                     lt.Structure.of(prob), convert.params_from(params))
    assert got.shape == (1, prob.n_ctr, prob.n_obj) and float(got.abs().max()) > 1e-3
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-9, rtol=1e-9)
    if case == "simple_bounds":
        np.testing.assert_array_equal(got[0, :, 0].numpy(), 0.0)

    # the JAX package's host wrapper reads only the result's working set and
    # bounds, so it takes the port's result (no JAX solve to compile)
    res = lt.solve(prob, convert.params_from(params), device="cpu")
    np.testing.assert_allclose(lt.solve_lambda(prob, res, convert.params_from(params),
                                               device="cpu"),
                               np.asarray(jli.solve_lambda(prob, res, params)), atol=1e-9,
                               rtol=1e-9)


@pytest.mark.parametrize("simple", [False, True])
def test_working_set_replay_matches_jax(simple):
    """``replay_working_set`` over the log of a solve, at every prefix and
    whole (it ends at the final working set), and ``solve_with_working_set``
    there: x and v to 1e-10 against the JAX package's.  Both replay the
    port's log (the logs themselves are held equal in
    ``test_solve_matches_jax``)."""
    rng = np.random.default_rng(950 + simple)
    prob = jgen.random_inequality_hierarchy(rng, 8, [4, 4, 3], simple_bounds=simple)
    got = lt.solve(prob, lt.ParametersLexLSI(log_working_set_enabled=True), device="cpu")
    assert len(got.working_set_log) > 2
    for upto in list(range(len(got.working_set_log))) + [None]:
        ct = wset.replay_working_set(prob, got.working_set_log, upto)
        np.testing.assert_array_equal(ct, jwset.replay_working_set(prob, got.working_set_log,
                                                                   upto))
    np.testing.assert_array_equal(ct, got.ctr_type)
    x, v = wset.solve_with_working_set(prob, ct, device="cpu")
    xr, vr = jwset.solve_with_working_set(prob, ct, dtype=jnp.float64)
    np.testing.assert_allclose(x, xr, atol=TOL, rtol=0)
    np.testing.assert_allclose(v, vr, atol=TOL, rtol=0)
    np.testing.assert_allclose(x, got.x, atol=1e-8, rtol=0)


def test_host_entry_points_need_a_device(monkeypatch):
    """Without a card and without ``device="cpu"`` every host entry point
    raises: none falls back to the CPU on its own."""
    prob = jgen.random_inequality_hierarchy(np.random.default_rng(0), 6, [3, 3])
    res = lt.solve(prob, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: lt.solve(prob), lambda: lt.solve_lambda(prob, res),
                 lambda: lt.solve_collect_wrong_sign(prob, res),
                 lambda: wset.solve_with_working_set(prob, res.ctr_type)):
        with pytest.raises(lt.LexLSError):
            call()
