"""The port's bench programs, ``bench_torch.py`` and ``bench_extra_torch.py``,
on the CPU (the kernels' plain versions).

(a) The draws: each problem builder gives exactly the arrays that
``bench.py``'s and ``bench_extra.py``'s draw order gives through the JAX
package's generator (NumPy only, nothing compiled), ``chip_smoke.py``'s
bench problem is the bench's, and a larger batch of it starts with a
smaller one.
(b) Config 2 at its full widths (n=88, dims (44, 44), a budget of 150),
float64, B=2, cold: the port's ``solve_core_fused`` (kernel B2's plain
version) against the JAX package's exact tier, ``solve_core_batched``,
which compiles and runs here in about a quarter of the time that its
``solve_core_fused(interpret=True)`` takes: statuses, iterations, working
sets and counters equal, x and v to 1e-9.  The port's cold tracked solve
against the same JAX reference by the same rule, and against the port's
fused result: working sets equal, x to 1e-9.  (Every level of config 2 is
feasible, so per-level |v_k| is about 1e-11 for any feasible x and could
not tell a wrong x or working set from the right one.)
(c) The bench's summary tuple at a small shape (n=16, dims (6, 5, 5), B=2,
T=3, float64) for ``fused`` and ``tracked``: equal to the tuple built from
``solve_sequence_batched_fused`` on the same sequence, materialized.
(d) No fallback: without a card and without ``LEXLS_BENCH_CPU`` both
programs exit non-zero and name the cause.
"""

import ast
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlsi as jli
from lexls_tpu.oracle import generate as jgen
from lexls_tpu.types import ParametersLexLSI as JParams

import lexls_tpu_torch as lt
from lexls_tpu_torch.oracle import random_inequality_hierarchy
from torch_parity import assert_state_match

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench_extra_torch as bxt  # noqa: E402
import bench_torch as bt  # noqa: E402
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64


def _np(t):
    return t.cpu().numpy()


def _jax_f32_params(**kw):
    return JParams(tol_linear_dependence=1e-7, tol_wrong_sign_lambda=1e-4,
                   tol_correct_sign_lambda=1e-6, tol_feasibility=1e-5, **kw)


# (a) the draws --------------------------------------------------------------

@pytest.mark.parametrize("B,T_max", [(1, 2), (3, 14)])
def test_bench_problem_draws_as_bench_py(B, T_max):
    """``bench.py:141-166``: the hierarchy, the drift stream from
    default_rng(1), then the B perturbed copies."""
    rng = np.random.default_rng(0)
    prob = jgen.random_inequality_hierarchy(rng, 100, [30, 30, 30, 30], equality_fraction=0.1,
                                            tight_fraction=0.3)
    drifts = 1e-3 * np.cumsum(np.random.default_rng(1).standard_normal((T_max,) + prob.A.shape),
                              axis=0)
    base = np.stack([prob.A + 1e-3 * rng.standard_normal(prob.A.shape) for _ in range(B)])
    got, gbase, gdrifts, glb, gub = bt.bench_problem(B, T_max, F64, CPU)
    np.testing.assert_array_equal(got.A, prob.A)
    np.testing.assert_array_equal(_np(gbase), base)
    np.testing.assert_array_equal(_np(gdrifts), drifts)
    np.testing.assert_array_equal(_np(glb), np.tile(prob.lb, (B, 1)))
    np.testing.assert_array_equal(_np(gub), np.tile(prob.ub, (B, 1)))
    assert got.dims == tuple(prob.dims)
    p = bt.bench_params()
    assert (p.max_number_of_factorizations, p.tol_linear_dependence, p.tol_wrong_sign_lambda,
            p.tol_correct_sign_lambda, p.tol_feasibility) == (250, 1e-7, 1e-4, 1e-6, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bench_problem_equals_chip_smoke(dtype):
    """``chip_smoke._bench_problem`` draws through ``bench_torch``: the same
    arrays and parameters, the bounds of one instance."""
    B = 5
    prob, base, drifts, lb, ub = bt.bench_problem(B, chip_smoke.T_MAX, dtype, CPU)
    cprob, cparams, cbase, cdrifts, clb, cub = chip_smoke._bench_problem(dtype, CPU, B)
    np.testing.assert_array_equal(prob.A, cprob.A)
    for a, b in ((base, cbase), (drifts, cdrifts), (lb[0], clb), (ub[0], cub)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert cparams == bt.bench_params()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bench_problem_larger_batch_extends_smaller(dtype):
    """The first B instances of a larger batch are the B of a smaller one,
    with the same hierarchy and drifts: ``chip_smoke.py`` compares runs at
    B=384 and B=10,240 on that ground."""
    small = bt.bench_problem(3, 4, dtype, CPU)
    large = bt.bench_problem(7, 4, dtype, CPU)
    np.testing.assert_array_equal(small[0].A, large[0].A)
    assert torch.equal(small[1], large[1][:3]) and torch.equal(small[2], large[2])
    for a, b in zip(small[3:], large[3:]):
        assert a.dtype == dtype and torch.equal(a, b[:3])
    assert not torch.equal(large[1][3], large[1][2])


def test_config1_draws_as_bench_extra():
    """``bench_extra.py:84-95``: A and b, then B copies of A, then B of b."""
    B = 3
    rng = np.random.default_rng(0)
    A, b, _, _, _ = jgen.random_equality_hierarchy(rng, 88, [33, 3, 2, 97])
    As = np.stack([A + 1e-3 * rng.standard_normal(A.shape) for _ in range(B)])
    bs = np.stack([b + 1e-3 * rng.standard_normal(b.shape) for _ in range(B)])
    gA, gb, params = bxt.config1_problem(B, F64, CPU)
    np.testing.assert_array_equal(_np(gA), As)
    np.testing.assert_array_equal(_np(gb), bs)
    assert params.tol_linear_dependence == 1e-7


def _jax_cold_draw(B, n, dims, **kw):
    """``bench_extra.py``'s draw of configs 2 and 3: the hierarchy, the cold
    activation, then B perturbed copies of A."""
    rng = np.random.default_rng(0)
    prob = jgen.random_inequality_hierarchy(rng, n, dims, **kw)
    ct0, st0, ns0 = jli.initial_activation(prob)
    base = np.stack([prob.A + 1e-3 * rng.standard_normal(prob.A.shape) for _ in range(B)])
    return prob, (ct0, st0, ns0), base


def _assert_cold_batch(inp, prob, act, base, B):
    ct0, st0, ns0 = act
    np.testing.assert_array_equal(_np(inp["A"]), base)
    np.testing.assert_array_equal(_np(inp["lb"]), np.tile(prob.lb, (B, 1)))
    np.testing.assert_array_equal(_np(inp["ub"]), np.tile(prob.ub, (B, 1)))
    np.testing.assert_array_equal(_np(inp["ctr_type0"]), np.tile(ct0, (B, 1)))
    np.testing.assert_array_equal(_np(inp["stamp0"]), np.tile(st0, (B, 1)))
    np.testing.assert_array_equal(_np(inp["next_stamp0"]), np.full(B, ns0))
    np.testing.assert_array_equal(_np(inp["reg"]), prob.regularization)


def test_config2_draws_as_bench_extra():
    """``bench_extra.py:126-145``."""
    B = 3
    prob, act, base = _jax_cold_draw(B, 88, [44, 44], equality_fraction=0.05,
                                     tight_fraction=0.3)
    gprob, params, inp = bxt.config2_problem(B, F64, CPU)
    np.testing.assert_array_equal(gprob.A, prob.A)
    assert gprob.dims == (44, 44) and gprob.n_var == 88
    _assert_cold_batch(inp, prob, act, base, B)
    assert (params.max_number_of_factorizations, params.tol_linear_dependence,
            params.tol_wrong_sign_lambda, params.tol_correct_sign_lambda,
            params.tol_feasibility) == (150, 1e-7, 1e-4, 1e-6, 1e-5)


def test_config3_draws_as_bench_extra():
    """``bench_extra.py:195-215``."""
    B = 3
    prob, act, base = _jax_cold_draw(B, 24, [6, 5, 5, 4, 4, 4], ranks=[4, 3, 3, 2, 2, 2],
                                     equality_fraction=0.1)
    prob.regularization = np.full(6, 0.05)
    gprob, params, inp = bxt.config3_problem(B, F64, CPU)
    np.testing.assert_array_equal(gprob.A, prob.A)
    _assert_cold_batch(inp, prob, act, base, B)
    assert params.regularization_type == lt.RegularizationType.TIKHONOV
    assert params.max_number_of_factorizations == 64


# (b) config 2 against the JAX package ------------------------------------------

@pytest.fixture(scope="module")
def config2_f64():
    """Config 2 at B=2 in float64: the port's fused solve (plain B2) and the
    JAX package's exact tier on the same NumPy inputs (one JAX program)."""
    B = 2
    params = _jax_f32_params(max_number_of_factorizations=150)
    prob, (ct0, st0, ns0), base = _jax_cold_draw(B, 88, [44, 44], equality_fraction=0.05,
                                                 tight_fraction=0.3)
    m, n = prob.n_ctr, prob.n_var
    inputs = (base, np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1)), np.tile(ct0, (B, 1)),
              np.tile(st0, (B, 1)), np.full(B, ns0, np.int32), np.zeros((B, n)),
              np.zeros((B, m)), prob.regularization)
    ref = jli.solve_core_batched(*(jnp.asarray(a) for a in inputs),
                                 struct=jli.Structure.of(prob), params=params,
                                 x_guess_specified=False, v0_specified=False)
    gprob, gparams, inp = bxt.config2_problem(B, F64, CPU)
    struct = lt.Structure.of(gprob)
    z = (torch.zeros(B, n, dtype=F64), torch.zeros(B, m, dtype=F64))
    fixed = (inp["A"], inp["lb"], inp["ub"], inp["ctr_type0"], inp["stamp0"],
             inp["next_stamp0"]) + z
    got = lt.solve_core_fused(*fixed, inp["reg"], struct=struct, params=gparams,
                              x_guess_specified=False, v0_specified=False)
    tracked, _ = lt.solve_core_cold_tracked(*fixed, struct=struct, params=gparams)
    return ref, got, tracked, gprob.dims


def test_config2_fused_matches_jax_exact_tier(config2_f64):
    ref, got, _, _ = config2_f64
    assert_state_match(ref, got, "config 2")
    assert (_np(got.status) == 0).all()
    assert int(got.it.min()) > 10  # the active set really moved


def test_config2_tracked_matches_fused(config2_f64):
    """The cold tracked solve against the JAX exact tier (integer state
    equal, x and v to 1e-9) and against the port's fused solve (working
    sets equal, x to 1e-9)."""
    ref, fused, tracked, _ = config2_f64
    assert_state_match(ref, tracked, "config 2 tracked")
    assert torch.equal(tracked.ctr_type, fused.ctr_type)
    torch.testing.assert_close(tracked.x, fused.x, atol=1e-9, rtol=0)


# (c) the summary tuple ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fused", "tracked"])
def test_summary_matches_sequence_driver(mode):
    B, T, n, dims = 2, 3, 16, (6, 5, 5)
    rng = np.random.default_rng(7)
    prob = random_inequality_hierarchy(rng, n, list(dims), equality_fraction=0.1,
                                                 tight_fraction=0.3)
    params = lt.ParametersLexLSI(max_number_of_factorizations=120)
    drifts = torch.as_tensor(1e-3 * np.cumsum(rng.standard_normal((T,) + prob.A.shape), 0))
    base = torch.as_tensor(prob.A + 1e-3 * rng.standard_normal((B,) + prob.A.shape))
    m = prob.n_ctr
    lbs = torch.as_tensor(prob.lb).expand(B, m).contiguous()
    ubs = torch.as_tensor(prob.ub).expand(B, m).contiguous()
    knobs = dict(loop_cap=1, ns_iters=2, shrink=(), handover_slab=0, trip1_noext=True)
    cold, warm = bt.make_sequence(mode, prob, params, base, drifts, lbs, ubs, knobs)
    got = bt.run_summary(cold, warm, T)

    A_seq = (base[:, None] + drifts[None]).contiguous()
    x, _, status, it, _, _ = lt.solve_sequence_batched_fused(
        A_seq, lbs[:, None].expand(B, T, m), ubs[:, None].expand(B, T, m),
        torch.as_tensor(prob.regularization), lt.Structure.of(prob), params,
        tracked=mode == "tracked", loop_cap=1, ns_iters=2, trip1_noext=True)
    want = (float(x[:, -1].contiguous().sum()), int((status == 0).sum()),
            int(it[:, 1:].sum()), int(it[:, 1:].max()), int(it[:, 0].sum()))
    assert got == want
    assert got[1] == B * T


@pytest.mark.parametrize("mode", ["fused", "native", "tracked"])
def test_stream_rate_runs_the_warm_steps(mode):
    """The stream: a cold solve and K warm steps, each rate B K over a
    positive time; every mode gives the fused mode's working sets."""
    B, T = 2, 3
    rng = np.random.default_rng(8)
    prob = random_inequality_hierarchy(rng, 10, [4, 4], tight_fraction=0.3)
    params = lt.ParametersLexLSI(max_number_of_factorizations=80)
    drifts = torch.as_tensor(1e-3 * np.cumsum(rng.standard_normal((T,) + prob.A.shape), 0))
    base = torch.as_tensor(prob.A + 1e-3 * rng.standard_normal((B,) + prob.A.shape))
    lbs = torch.as_tensor(prob.lb).expand(B, -1).contiguous()
    ubs = torch.as_tensor(prob.ub).expand(B, -1).contiguous()
    seq = {md: bt.make_sequence(md, prob, params, base, drifts, lbs, ubs, bt._knobs())
           for md in ("fused", mode)}
    med, rates = bt.stream_rate(*seq[mode], T - 1, CPU, 2)
    assert len(rates) == 2 and med > 0 and all(r > 0 for r in rates)
    want = seq["fused"][1](seq["fused"][0](), 1)[0]
    got = seq[mode][1](seq[mode][0](), 1)[0]
    assert torch.equal(got.ctr_type, want.ctr_type) and torch.equal(got.status, want.status)
    torch.testing.assert_close(got.x, want.x, atol=1e-9, rtol=0)


def test_bench_mode_line(monkeypatch, capsys):
    """One mode at B=2 on the CPU, the bench's shape cut to n=16, dims (6,
    5, 5): the JSON line in bench.py's keys plus the mode, the ``# mode=``
    line with the stream rate, and the roofline."""
    import json

    monkeypatch.setattr(bt, "N_VAR", 16)
    monkeypatch.setattr(bt, "DIMS", (6, 5, 5))
    rec = bt.bench_mode("fused", CPU, F64, 2, (2, 3), 1, bt._knobs())
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == rec
    assert set(rec) <= {"metric", "value", "unit", "vs_baseline", "mode", "slope_unreliable"}
    assert rec["metric"] == "warm_start_solves_per_s" and rec["mode"] == "fused"
    assert rec["vs_baseline"] == round(rec["value"] / 1e5, 4)
    assert "# mode=fused" in err and "stream=" in err and "solved=6/6" in err
    assert "%-of-f32-peak" in err and "%-of-f64-peak" in err and "hbm_min=" in err
    with pytest.raises(ValueError):
        bt.bench_mode("tile", CPU, F64, 2, (2, 3), 1, bt._knobs())


@pytest.mark.parametrize("env,want", [(None, ["tracked", "fused"]), ("fused", ["fused"]),
                                      ("vmap", ["native"])])
def test_modes_from_the_environment(monkeypatch, env, want):
    """``LEXLS_BENCH_MODE``: tracked then fused by default; ``vmap``, the
    same exact tier in the port, runs as ``native``."""
    if env is None:
        monkeypatch.delenv("LEXLS_BENCH_MODE", raising=False)
    else:
        monkeypatch.setenv("LEXLS_BENCH_MODE", env)
    assert bt._modes() == want


# the secondaries -------------------------------------------------------------------

@pytest.mark.parametrize("fn,mode,metric", [
    (bxt.bench_equality, None, "equality_lqr_solves_per_s"),
    (bxt.bench_inequality_cold, "tracked", "inequality_cold_solves_per_s"),
    (bxt.bench_inequality_cold, "fused", "inequality_cold_solves_per_s"),
    (bxt.bench_deep_regularized, "tracked", "deep_regularized_cold_solves_per_s"),
    (bxt.bench_deep_regularized, "exact", "deep_regularized_cold_solves_per_s"),
])
def test_secondary_records(monkeypatch, capsys, fn, mode, metric):
    """Each timed function at B=2 in float64 with one untimed run of one
    solve in place of the slope: the run's scalar finite, the record in
    bench_extra.py's keys and config string, with the counts of that run's
    non-finite x and (configs 2 and 3) instances not solved."""
    seen = []

    def one_run(run, Ns, reps, device):
        seen.append(float(run(1)))
        return 0.5

    monkeypatch.setattr(bxt, "_slope", one_run)
    rec = fn(CPU, F64, 2) if mode is None else fn(CPU, F64, 2, mode)
    assert len(seen) == 1 and np.isfinite(seen[0])
    assert rec["metric"] == metric and rec["value"] == 4.0 and rec["unit"] == "solves/s"
    # config 3's two instances end at its budget of 64 factorizations (status 2)
    want = {"equality_lqr_solves_per_s": None, "inequality_cold_solves_per_s": 0,
            "deep_regularized_cold_solves_per_s": 2}[metric]
    assert rec["nonfinite_x"] == 0 and rec.get("unsolved") == want
    if want is not None:  # the unsolved instances named, each with its counters
        assert [u["index"] for u in rec["unsolved_at"]] == list(range(want))
        assert all(u["status"] == 2 and u["n_fact"] == 64 and u["it"] > 0
                   for u in rec["unsolved_at"])
    assert rec["dtype"] == "float64" and capsys.readouterr().out.strip() == \
        __import__("json").dumps(rec)
    if mode is not None:
        assert rec["config"].endswith(mode)
        with pytest.raises(ValueError):
            fn(CPU, F64, 2, "vmap")


def test_record_names_the_first_unsolved(capsys):
    """``unsolved_at`` holds the first UNSOLVED_AT instances not solved, in
    index order, with status, iterations and factorizations; the count
    beside it counts them all, and it is empty when every instance solved."""
    import types

    status = torch.tensor([0, 2, 0, 1] + [2] * 10, dtype=torch.int32)
    state = types.SimpleNamespace(status=status, it=torch.arange(14, dtype=torch.int32),
                                  n_fact=torch.arange(14, dtype=torch.int32) + 100)
    x = torch.zeros(14, 3, dtype=F64)
    rec = bxt._record("m", 14, 1.0, "c", F64, x, state)
    want = [i for i in range(14) if status[i] != 0][:bxt.UNSOLVED_AT]
    assert rec["unsolved"] == 12 and len(rec["unsolved_at"]) == bxt.UNSOLVED_AT == 8
    assert rec["unsolved_at"] == [{"index": i, "status": int(status[i]), "it": i,
                                   "n_fact": 100 + i} for i in want]
    solved = types.SimpleNamespace(status=torch.zeros(14, dtype=torch.int32), it=state.it,
                                   n_fact=state.n_fact)
    rec = bxt._record("m", 14, 1.0, "c", F64, x, solved)
    assert rec["unsolved"] == 0 and rec["unsolved_at"] == []
    capsys.readouterr()


def test_cold_chain_moves_each_a_by_the_last_answer():
    """The bench's chain, which ``chip_smoke.py config2_chain`` replays: N
    solves, each A the one before plus 1e-9 times the NaN-free sum of its
    x, and the scalar the sum of every solve's iterations."""
    prob, params, inp = bxt.config2_problem(2, F64, CPU)
    solve = bxt.config2_solver(prob, params, inp, "fused")
    acc, steps = bxt.cold_chain(solve, inp["A"], 3)
    assert len(steps) == 3 and steps[0][0] is inp["A"]
    for (a0, s0), (a1, _) in zip(steps, steps[1:]):
        assert torch.equal(a1, a0 + 1e-9 * s0.x.nansum())
    assert float(acc) == sum(int(st.it.sum()) for _, st in steps)
    assert all(bool((st.status == 0).all()) for _, st in steps)


def test_run_all_reads_the_environment(monkeypatch):
    calls = []
    for name in ("bench_equality", "bench_inequality_cold", "bench_deep_regularized"):
        monkeypatch.setattr(bxt, name, lambda *a, name=name: calls.append((name,) + a))
    monkeypatch.setenv("LEXLS_BENCH_ONLY", "2,3")
    monkeypatch.setenv("LEXLS_BENCH_COLD_B", "7")
    monkeypatch.setenv("LEXLS_BENCH_COLD_MODE", "fused")
    monkeypatch.setenv("LEXLS_BENCH_REG_MODE", "exact")
    bxt.run_all("cpu", F64)
    assert calls == [("bench_inequality_cold", CPU, F64, 7, "fused"),
                     ("bench_deep_regularized", CPU, F64, 4, "exact")]
    monkeypatch.delenv("LEXLS_BENCH_ONLY")
    monkeypatch.delenv("LEXLS_BENCH_COLD_B")
    calls.clear()
    bxt.run_all("cpu", torch.float32)
    assert [c[0] for c in calls] == ["bench_equality", "bench_inequality_cold",
                                     "bench_deep_regularized"]
    assert [c[3] for c in calls] == [4, 4, 4]


def test_knobs_and_dtype_from_the_environment(monkeypatch):
    assert bt._knobs() == bt.TRACKED == dict(loop_cap=1, ns_iters=2, shrink=(),
                                             handover_slab=0, trip1_noext=True)
    monkeypatch.setenv("LEXLS_BENCH_SHRINK", "328, 8")
    monkeypatch.setenv("LEXLS_BENCH_LOOP_CAP", "0")
    monkeypatch.setenv("LEXLS_BENCH_TRIP1_NOEXT", "0")
    monkeypatch.setenv("LEXLS_BENCH_HANDOVER_SLAB", "352")
    monkeypatch.setenv("LEXLS_BENCH_NS_ITERS", "3")
    assert bt._knobs() == dict(loop_cap=0, ns_iters=3, shrink=(328, 8), handover_slab=352,
                               trip1_noext=False)
    assert bxt.bench_dtype() == torch.float32
    monkeypatch.setenv("LEXLS_BENCH_DTYPE", "float64")
    assert bxt.bench_dtype() == torch.float64
    monkeypatch.setenv("LEXLS_BENCH_DTYPE", "bfloat16")
    with pytest.raises(ValueError):
        bxt.bench_dtype()


# (d) no fallback, and no JAX ------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a card")
@pytest.mark.parametrize("script", ["bench_torch.py", "bench_extra_torch.py"])
def test_without_a_card_exits_nonzero(script):
    env = {k: v for k, v in os.environ.items() if k != "LEXLS_BENCH_CPU"}
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert "LEXLS_BENCH_CPU=1" in r.stderr
    assert r.stdout == ""


@pytest.mark.parametrize("script", ["bench_torch.py", "bench_extra_torch.py"])
def test_imports_neither_jax_nor_the_jax_package(script):
    tree = ast.parse((REPO / script).read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "lexls_tpu")], names
    assert {n.split(".")[0] for n in names} <= {
        "contextlib", "json", "os", "statistics", "sys", "time", "numpy", "torch",
        "lexls_tpu_torch", "bench_extra_torch"}
