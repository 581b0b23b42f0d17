"""The tracker's pyramid (``shrink``), slab handover (``handover_slab``)
and fall diagnostics (``debug_fall``): the port against the JAX package.

One drive for every case: ``tests/test_tracker.py::_drive``'s trial 2
problem at B=12, float64, warm steps whose A drifts by 1e-4 and whose
bounds move by O(1), with three re-orthonormalization passes, so that most
carries are accepted and the working-set changes take several trips (alive
after the first trip: 8, 9 and 7 instances of 12).  Both trackers start
from the same carried factorization (the JAX package's kernel in
interpret mode, the port's kernel B2 through its plain version).  Whole
solves: statuses, iterations and working sets equal, per-level residual
norms to 1e-7, carried positions and ranks equal, carried inverse factors
to 1e-8 (``test_torch_tracker.py::_assert_solve_match``).  Each distinct
``shrink``/``handover_slab``/``loop_cap``/``debug_fall`` is a JAX
compilation, so the JAX side runs a few configurations and the rest hold
the port against itself: results must not depend on the slab sizes."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlsi as jli
from lexls_tpu import sequence as jseq
from lexls_tpu import tracker as jtrk
from lexls_tpu import types as JT
from lexls_tpu.oracle import generate as jgen
from lexls_tpu.parallel import batched_initial_arrays

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert
from lexls_tpu_torch import tracker as ttrk
from lexls_tpu_torch.parallel.batch import SEQUENCE_KNOBS, SOLVER_KNOBS
from lexls_tpu_torch.sequence import _device_initial_activation
from test_torch_tracker import _assert_solve_match, _level_norms

torch.set_num_threads(1)

TRIAL, B, STEPS, NS = 2, 12, 3, 3
A_KICK, BOUND_KICK = 1e-4, 1.0


def _t(a):
    return convert.to_torch(np.array(a), "cpu")


@functools.lru_cache(maxsize=None)
def _case():
    """The problem as ``tests/test_tracker.py::_drive`` draws trial 2, B
    drifted copies, and per warm step A, lb and ub (equality and bound rows
    keep their bounds).  NumPy."""
    rng = np.random.default_rng(900 + TRIAL)
    n = int(rng.integers(6, 14))
    p = int(rng.integers(2, 5))
    dims = [int(rng.integers(2, 7)) for _ in range(p)]
    simple = bool(rng.random() < 0.4) and dims[0] <= n
    ranks = ([min(d, int(rng.integers(1, d + 1))) for d in dims] if rng.random() < 0.5 else None)
    prob = jgen.random_inequality_hierarchy(
        rng, n, dims, ranks=ranks, equality_fraction=rng.random() * 0.3,
        tight_fraction=rng.random() * 0.5, simple_bounds=simple)
    params = JT.ParametersLexLSI(max_number_of_factorizations=80,
                                 deactivate_first_wrong_sign=bool(rng.random() < 0.5))
    d0 = jli.Structure.of(prob).d0

    def drift(scale):  # general rows only: bound rows stay unit rows
        d = scale * rng.standard_normal(prob.A.shape)
        d[:d0] = 0.0
        return d

    base = np.stack([prob.A + drift(5e-3) for _ in range(B)])
    steps, A = [], base
    fixed = (prob.lb == prob.ub) | (np.arange(prob.n_ctr) < d0)
    for _ in range(STEPS):
        A = A + np.stack([drift(A_KICK) for _ in range(B)])
        shift = np.where(fixed, 0.0, BOUND_KICK * rng.standard_normal((B, prob.n_ctr)))
        steps.append((A, prob.lb + shift, prob.ub + shift))
    return prob, params, base, steps


@functools.lru_cache(maxsize=None)
def _bootstrap():
    """The JAX package's cold solve of ``base`` through its kernel and the
    carried factorization of its final working sets, NumPy."""
    prob, params, base, _ = _case()
    c0, s0, n0, xz, v0 = batched_initial_arrays(prob, B, jnp.float64)
    lbs, ubs = jnp.asarray(np.tile(prob.lb, (B, 1))), jnp.asarray(np.tile(prob.ub, (B, 1)))
    st, factors = jli.solve_core_fused(
        jnp.asarray(base), lbs, ubs, c0, s0, n0, xz, v0, jnp.asarray(prob.regularization),
        struct=jli.Structure.of(prob), params=params, x_guess_specified=False,
        v0_specified=False, tile=B, interpret=True, return_factors=True)
    car = jtrk.bootstrap_carried(factors)
    return (np.array(st.x), np.array(st.ctr_type)) + tuple(np.array(a) for a in car)


@functools.lru_cache(maxsize=None)
def _jax_drive(**kw):
    """The JAX tracker's warm steps with the static options ``kw``: per
    step (state, carried, debug arrays or None), NumPy."""
    prob, params, _, steps = _case()
    js = jli.Structure.of(prob)
    x, ct, *car = _bootstrap()
    car = jtrk.Carried(*(jnp.asarray(a) for a in car))
    x, ct = jnp.asarray(x), jnp.asarray(ct)
    act = jax.vmap(lambda a, l_, u, g: jseq._device_initial_activation(a, l_, u, g, js))
    v0 = jnp.zeros((B, prob.n_ctr))
    out = []
    for A, lb, ub in steps:
        A, lb, ub = jnp.asarray(A), jnp.asarray(lb), jnp.asarray(ub)
        c, s_, ns = act(A, lb, ub, ct)
        r = jtrk.solve_core_tracked(A, lb, ub, c, s_, ns, x, v0, carried=car, struct=js,
                                    params=params, tile=B, interpret=True, ns_iters=NS, **kw)
        st, car = r[0], r[1]
        x, ct = st.x, st.ctr_type
        dbg = tuple(np.asarray(a) for a in r[2]) if len(r) > 2 else None
        out.append((jax.tree_util.tree_map(np.asarray, st),
                    jtrk.Carried(*(np.asarray(a) for a in car)), dbg))
    return out


def _port_drive(params=None, reg=None, stats=None, **kw):
    """The port's tracker over the same warm steps from the same carried
    factorization: per step the return value of ``solve_core_tracked``."""
    prob, jparams, _, steps = _case()
    ts = lt.Structure.of(prob)
    x, ct, *car = (_t(a) for a in _bootstrap())
    car = lt.Carried(*car)
    v0 = torch.zeros(B, prob.n_ctr, dtype=torch.float64)
    out = []
    for A, lb, ub in steps:
        A, lb, ub = _t(A), _t(lb), _t(ub)
        c, s_, ns = _device_initial_activation(A, lb, ub, ct, ts)
        r = lt.solve_core_tracked(A, lb, ub, c, s_, ns, x, v0, carried=car, struct=ts,
                                  params=params or convert.params_from(jparams), ns_iters=NS,
                                  stats=stats, reg=reg, **kw)
        car = r[1]
        x, ct = r[0].x, r[0].ctr_type
        out.append(r)
    return out


def _match_jax(port_kw, jax_kw=None, stats=None):
    ts = lt.Structure.of(_case()[0])
    got = _port_drive(stats=stats, **port_kw)
    for t, (g, w) in enumerate(zip(got, _jax_drive(**(jax_kw or port_kw)))):
        _assert_solve_match(g[0], g[1], w[0], w[1], ts, f"{port_kw} step {t}")
    return got


def test_drive_takes_several_trips():
    """The drive this file rests on: every warm step leaves instances alive
    after the first trip and takes more trips, and some carries fall."""
    stats = []
    out = _port_drive(stats=stats, debug_fall=True)
    assert all(trips >= 2 for trips, _ in stats), stats
    assert all(0 < int(r[2][0].sum()) < B for r in out)
    assert all(int((r[0].status == 0).sum()) == B for r in out)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(shrink=(6, 3)),               # 8-9 alive after trip 1: overflow at both slabs
    dict(shrink=(10, 5), loop_cap=3),  # a valid pyramid, the cap trimming it
], ids=["undersized", "with_loop_cap"])
def test_shrink_matches_jax(kw):
    stats = []
    _match_jax(kw, stats=stats)
    if kw.get("loop_cap"):
        assert all(trips <= kw["loop_cap"] for trips, _ in stats), stats


@pytest.mark.parametrize("loop_cap,slab", [(0, 0), (2, 8)])
def test_debug_fall_matches_jax(loop_cap, slab):
    """``(fall, fall_trip, fall_why)`` equal to the JAX package's; with
    ``loop_cap=2`` the capped instances are in ``fall`` with no trip or
    reason, and ``handover_slab=8`` takes the slab branch on some steps and
    the full-width one on others."""
    kw = dict(loop_cap=loop_cap, handover_slab=slab, debug_fall=True)
    stats = []
    got = _match_jax(kw, stats=stats)
    for t, (g, w) in enumerate(zip(got, _jax_drive(**kw))):
        for name, a, b in zip(("fall", "fall_trip", "fall_why"), g[2], w[2]):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{name} step {t}")
    handed = [n for _, n in stats]
    if slab:
        assert min(handed) <= slab < max(handed), handed
    else:
        assert all(int((g[2][1] > 0).sum()) == int(g[2][0].sum()) for g in got)


def test_cold_debug_fall_matches_jax():
    prob, params, base, _ = _case()
    js, ts = jli.Structure.of(prob), lt.Structure.of(prob)
    cold = batched_initial_arrays(prob, B, jnp.float64)
    lbs, ubs = np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1))
    stj, car_j, dbg_j = jtrk.solve_core_cold_tracked(
        jnp.asarray(base), jnp.asarray(lbs), jnp.asarray(ubs), *cold, struct=js, params=params,
        tile=B, interpret=True, ns_iters=NS, debug_fall=True)
    stt, car_t, dbg_t = lt.solve_core_cold_tracked(
        *(_t(a) for a in (base, lbs, ubs) + tuple(cold)), struct=ts,
        params=convert.params_from(params), ns_iters=NS, debug_fall=True)
    _assert_solve_match(stt, car_t, stj, car_j, ts, "cold")
    for name, a, b in zip(("fall", "fall_trip", "fall_why"), dbg_t, dbg_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert bool(dbg_t[0].any())


def test_sequence_with_shrink_and_slab_matches_jax():
    """``solve_sequence_batched_fused(tracked=True)`` forwards ``shrink``
    and ``handover_slab`` to every warm step: T=3 (the cold step and the
    first two warm steps of the drive) against the JAX package's."""
    prob, params, base, steps = _case()
    A_seq = np.stack([base] + [a for a, _, _ in steps[:2]], 1)
    lb_seq = np.stack([np.tile(prob.lb, (B, 1))] + [lb for _, lb, _ in steps[:2]], 1)
    ub_seq = np.stack([np.tile(prob.ub, (B, 1))] + [ub for _, _, ub in steps[:2]], 1)
    kw = dict(tracked=True, ns_iters=NS, shrink=(6, 3), handover_slab=8)
    want = jseq.solve_sequence_batched_fused(
        jnp.asarray(A_seq), jnp.asarray(lb_seq), jnp.asarray(ub_seq),
        jnp.asarray(prob.regularization), struct=jli.Structure.of(prob), params=params,
        tile=B, interpret=True, vmem_limit_mb=0, **kw)
    stats = []
    got = lt.solve_sequence_batched_fused(
        *convert.to_torch((A_seq, lb_seq, ub_seq, prob.regularization), "cpu"),
        struct=lt.Structure.of(prob), params=convert.params_from(params), stats=stats, **kw)
    assert len(stats) == 3 and bool((got[2] == 0).all())
    for i, (w, g) in enumerate(zip(want, got)):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-8, rtol=0,
                                       err_msg=str(i))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(i))


# ---------------------------------------------------------------------------
# The port against itself: slab sizes change no result
# ---------------------------------------------------------------------------


def _assert_same_results(got, want, msg):
    ts = lt.Structure.of(_case()[0])
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0].status.numpy(), w[0].status.numpy(),
                                      err_msg=f"{msg} step {t}")
        np.testing.assert_allclose(_level_norms(g[0].v.numpy(), ts),
                                   _level_norms(w[0].v.numpy(), ts), atol=1e-7,
                                   err_msg=f"{msg} step {t}")


@functools.lru_cache(maxsize=None)
def _plain_runs():
    return {cap: _port_drive(loop_cap=cap) for cap in (0, 1, 2)}


@pytest.mark.parametrize("kw", [
    dict(shrink=(11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1)),
    dict(shrink=(1,)),
    dict(shrink=(9, 2)),
    dict(handover_slab=1),
    dict(handover_slab=11),
    dict(shrink=(8, 4), handover_slab=10),
    dict(shrink=(6,), loop_cap=2),
    dict(handover_slab=4, loop_cap=1),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()).replace(" ", ""))
def test_slab_sizes_change_no_result(kw):
    """Statuses and per-level residual norms equal to the run with
    neither option and the same ``loop_cap``."""
    _assert_same_results(_port_drive(**kw), _plain_runs()[kw.get("loop_cap", 0)], str(kw))


def test_pyramid_trips_only_the_slab():
    """The slab trips run on the gathered rows only, one trip per size
    while any instance is alive, and the stragglers beyond a slab fall."""
    widths = []
    real = ttrk._trip

    def spy(c, A, **kw):
        widths.append(A.shape[0])
        return real(c, A, **kw)

    stats = []
    ttrk._trip = spy
    try:
        _port_drive(shrink=(6, 3), stats=stats)
    finally:
        ttrk._trip = real
    per_step, i = [], 0
    for trips, _ in stats:
        per_step.append(widths[i:i + trips])
        i += trips
    assert i == len(widths)
    for w in per_step:
        assert w[:2] == [B, 6] and set(w[2:]) <= {3}, per_step
    assert any(3 in w for w in per_step), per_step


def test_handover_slab_launches_b2_at_slab_width():
    """B2 runs on S rows when S or fewer instances are unresolved, the
    unresolved ones first; the resolved ones outside the slab keep the
    tracker's state exactly."""
    from lexls_tpu_torch.ops import fused as fused_mod

    rows, real = [], fused_mod.fused_active_set

    def spy(A, *args, **kw):
        rows.append(A.shape[0])
        return real(A, *args, **kw)

    stats = []
    fused_mod.fused_active_set = spy
    try:
        got = _port_drive(handover_slab=9, stats=stats)
    finally:
        fused_mod.fused_active_set = real
    assert rows == [9 if n <= 9 else B for _, n in stats] and 9 in rows and B in rows, (rows, stats)
    for g, w in zip(got, _plain_runs()[0]):
        assert all(torch.equal(getattr(g[0], f.name), getattr(w[0], f.name))
                   for f in dataclasses.fields(g[0])), "the slab changed a state"
        assert all(torch.equal(a, b) for a, b in zip(g[1], w[1]))


def test_shrink_under_tikhonov_changes_no_result():
    """Under TIKHONOV the pyramid runs with the shared factors and its
    leftovers go to the exact tier; ``handover_slab`` has no effect."""
    prob, jparams, _, _ = _case()
    params = dataclasses.replace(convert.params_from(jparams),
                                 regularization_type=lt.RegularizationType.TIKHONOV)
    reg = torch.full((len(prob.dims),), 0.05, dtype=torch.float64)
    stats, stats_s = [], []
    want = _port_drive(params=params, reg=reg, stats=stats)
    got = _port_drive(params=params, reg=reg, stats=stats_s, shrink=(6, 3), handover_slab=8)
    _assert_same_results(got, want, "TIKHONOV")
    assert max(t for t, _ in stats) >= 2 and sum(n for _, n in stats) > 0, stats


# ---------------------------------------------------------------------------
# What the options refuse, and who forwards them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shrink", [(12,), (6, 6), (3, 6), (0,), (4, -1)],
                         ids=lambda z: str(z).replace(" ", ""))
def test_bad_shrink_sizes_raise(shrink):
    with pytest.raises(lt.LexLSError, match="shrink sizes must be strictly decreasing and < B"):
        _port_drive(shrink=shrink)


def test_debug_fall_with_shrink_raises():
    with pytest.raises(lt.LexLSError, match="debug_fall with shrink unsupported"):
        _port_drive(shrink=(6,), debug_fall=True)


def test_knobs_are_the_jax_trackers():
    """The sequence factory takes ``shrink`` and ``handover_slab`` for the
    tracked mode; the cold solvers' factories do not (nor does JAX's cold
    tracker)."""
    import inspect

    assert {"shrink", "handover_slab"} <= set(SEQUENCE_KNOBS["tracked"])
    assert not {"shrink", "handover_slab"} & set(SOLVER_KNOBS["tracked"])
    warm = set(inspect.signature(lt.solve_core_tracked).parameters)
    cold = set(inspect.signature(lt.solve_core_cold_tracked).parameters)
    assert {"shrink", "handover_slab", "debug_fall"} <= warm and "debug_fall" in cold
    assert not {"shrink", "handover_slab"} & cold
    with pytest.raises(lt.LexLSError, match="shrink"):
        lt.make_sharded_solver(None, None, lt.ParametersLexLSI(), mode="tracked", shrink=(2,))


def test_sharded_sequence_forwards_shrink_and_slab(tmp_path):
    """``make_sharded_sequence_solver(mode="tracked", shrink=...,
    handover_slab=...)`` on a one-rank gloo group gives the unsharded
    sequence's outputs exactly."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    prob, jparams, base, steps = _case()
    A_seq = _t(np.stack([base] + [a for a, _, _ in steps], 1))
    lb_seq = _t(np.stack([np.tile(prob.lb, (B, 1))] + [lb for _, lb, _ in steps], 1))
    ub_seq = _t(np.stack([np.tile(prob.ub, (B, 1))] + [ub for _, _, ub in steps], 1))
    struct, params = lt.Structure.of(prob), convert.params_from(jparams)
    kw = dict(ns_iters=NS, shrink=(6, 3), handover_slab=8)
    want = lt.solve_sequence_batched_fused(A_seq, lb_seq, ub_seq, None, struct, params,
                                           tracked=True, **kw)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("batch",))
        fn = lt.make_sharded_sequence_solver(mesh, struct, params, mode="tracked", **kw)
        got, metrics = fn(A_seq, lb_seq, ub_seq, None)
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(metrics["solved"]) == B * (STEPS + 1)
