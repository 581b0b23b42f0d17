"""The port's carried-factorization tracker against the JAX package's.

The same NumPy inputs go through ``lexls_tpu.tracker`` (its Pallas kernel
in interpret mode) and ``lexls_tpu_torch.tracker`` (kernel B2's plain
version on the CPU).  Float64.  Pieces: outputs to 1e-10, ints and bools
equal.  Whole solves: statuses, iteration counts and final working sets
equal (in float64 both trackers take the same accept/fall decisions on
these seeds), per-level residual norms to 1e-7 (the repo's criterion,
``tests/test_tracker.py``), carried positions and ranks equal and the
carried inverse factors to 1e-8 (two evaluation orders of the same
Newton-refined inverse)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlsi as jli
from lexls_tpu import sequence as jseq
from lexls_tpu import tracker as jtrk
from lexls_tpu import types as JT
from lexls_tpu.ops import tri as jtri
from lexls_tpu.oracle import generate as jgen
from lexls_tpu.parallel import batched_initial_arrays

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert
from lexls_tpu_torch import tracker as ttrk
from lexls_tpu_torch.active_set import _select_removal, active_set_kwargs, kmax
from lexls_tpu_torch.ops.tri import tri_inv_upper
from lexls_tpu_torch.sequence import _device_initial_activation

torch.set_num_threads(1)


def _t(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _close(got, want, atol=1e-10, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0, err_msg=msg)


def _equal(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def _upper(rng, shape, K):
    R = np.triu(rng.standard_normal(shape + (K, K)))
    R[..., np.arange(K), np.arange(K)] = rng.uniform(0.5, 2.0, shape + (K,)) * rng.choice(
        [-1.0, 1.0], shape + (K,))
    return R


def test_tri_inv_upper_matches_jax():
    rng = np.random.default_rng(0)
    R = _upper(rng, (3, 2), 7) + np.tril(rng.standard_normal((3, 2, 7, 7)), -1)
    got = tri_inv_upper(_t(R))
    _close(got, jtri.tri_inv_upper(jnp.asarray(R)))
    _close(got @ torch.triu(_t(R)), np.broadcast_to(np.eye(7), R.shape), atol=1e-12)
    assert tri_inv_upper(_t(R[..., :1, :1])).shape == (3, 2, 1, 1)


def test_bootstrap_carried_matches_jax():
    """The masked-identity padding: garbage at and beyond the rank of the
    exported R must not reach the inverse."""
    rng = np.random.default_rng(1)
    B, p, K, n = 5, 3, 6, 9
    rpad = _upper(rng, (B, p), K) + np.tril(rng.standard_normal((B, p, K, K)), -1)
    ranks = rng.integers(0, K + 1, (B, p)).astype(np.int32)
    pos = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    want = jtrk.bootstrap_carried((jnp.asarray(rpad), jnp.asarray(pos), jnp.asarray(ranks)))
    got = ttrk.bootstrap_carried((_t(rpad), _t(pos), _t(ranks)))
    _close(got.rinv, want.rinv)
    _equal(got.pos, want.pos)
    _equal(got.ranks, want.ranks)
    back = convert.carried_from_numpy(*convert.carried_to_numpy(got), "cpu")
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(back, got))


def _ortho_pair(G, live2, us):
    """Both packages' ``_orthonormalize_z`` on the rank-1 terms ``us``; a
    single term goes to the JAX function as its ``u``/``s1`` pair."""
    jus = [(jnp.asarray(u), jnp.asarray(s)) for u, s in us]
    jk = dict(u=jus[0][0], s1=jus[0][1]) if len(jus) == 1 else dict(us=jus or None)
    Zt, ct = ttrk._orthonormalize_z(_t(G), _t(live2), 2, [(_t(u), _t(s)) for u, s in us])
    Zj, cj = jtrk._orthonormalize_z(jnp.asarray(G), jnp.asarray(live2), 2, **jk)
    return (Zt, ct), (np.asarray(Zj), np.asarray(cj))


def _live2(rng, B, K):
    """A live block per instance: rank K for the first two, random after."""
    r = np.concatenate([[K, K], rng.integers(1, K + 1, B - 2)])
    live = np.arange(K)[None, :] < r[:, None]
    return (live[:, :, None] & live[:, None, :]).astype(np.float64)


def test_orthonormalize_z_drift_matches_jax():
    rng = np.random.default_rng(7)
    K, B = 10, 5
    M = np.eye(K) + 1e-3 * rng.standard_normal((B, K, K))
    G = np.swapaxes(M, 1, 2) @ M
    (Zt, ct), (Zj, cj) = _ortho_pair(G, _live2(rng, B, K), [])
    _close(Zt, Zj)
    _close(ct, cj, atol=1e-12)
    assert float(ct.max()) < 1e-7 and torch.equal(Zt, torch.triu(Zt))


@pytest.mark.parametrize("mag", (0.3, 5.0))
def test_orthonormalize_z_activation_spike_matches_jax(mag):
    rng = np.random.default_rng(11)
    K, B = 10, 5
    u = mag * rng.standard_normal((B, K)) / np.sqrt(K)
    D = 1e-4 * rng.standard_normal((B, K, K))
    G = np.eye(K) + u[:, :, None] * u[:, None, :] + D + np.swapaxes(D, 1, 2)
    (Zt, ct), (Zj, cj) = _ortho_pair(G, np.ones((B, K, K)), [(u, np.ones((B, 1)))])
    _close(Zt, Zj)
    _close(ct, cj, atol=1e-12)
    assert float(ct.max()) < 1e-7


@pytest.mark.parametrize("mag", (0.3, 0.95))
def test_orthonormalize_z_removal_downdate_matches_jax(mag):
    """A downdate, then two more rank-1 terms given in the original frame
    (the below-level absorption's sequence)."""
    rng = np.random.default_rng(13)
    K, B = 10, 5
    u = rng.standard_normal((B, K))
    u = mag * u / np.linalg.norm(u, axis=1, keepdims=True)
    w = 0.2 * rng.standard_normal((B, K))
    G = np.eye(K) - u[:, :, None] * u[:, None, :] + w[:, :, None] * w[:, None, :]
    us = [(u, -np.ones((B, 1))), (w, np.ones((B, 1))), (np.zeros((B, K)), -np.ones((B, 1)))]
    (Zt, ct), (Zj, cj) = _ortho_pair(G, _live2(rng, B, K), us)
    _close(Zt, Zj)
    _close(ct, cj, atol=1e-12)
    assert float(ct[:2].max()) < 1e-7  # the full-rank instances hold the exact identity


def test_orthonormalize_z_rank_loss_fails_the_certificate():
    """A downdate that destroys rank gives t <= 0, a NaN from the square
    root, and a certificate that compares false against any tolerance, in
    both packages."""
    K, B = 8, 4
    u = np.zeros((B, K))
    u[:, 2] = 1.05
    G = np.eye(K) - u[:, :, None] * u[:, None, :]
    (Zt, ct), (Zj, cj) = _ortho_pair(G, np.ones((B, K, K)), [(u, -np.ones((B, 1)))])
    assert bool(torch.isnan(ct).all()) and bool(np.isnan(cj).all())
    assert not bool((ct < 1e-3).any())
    # amax carries the NaN on, as jnp.max does
    assert bool(torch.isnan(torch.tensor([[1.0, float("nan")]]).amax((-2, -1))))


@pytest.mark.parametrize("simple", [False, True])
def test_delete_last_pivot_matches_jax(simple):
    rng = np.random.default_rng(21 + simple)
    n, dims, B = 9, [3, 4, 2, 3], 6
    prob = jgen.random_inequality_hierarchy(rng, n, dims, simple_bounds=simple)
    mg = prob.n_ctr - (dims[0] if simple else 0)
    p = len(dims) - simple
    ranks = rng.integers(0, 3, (B, p)).astype(np.int32)
    pos = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    hot = np.zeros((B, mg))
    hot[np.arange(B - 1), rng.integers(0, mg, B - 1)] = 1.0  # the last instance removes nothing
    wp, wr = jtrk._delete_last_pivot(jnp.asarray(pos), jnp.asarray(ranks),
                                     jnp.asarray(hot, jnp.float32), jli.Structure.of(prob))
    gp, gr = ttrk._delete_last_pivot(_t(pos), _t(ranks), _t(hot), lt.Structure.of(prob))
    _equal(gp, wp)
    _equal(gr, wr)
    assert gp.dtype == torch.int32 and gr.dtype == torch.int32
    assert int((gr != _t(ranks)).sum()) > 0


@pytest.mark.parametrize("simple", [False, True])
@pytest.mark.parametrize("deact_first", [False, True])
def test_select_removal_matches_jax(simple, deact_first):
    rng = np.random.default_rng(31 + 2 * simple + deact_first)
    n, dims, B = 8, [3, 3, 4], 12
    prob = jgen.random_inequality_hierarchy(rng, n, dims, simple_bounds=simple)
    js, ts = jli.Structure.of(prob), lt.Structure.of(prob)
    m, d0, p = prob.n_ctr, js.d0, len(js.lexlse_dims)
    lam = rng.standard_normal((B, p, m - d0)) * (rng.random((B, p, m - d0)) < 0.5)
    lam[:3] = np.abs(lam[:3]) * 0.0  # no wrong sign anywhere: nothing found
    ct = rng.integers(0, 4, (B, m)).astype(np.int32)
    st = np.stack([rng.permutation(m) for _ in range(B)]).astype(np.int32)
    Agm = rng.standard_normal((B, m - d0, n))
    fixed = np.zeros((B, n), bool)
    if simple:
        fixed[:, list(js.var_idx)] = np.isin(ct[:, :d0], (1, 2, 3))
    params = JT.ParametersLexLSI(deactivate_first_wrong_sign=deact_first,
                                 tol_wrong_sign_lambda=1e-8, tol_correct_sign_lambda=1e-12)
    wf, wrow = jtrk._select_removal(jnp.asarray(lam), jnp.asarray(ct), jnp.asarray(st),
                                    jnp.asarray(Agm), jnp.asarray(fixed), js, params)
    gf, grow, _ = _select_removal(_t(lam), _t(ct), _t(st), _t(Agm), _t(fixed),
                                  **active_set_kwargs(ts, convert.params_from(params), "cpu"))
    _equal(gf, wf)
    _equal(grow, wrow)
    assert bool(gf.any()) and not bool(gf[:3].any())


def test_default_cert_tol_and_kmax_match_jax():
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64),
                     (torch.bfloat16, jnp.bfloat16)):
        assert ttrk.default_cert_tol(tdt) == jtrk.default_cert_tol(jdt)
    prob = jgen.random_inequality_hierarchy(np.random.default_rng(0), 5, [2, 9, 3])
    ts = lt.Structure.of(prob)
    assert kmax(ts.lexlse_dims, ts.n_var) == jtrk.kmax_of(jli.Structure.of(prob)) == 5


# ---------------------------------------------------------------------------
# Whole solves
# ---------------------------------------------------------------------------


def _level_norms(v, struct):
    dims = ([struct.d0] if struct.simple_bounds else []) + list(struct.lexlse_dims)
    edges = np.cumsum([0] + dims)
    return np.stack([np.linalg.norm(v[:, a:b], axis=1) for a, b in zip(edges, edges[1:])], 1)


def _assert_solve_match(stt, carried_t, stj, carried_j, struct, msg):
    for f in ("status", "it", "ctr_type"):
        _equal(getattr(stt, f), getattr(stj, f), f"{msg}:{f}")
    np.testing.assert_allclose(_level_norms(stt.v.numpy(), struct),
                               _level_norms(np.asarray(stj.v), struct), atol=1e-7, err_msg=msg)
    _equal(carried_t.pos, carried_j.pos, f"{msg}:pos")
    _equal(carried_t.ranks, carried_j.ranks, f"{msg}:ranks")
    _close(carried_t.rinv, carried_j.rinv, atol=1e-8, msg=f"{msg}:rinv")


@pytest.mark.parametrize("trial,kicks,loop_cap,trip1_noext", [
    (0, (0.003, 0.005, 0.004), 0, False),   # small drift: carries accepted
    (1, (0.05, 0.3, 0.05), 1, False),       # kicks: working-set changes, handover at the cap
    (2, (0.05, 0.3, 0.05), 2, False),
    (3, (0.05, 0.3, 0.05), 1, True),        # the bench's knobs
])
def test_tracked_matches_jax_tracker(trial, kicks, loop_cap, trip1_noext):
    """Drifting warm solves driven as ``tests/test_tracker.py::_drive``
    drives them (random shapes, rank deficiency, simple bounds in some
    trials), both trackers from the same carried factorization."""
    rng = np.random.default_rng(900 + trial)
    n = int(rng.integers(6, 14))
    p = int(rng.integers(2, 5))
    dims = [int(rng.integers(2, 7)) for _ in range(p)]
    simple = bool(rng.random() < 0.4) and dims[0] <= n
    if trial == 2:
        # trial 0's shape (and, as drawn, its options): the two share the JAX
        # package's compilation of the bootstrap solve
        n, dims = 10, [4, 2]
    ranks = ([min(d, int(rng.integers(1, d + 1))) for d in dims] if rng.random() < 0.5 else None)
    prob = jgen.random_inequality_hierarchy(
        rng, n, dims, ranks=ranks, equality_fraction=rng.random() * 0.3,
        tight_fraction=rng.random() * 0.5, simple_bounds=simple)
    js, ts = jli.Structure.of(prob), lt.Structure.of(prob)
    params = JT.ParametersLexLSI(max_number_of_factorizations=80,
                                 deactivate_first_wrong_sign=bool(rng.random() < 0.5))
    tparams = convert.params_from(params)
    B, m = 6, prob.n_ctr
    c0, s0, n0, xz, v0 = batched_initial_arrays(prob, B, jnp.float64)

    def drift(scale):  # general rows only: bound rows stay unit rows
        d = scale * rng.standard_normal(prob.A.shape)
        d[:js.d0] = 0.0
        return d

    base = np.stack([prob.A + drift(5e-3) for _ in range(B)])
    lbs, ubs = np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1))
    jl, ju = jnp.asarray(lbs), jnp.asarray(ubs)
    stj, factors = jli.solve_core_fused(
        jnp.asarray(base), jl, ju, c0, s0, n0, xz, v0, jnp.asarray(prob.regularization),
        struct=js, params=params, x_guess_specified=False, v0_specified=False, tile=B,
        interpret=True, return_factors=True)
    car_j = jtrk.bootstrap_carried(factors)
    car_t = convert.carried_from_numpy(*car_j, "cpu")
    jact = jax.vmap(lambda a, l, u, g: jseq._device_initial_activation(a, l, u, g, js))
    xj, ctj = stj.x, stj.ctr_type
    xt, ctt = _t(xj), _t(ctj)
    tl, tu, tv0 = _t(lbs), _t(ubs), _t(v0)
    stats = []
    for step, kick in enumerate(kicks):
        A_t = base + drift(kick)
        c, s_, ns = jact(jnp.asarray(A_t), jl, ju, ctj)
        stj, car_j = jtrk.solve_core_tracked(
            jnp.asarray(A_t), jl, ju, c, s_, ns, xj, v0, carried=car_j, struct=js,
            params=params, tile=B, interpret=True, loop_cap=loop_cap, trip1_noext=trip1_noext)
        c, s_, ns = _device_initial_activation(_t(A_t), tl, tu, ctt, ts)
        stt, car_t = lt.solve_core_tracked(
            _t(A_t), tl, tu, c, s_, ns, xt, tv0, carried=car_t, struct=ts, params=tparams,
            loop_cap=loop_cap, trip1_noext=trip1_noext, stats=stats)
        _assert_solve_match(stt, car_t, stj, car_j, ts, f"trial {trial} step {step}")
        xj, ctj, xt, ctt = stj.x, stj.ctr_type, stt.x, stt.ctr_type
    assert len(stats) == len(kicks) and all(0 <= fell <= B for _, fell in stats)
    if loop_cap:
        assert all(trips <= loop_cap for trips, _ in stats)


@pytest.mark.parametrize("trial", range(3))
def test_cold_tracked_matches_jax_tracker(trial):
    """Cold solves through the tracker loop (one capped kernel iteration,
    its exported factors, then trips with greedy extension), as
    ``tests/test_tracker.py::test_cold_tracked_matches_xla`` sets them up."""
    rng = np.random.default_rng(300 + trial)
    n = int(rng.integers(8, 16))
    dims = [int(rng.integers(3, 7)) for _ in range(int(rng.integers(2, 5)))]
    simple = bool(rng.random() < 0.4) and dims[0] <= n
    if trial == 2:
        # trial 1's shape: the two share the JAX package's compilation
        n, dims, simple = 9, [3, 3, 4], False
    prob = jgen.random_inequality_hierarchy(
        rng, n, dims, equality_fraction=rng.random() * 0.2,
        tight_fraction=0.3 + rng.random() * 0.3, simple_bounds=simple)
    js, ts = jli.Structure.of(prob), lt.Structure.of(prob)
    params = JT.ParametersLexLSI(max_number_of_factorizations=80)
    B = 4
    c0, s0, n0, xz, v0 = batched_initial_arrays(prob, B, jnp.float64)
    As = np.stack([prob.A.copy() for _ in range(B)])
    for b in range(B):
        d = 1e-2 * rng.standard_normal(prob.A.shape)
        d[:js.d0] = 0
        As[b] += d
    lbs, ubs = np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1))
    stj, car_j = jtrk.solve_core_cold_tracked(
        jnp.asarray(As), jnp.asarray(lbs), jnp.asarray(ubs), c0, s0, n0, xz, v0, struct=js,
        params=params, tile=B, interpret=True)
    stats = []
    stt, car_t = lt.solve_core_cold_tracked(
        *(_t(a) for a in (As, lbs, ubs, c0, s0, n0, xz, v0)), struct=ts,
        params=convert.params_from(params), stats=stats)
    _assert_solve_match(stt, car_t, stj, car_j, ts, f"cold trial {trial}")
    # in trial 0 every carry is rejected at the first trip and the kernel
    # finishes the solve; in the others the tracker loop takes further trips
    assert int(stt.it.max()) > 2 and (trial == 0 or stats[0][0] > 1)
    for f in ("n_act", "n_deact", "n_fact", "next_stamp", "stamp"):
        _equal(getattr(stt, f), getattr(stj, f), f)


@pytest.mark.parametrize("simple", [False, True])
def test_tracked_sequence_matches_jax(simple):
    """``solve_sequence_batched_fused(tracked=True)`` on a 3-step
    sequence: statuses and counters equal, x and v to 1e-8."""
    rng = np.random.default_rng(40 + simple)
    prob = jgen.random_inequality_hierarchy(rng, 10, [4, 4, 4], equality_fraction=0.15,
                                            tight_fraction=0.4, simple_bounds=simple)
    B, T, m = 4, 3, prob.n_ctr
    d = 3e-3 * np.cumsum(rng.standard_normal((B, T) + prob.A.shape), axis=1)
    d[:, :, :prob.dims[0] * simple] = 0.0
    A_seq = prob.A + d
    lb_seq = np.broadcast_to(prob.lb, (B, T, m)).copy()
    ub_seq = np.broadcast_to(prob.ub, (B, T, m)).copy()
    params = JT.ParametersLexLSI(max_number_of_factorizations=80)
    want = jseq.solve_sequence_batched_fused(
        jnp.asarray(A_seq), jnp.asarray(lb_seq), jnp.asarray(ub_seq),
        jnp.asarray(prob.regularization), struct=jli.Structure.of(prob), params=params,
        tile=B, interpret=True, vmem_limit_mb=0, tracked=True, loop_cap=1)
    stats = []
    got = lt.solve_sequence_batched_fused(
        *convert.to_torch((A_seq, lb_seq, ub_seq, prob.regularization), "cpu"),
        struct=lt.Structure.of(prob), params=convert.params_from(params), tracked=True,
        loop_cap=1, stats=stats)
    assert len(stats) == T and bool((got[2] == 0).all())
    for i, (w, g) in enumerate(zip(want, got)):
        if g.dtype.is_floating_point:
            _close(g, w, atol=1e-8, msg=str(i))
        else:
            _equal(g, w, str(i))
