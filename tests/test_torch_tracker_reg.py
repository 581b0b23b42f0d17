"""The port's regularized tracker (TIKHONOV, TIKHONOV_CG) against the JAX
package's.

The JAX side runs ``lexls_tpu.tracker`` as ``tests/test_tracker.py``
runs it (the regularized bootstrap and fallback are its XLA tier, so no
Pallas kernel is involved); the port's runs the exact tier over kernel
B1's plain version for its bootstrap iteration and its fallback.  Float64.
Under regularization the active-set method is heuristic and
rank-deficient ties legitimately go different ways on different
arithmetic paths, so whole solves are held, as the JAX tests hold them,
to equal statuses and to endpoints that are fixed points of the
iteration (``_verify_with_f`` from the endpoint declares the instance
solved with the working set unchanged, v within 1e-7, or 1e-3 for the
fixed-trip CGLS, whose iterates amplify roundoff by about 1e7).  Pieces:
outputs to 1e-10."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlse as jlexlse
import lexls_tpu.lexlsi as jli
from lexls_tpu import tracker as jtrk
from lexls_tpu import types as JT
from lexls_tpu.oracle import generate as jgen
from lexls_tpu.parallel import batched_initial_arrays

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert
from lexls_tpu_torch import regularization as treg
from lexls_tpu_torch import tracker as ttrk
from lexls_tpu_torch.active_set import _masked_general
from lexls_tpu_torch.lexlsi import _factorize_masked, _verify_with_f
from lexls_tpu_torch.ops import factorize_fast_batched
from lexls_tpu_torch.sequence import _device_initial_activation

torch.set_num_threads(1)

RT = JT.RegularizationType


def _t(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _close(got, want, atol=1e-10, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0, err_msg=msg)


def _fixed_point(st, A, lb, ub, reg, struct, params):
    """One exact iteration from every endpoint, with the status reset:
    (status, ctr_type, v) after it."""
    s = dataclasses.replace(st, status=torch.full_like(st.status, -1))
    Ag, bg, fm, fv = _masked_general(A, lb, ub, s.ctr_type, d0=struct.d0, var_idx=struct.var_idx)
    f = _factorize_masked(Ag, bg, fm, fv, struct, params, reg)
    s1 = _verify_with_f(s, A, Ag, f, torch.ones_like(st.status, dtype=torch.bool), struct,
                        params)
    return s1


# ---------------------------------------------------------------------------
# Cold solves at config 3's shape (tests/test_tracker.py:655-725)
# ---------------------------------------------------------------------------


def cold_case(trial, rt):
    """n=24, six levels of ranks (4, 3, 3, 2, 2, 2), factors 0.05, B=6:
    the port's cold tracked solve gives the statuses of the JAX package's
    and of the port's exact tier, and every solved endpoint is a fixed
    point of the port's iteration.  The TIKHONOV_CG trials are in
    ``test_torch_tracker_reg_cg.py``, on another worker."""
    rng = np.random.default_rng(500 + trial)
    prob = jgen.random_inequality_hierarchy(rng, 24, [6, 5, 5, 4, 4, 4],
                                            ranks=[4, 3, 3, 2, 2, 2], equality_fraction=0.1)
    prob.regularization = np.full(6, 0.05)
    params = JT.ParametersLexLSI(regularization_type=rt, max_number_of_factorizations=64)
    B, m = 6, prob.n_ctr
    c0, s0, n0, xz, v0 = (np.array(a) for a in batched_initial_arrays(prob, B, jnp.float64))
    As = np.stack([prob.A + 1e-2 * rng.standard_normal(prob.A.shape) for _ in range(B)])
    inputs = (As, np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1)), c0, s0, n0, xz, v0)
    reg = prob.regularization
    stj, _ = jtrk.solve_core_cold_tracked(*(jnp.asarray(a) for a in inputs),
                                          struct=jli.Structure.of(prob), params=params, tile=B,
                                          interpret=True, reg=jnp.asarray(reg))
    struct, tparams = lt.Structure.of(prob), convert.params_from(params)
    args = convert.to_torch(inputs, "cpu")
    stats = []
    stt, car = lt.solve_core_cold_tracked(*args, struct=struct, params=tparams, reg=_t(reg),
                                          stats=stats)
    exact = lt.solve_core_batched(*args, _t(reg), struct=struct, params=tparams,
                                  x_guess_specified=False, v0_specified=False)
    np.testing.assert_array_equal(stt.status.numpy(), np.asarray(stj.status))
    np.testing.assert_array_equal(stt.status.numpy(), exact.status.numpy())
    assert len(stats) == 1 and bool(torch.isfinite(stt.x).all())
    solved = stt.status == 0
    s1 = _fixed_point(stt, args[0], args[1], args[2], _t(reg), struct, tparams)
    assert bool((s1.status[solved] == 0).all())
    np.testing.assert_array_equal(s1.ctr_type[solved].numpy(), stt.ctr_type[solved].numpy())
    v_tol = 1e-3 if rt == RT.TIKHONOV_CG else 1e-7
    assert np.abs((s1.v - stt.v)[solved].numpy()).max(initial=0.0) < v_tol
    # instances handed to the exact tier leave with invalidated carried factors
    assert car.ranks.shape == (B, 6) and car.rinv.shape == (B, 6, 6, 6)


@pytest.mark.parametrize("trial,rt", [(0, RT.TIKHONOV), (1, RT.TIKHONOV), (2, RT.TIKHONOV)])
def test_reg_tracked_cold_matches_jax(trial, rt):
    cold_case(trial, rt)


def test_reg_tracked_simple_bounds_matches_exact_tier():
    """TIKHONOV with a simple-bounds level, whose factor the damping skips:
    the port's tracker damps general level k with ``reg[k + 1]``, as the
    port's exact tier does (``lexlsi.py:261``).  So its cold solve gives the
    exact tier's statuses, and so does a warm step from the cold solution
    through the carried factorization, which the tracker's own damped
    trips resolve; every solved endpoint is a fixed point of the exact
    tier's iteration.  Each level has its own factor, so a shift by one level
    would show.  Not held against the JAX tracker, which damps with
    ``reg[k]`` there (``lexls_tpu/tracker.py:715``)."""
    rng = np.random.default_rng(540)
    prob = jgen.random_inequality_hierarchy(rng, 10, [4, 5, 4, 4], ranks=[4, 3, 3, 2],
                                            simple_bounds=True, equality_fraction=0.1)
    reg = _t(np.array([0.0, 0.02, 0.08, 0.3]))
    params = lt.ParametersLexLSI(regularization_type=lt.RegularizationType.TIKHONOV,
                                 max_number_of_factorizations=64)
    struct, B, d0 = lt.Structure.of(prob), 6, prob.dims[0]
    A0 = np.stack([prob.A for _ in range(B)])
    A0[:, d0:] += 1e-2 * rng.standard_normal(A0[:, d0:].shape)
    A1 = A0.copy()  # a warm step of a slow drift, which the trips resolve
    A1[:, d0:] += 1e-6 * rng.standard_normal(A0[:, d0:].shape)
    lb, ub = _t(np.tile(prob.lb, (B, 1))), _t(np.tile(prob.ub, (B, 1)))
    kw = dict(struct=struct, params=params)

    def check(tracked, exact, A):
        np.testing.assert_array_equal(tracked.status.numpy(), exact.status.numpy())
        solved = tracked.status == 0
        assert int(solved.sum()) >= B // 2 and bool(torch.isfinite(tracked.x).all())
        s1 = _fixed_point(tracked, A, lb, ub, reg, struct, params)
        assert bool((s1.status[solved] == 0).all())
        np.testing.assert_array_equal(s1.ctr_type[solved].numpy(),
                                      tracked.ctr_type[solved].numpy())
        assert np.abs((s1.v - tracked.v)[solved].numpy()).max(initial=0.0) < 1e-7

    init = lt.batched_initial_arrays(prob, B, "cpu")
    cold_t, _ = lt.solve_core_cold_tracked(_t(A0), lb, ub, *init, reg=reg, **kw)
    cold = lt.solve_core_batched(_t(A0), lb, ub, *init, reg, x_guess_specified=False,
                                 v0_specified=False, **kw)
    check(cold_t, cold, _t(A0))

    Ag, bg, fm, fv = _masked_general(_t(A0), lb, ub, cold.ctr_type, d0=struct.d0,
                                     var_idx=struct.var_idx)
    carried = ttrk.carried_from_lexqr(_factorize_masked(Ag, bg, fm, fv, struct, params, reg),
                                      struct)
    ct, st_, ns = _device_initial_activation(_t(A1), lb, ub, cold.ctr_type, struct)
    warm = (_t(A1), lb, ub, ct, st_, ns, cold.x, torch.zeros_like(lb))
    stats = []
    warm_t, _ = lt.solve_core_tracked(*warm, carried=carried, reg=reg, stats=stats, **kw)
    assert stats[0][1] < B  # the trips resolved some instances themselves
    check(warm_t, lt.solve_core_batched(*warm, reg, x_guess_specified=True,
                                        v0_specified=False, **kw), _t(A1))


# ---------------------------------------------------------------------------
# A warm step
# ---------------------------------------------------------------------------


def test_reg_tracked_warm_step_matches_jax():
    """One regularized warm step through ``solve_core_tracked`` from the
    same previous solution, working set and carried factors (built by
    ``carried_from_lexqr`` from each package's factorization of that
    working set): statuses, iteration counts and working sets equal,
    per-level ||v|| to 1e-7, carried positions and ranks equal."""
    rng = np.random.default_rng(7)
    prob = jgen.random_inequality_hierarchy(rng, 10, [4, 4, 3], ranks=[3, 3, 2],
                                            equality_fraction=0.1, tight_fraction=0.5)
    prob.regularization = np.full(3, 0.3)
    params = JT.ParametersLexLSI(regularization_type=RT.TIKHONOV, max_number_of_factorizations=64)
    struct, tparams = lt.Structure.of(prob), convert.params_from(params)
    jstruct = jli.Structure.of(prob)
    B, m = 6, prob.n_ctr
    reg = _t(prob.regularization)
    A0 = np.stack([prob.A + 1e-2 * rng.standard_normal(prob.A.shape) for _ in range(B)])
    lb, ub = np.tile(prob.lb, (B, 1)), np.tile(prob.ub, (B, 1))
    cold = lt.solve_core_batched(*convert.to_torch((A0, lb, ub), "cpu"),
                                 *lt.batched_initial_arrays(prob, B, "cpu"), reg, struct=struct,
                                 params=tparams, x_guess_specified=False, v0_specified=False)
    assert bool((cold.status == 0).any())
    # the carried factorization of the final working sets, in both packages
    Ag, bg, fm, fv = _masked_general(_t(A0), _t(lb), _t(ub), cold.ctr_type, d0=struct.d0,
                                     var_idx=struct.var_idx)
    car_t = ttrk.carried_from_lexqr(_factorize_masked(Ag, bg, fm, fv, struct, tparams, reg),
                                    struct)
    car_j = jax.jit(lambda *z: jtrk.carried_from_lexqr(jax.vmap(
        lambda a, b, m_, v: jlexlse.factorize_fast(
            a, b, jstruct.lexlse_dims, params.lexlse_parameters(), m_, v,
            jnp.asarray(prob.regularization)))(*z), jstruct))(
        *(jnp.asarray(t.numpy()) for t in (Ag, bg, fm, fv)))
    # the warm step: drifted A, the previous x and working set
    A1 = A0 + 2e-3 * rng.standard_normal(A0.shape)
    ct, st_, ns = _device_initial_activation(_t(A1), _t(lb), _t(ub), cold.ctr_type, struct)
    warm = (A1, lb, ub, ct.numpy(), st_.numpy(), ns.numpy(), cold.x.numpy(), np.zeros((B, m)))
    stj, carj = jtrk.solve_core_tracked(*(jnp.asarray(a) for a in warm), car_j, struct=jstruct,
                                        params=params, tile=B, interpret=True,
                                        reg=jnp.asarray(prob.regularization))
    stt, cart = lt.solve_core_tracked(*convert.to_torch(warm, "cpu"), carried=car_t,
                                      struct=struct, params=tparams, reg=reg)
    for f in ("status", "it", "ctr_type"):
        np.testing.assert_array_equal(getattr(stt, f).numpy(), np.asarray(getattr(stj, f)),
                                      err_msg=f)
    edges = np.cumsum([0] + list(prob.dims))
    for a, b in zip(edges, edges[1:]):
        _close(stt.v[:, a:b].norm(dim=1), np.linalg.norm(np.asarray(stj.v)[:, a:b], axis=1),
               1e-7)
    np.testing.assert_array_equal(cart.pos.numpy(), np.asarray(carj.pos))
    np.testing.assert_array_equal(cart.ranks.numpy(), np.asarray(carj.ranks))


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def _damped_system(rng, B=4, K=5, n=8):
    A1 = rng.standard_normal((B, K, n))
    Sm = rng.standard_normal((B, n, n)) * (rng.random((B, n, 1)) < 0.5)
    act = rng.random((B, n)) < 0.7
    act[:, 0] = True
    return A1, Sm, rng.standard_normal((B, n)), rng.standard_normal((B, K)), act


def test_chol_solve_masked_matches_jax():
    """The tracker damps with the exact tier's masked Cholesky solve,
    held against the JAX tracker's ``_chol_solve_masked``."""
    rng = np.random.default_rng(3)
    A1, Sm, s_vec, c, act = _damped_system(rng)
    D = np.einsum("bki,bkj->bij", A1, A1) + 0.1 * np.einsum("bri,brj->bij", Sm, Sm) \
        + 0.1 * np.eye(8)
    d = np.einsum("bkn,bk->bn", A1, c)
    got = treg._masked_chol_solve(_t(D), _t(d), torch.as_tensor(act))
    _close(got, jtrk._chol_solve_masked(jnp.asarray(D), jnp.asarray(d), jnp.asarray(act)))
    assert float(got[torch.as_tensor(~act)].abs().max()) == 0.0


def test_cgls_tikhonov_batched_matches_jax():
    """The tracker's TIKHONOV_CG solve is the exact tier's CGLS, held
    against the JAX tracker's ``_cgls_tikhonov_batched``."""
    rng = np.random.default_rng(4)
    A1, Sm, s_vec, c, act = _damped_system(rng)
    actf = act.astype(np.float64)
    got = treg.cgls_tikhonov(_t(A1), _t(Sm), _t(s_vec), _t(c), torch.tensor(0.3), _t(actf), 10)
    want = jtrk._cgls_tikhonov_batched(jnp.asarray(A1), jnp.asarray(Sm), jnp.asarray(s_vec),
                                       jnp.asarray(c), jnp.asarray(0.3), jnp.asarray(actf), 10)
    # the CGLS iterates amplify the products' rounding (test_tracker.py:716-723)
    _close(got, want, 1e-6)


def test_carried_from_lexqr_matches_jax():
    """The carried state of a rank-deficient regularized factorization with
    fixed variables: the inverse factors, positions and ranks."""
    rng = np.random.default_rng(6)
    prob = jgen.random_inequality_hierarchy(rng, 9, [4, 5, 3], ranks=[3, 2, 2])
    struct, jstruct = lt.Structure.of(prob), jli.Structure.of(prob)
    B = 3
    A = np.stack([prob.A + 1e-2 * rng.standard_normal(prob.A.shape) for _ in range(B)])
    b = rng.standard_normal((B, prob.n_ctr))
    fm = rng.random((B, 9)) < 0.2
    fv = np.where(fm, 1.0, 0.0)
    reg = np.array([0.1, 0.2, 0.3])
    params = JT.ParametersLexLSE(regularization_type=RT.TIKHONOV)
    want = jax.jit(lambda *z: jtrk.carried_from_lexqr(jax.vmap(
        lambda a, b_, m_, v: jlexlse.factorize_fast(
            a, b_, jstruct.lexlse_dims, params, m_, v, jnp.asarray(reg)))(*z), jstruct))(
        *(jnp.asarray(z) for z in (A, b, fm, fv)))
    f = factorize_fast_batched(_t(A), _t(b), struct.lexlse_dims,
                               convert.params_from(params, lt.ParametersLexLSE),
                               torch.as_tensor(fm), _t(fv), _t(reg))
    got = ttrk.carried_from_lexqr(f, struct)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.ranks.numpy(), np.asarray(want.ranks))
    assert bool((got.ranks < torch.tensor([4, 5, 3])).any())
    _close(got.rinv, want.rinv, 1e-8)


@pytest.mark.parametrize("entry", ["solve_core_tracked", "solve_core_cold_tracked"])
@pytest.mark.parametrize("bad,reg", [
    (dict(regularization_type=lt.RegularizationType.R), np.ones(2)),
    (dict(regularization_type=lt.RegularizationType.TIKHONOV), None),
    (dict(regularization_type=lt.RegularizationType.TIKHONOV,
          variable_regularization_factor=1.0), np.ones(2)),
], ids=["R", "TIKHONOV-no-factors", "variable-factor"])
def test_tracked_refuses_unsupported_regularization(entry, bad, reg):
    """The tracker refuses what the JAX tracker refuses
    (``tracker.py:1038-1055``), before anything runs; TIKHONOV and
    TIKHONOV_CG with factors pass."""
    kw = dict(carried=None) if "cold" not in entry else {}
    with pytest.raises(lt.LexLSError):
        getattr(lt, entry)(*([None] * 8), **kw, struct=None, params=lt.ParametersLexLSI(**bad),
                           reg=reg)


@pytest.mark.parametrize("tracked", [False, True])
def test_fused_sequence_refuses_regularization(tracked):
    """``solve_sequence_batched_fused`` refuses TIKHONOV on both paths, as
    the JAX package's does: kernel B2 has no regularization, and ``reg``
    does not reach the tracker (``sequence.py:217-230``)."""
    rng = np.random.default_rng(8)
    prob = jgen.random_inequality_hierarchy(rng, 6, [3, 3])
    B, T, m = 2, 2, prob.n_ctr
    A_seq = np.broadcast_to(prob.A, (B, T, m, 6)).copy()
    lb, ub = (np.broadcast_to(v, (B, T, m)).copy() for v in (prob.lb, prob.ub))
    params = lt.ParametersLexLSI(regularization_type=lt.RegularizationType.TIKHONOV)
    with pytest.raises(lt.LexLSError):
        lt.solve_sequence_batched_fused(*convert.to_torch((A_seq, lb, ub, np.ones(2)), "cpu"),
                                        struct=lt.Structure.of(prob), params=params,
                                        tracked=tracked)
