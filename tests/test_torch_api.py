"""The port's equality façade against the JAX package's, in float64 on
the CPU.

``lexls_tpu_torch.LexLSE`` (``factorize_fast_batched`` on a batch of one,
kernel B1's plain version) against ``lexls_tpu.api.LexLSE`` (the
physical-swap factorization, which ``tests/test_jax_lexlse.py`` holds
equal to the fast one): the four solve options, the general norm and the
multipliers on one problem, because each JAX ``LexLSE`` call runs its
factorization eagerly, and its results are computed once per module.
Then ``solve_equality_batched`` at B=4, the refusals, and the shape of the
reference's ``test_numerical_error.cpp``: an inequality solve whose final
working set, rebuilt as an equality hierarchy, gives the same x."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.api as japi
from lexls_tpu import types as JT
from lexls_tpu.oracle import generate as jgen

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert
from lexls_tpu_torch.oracle import generate as tgen

torch.set_num_threads(1)

OPTIONS = (0, 1, 2, 3)


def _problem():
    """n=12, levels of 4 and 3 rows of ranks 3 and 2, two fixed variables:
    five free variables, so the least-norm options differ from option 0."""
    rng = np.random.default_rng(7)
    A, b, dims, fi, fv = jgen.random_equality_hierarchy(rng, 12, [4, 3], [3, 2],
                                                        fixed_variables=2)
    M = rng.standard_normal((12, 12))
    return JT.EqualityHierarchy(A=A, b=b, dims=dims, fixed_idx=fi, fixed_val=fv), M, \
        rng.standard_normal(12)


def _params(option):
    return JT.ParametersLexLSE(regularization_type=JT.RegularizationType.TIKHONOV
                               if option == 3 else JT.RegularizationType.NONE)


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX façade's results: every option, the general norm, the λ
    matrix (NumPy).  Its three costliest calls into ``lexls_tpu.lexlse``
    run jitted, one program each, where the façade runs them op by op (the
    same computation: 8 s here against 29 s)."""
    prob, M, m_rhs = _problem()
    with mock.patch.object(japi.le, "factorize", jax.jit(japi.le.factorize,
                                                         static_argnums=(2, 3))), \
            mock.patch.object(japi.le, "lambda_matrix", jax.jit(japi.le.lambda_matrix)), \
            mock.patch.object(japi.le, "solve_least_norm_1", jax.jit(japi.le.solve_least_norm_1)):
        out = {o: japi.LexLSE(prob, _params(o)).solve(o) for o in OPTIONS}
        out["general"] = japi.LexLSE(prob).solve_general_norm(M, m_rhs)
        out["lambdas"] = japi.LexLSE(prob).lambdas()
    return out


def _port(option=0):
    return lt.LexLSE(_eq(_problem()[0]), convert.params_from(_params(option), lt.ParametersLexLSE),
                     device="cpu")


def _eq(prob):
    return lt.EqualityHierarchy(A=prob.A, b=prob.b, dims=prob.dims, fixed_idx=prob.fixed_idx,
                                fixed_val=prob.fixed_val)


def _assert_result_match(got, want, atol):
    np.testing.assert_allclose(got.x, np.asarray(want.x), atol=atol, rtol=0)
    np.testing.assert_allclose(got.v, np.asarray(want.v), atol=atol, rtol=0)
    np.testing.assert_array_equal(got.ranks, np.asarray(want.ranks))
    assert got.total_rank == want.total_rank


@pytest.mark.parametrize("option", OPTIONS)
def test_lexlse_solve_options_match_jax(option):
    got = _port(option).solve(option)
    _assert_result_match(got, _jax()[option], 1e-12 if option == 0 else 1e-9)
    prob = _problem()[0]
    np.testing.assert_array_equal(got.x[prob.fixed_idx], prob.fixed_val)
    if option:  # the least-norm options solve one problem
        np.testing.assert_allclose(got.x, _jax()[2].x, atol=1e-8, rtol=0)
        assert np.abs(got.x - _jax()[0].x).max() > 1e-6


def test_lexlse_general_norm_and_lambdas_match_jax():
    _, M, m_rhs = _problem()
    s = _port()
    _assert_result_match(s.solve_general_norm(M, m_rhs), _jax()["general"], 1e-9)
    lam = s.lambdas()
    np.testing.assert_allclose(lam, _jax()["lambdas"], atol=1e-10, rtol=0)
    assert lam.shape == (sum(s.prob.dims), len(s.prob.dims))
    # M = I, m_rhs = 0: the least-norm solution
    n = s.prob.n_var
    np.testing.assert_allclose(s.solve_general_norm(np.eye(n), np.zeros(n)).x, _jax()[2].x,
                               atol=1e-8, rtol=0)


def test_lexlse_refuses_unknown_options():
    with pytest.raises(lt.LexLSError, match="requires regularization_type TIKHONOV"):
        _port(0).solve(3)
    with pytest.raises(lt.LexLSError, match="unknown solve_option"):
        _port(0).solve(4)


@pytest.mark.parametrize("least_norm", [False, True])
def test_solve_equality_batched_matches_jax(least_norm):
    """B=4 hierarchies of mixed ranks; NumPy in, float64 on the CPU; a
    float32 tensor keeps its dtype and device."""
    rng = np.random.default_rng(11)
    dims = (4, 3, 2)
    As, bs = zip(*(jgen.random_equality_hierarchy(
        rng, 10, dims, [int(rng.integers(1, d + 1)) for d in dims])[:2] for _ in range(4)))
    As, bs = np.stack(As), np.stack(bs)
    want = np.asarray(japi.solve_equality_batched(jnp.asarray(As), jnp.asarray(bs), dims,
                                                  least_norm=least_norm))
    got = lt.solve_equality_batched(As, bs, dims, least_norm=least_norm, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=0)
    got32 = lt.solve_equality_batched(torch.as_tensor(As, dtype=torch.float32),
                                      torch.as_tensor(bs, dtype=torch.float32), dims,
                                      least_norm=least_norm)
    assert got32.dtype == torch.float32 and got32.device.type == "cpu"
    np.testing.assert_allclose(got32.numpy(), want, atol=1e-3, rtol=0)


def test_equality_entry_points_need_a_device(monkeypatch):
    """Without a card, ``LexLSE`` and ``solve_equality_batched`` on NumPy
    input raise unless given ``device="cpu"``: neither falls back on its
    own."""
    prob = _eq(_problem()[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: lt.LexLSE(prob), lambda: lt.LexLSE(prob, device="cuda"),
                 lambda: lt.solve_equality_batched(prob.A[None], prob.b[None], prob.dims)):
        with pytest.raises(lt.LexLSError):
            call()


def test_inequality_solution_is_its_working_set_equality_solution():
    """The shape of the reference's ``test_numerical_error.cpp:126-173``:
    solve an inequality hierarchy with a simple-bounds level, rebuild its
    final working set as an equality hierarchy (active rows at their
    active bound, active simple bounds as fixed variables) in a fresh
    ``LexLSE``, and get the same x and per-level residual norms."""
    rng = np.random.default_rng(8)
    prob = tgen.random_inequality_hierarchy(rng, 12, [4, 6, 5, 4], simple_bounds=True)
    res = lt.solve(prob, device="cpu")
    assert res.status == lt.TerminationStatus.PROBLEM_SOLVED
    ct = res.ctr_type
    rhs = np.where(ct == int(lt.CtrType.ACTIVE_LB), prob.lb, prob.ub)
    active = ct != int(lt.CtrType.INACTIVE)
    d0 = prob.dims[0]
    fixed = np.nonzero(active[:d0])[0]
    rows, dims = [], []
    for k in range(1, prob.n_obj):
        lvl = np.arange(prob.n_ctr)[prob.level_slice(k)]
        rows += list(lvl[active[lvl]])
        dims.append(int(active[lvl].sum()))
    assert len(fixed) and sum(dims) < prob.n_ctr - d0  # some rows active, some not
    eq = lt.EqualityHierarchy(A=prob.A[rows], b=rhs[rows], dims=dims,
                              fixed_idx=np.asarray(prob.var_idx)[fixed], fixed_val=rhs[fixed])
    got = lt.LexLSE(eq, device="cpu").solve(0)
    np.testing.assert_allclose(got.x, res.x, atol=1e-9, rtol=0)
    ofs = np.cumsum([0] + dims)
    for k in range(1, prob.n_obj):
        np.testing.assert_allclose(np.linalg.norm(got.v[ofs[k - 1]:ofs[k]]),
                                   np.linalg.norm(res.v[prob.level_slice(k)]), atol=1e-9)
