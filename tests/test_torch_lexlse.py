"""The port's equality solves against the JAX package (``lexls_tpu.lexlse``).

The same NumPy batch goes through ``factorize_fast`` (one jitted call per
instance) and the solves of ``lexls_tpu.lexlse``, and through the port's
``factorize_fast_batched`` (kernel B1's plain version on the CPU) and
``lexls_tpu_torch.lexlse``.  Float64.  Three programs, one per kind of
hierarchy, each returning every output at once and run once per module:
unfixed (NONE), with fixed variables, and TIKHONOV with zero factors (the
one that ``solve_least_norm_3`` reads).  Permutations and ranks equal;
``solve`` and ``residual`` to 1e-12, the least-norm and general-norm x to
1e-9, the multipliers to 1e-10."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlse as jle
from lexls_tpu.types import ParametersLexLSE as JParams
from lexls_tpu.types import RegularizationType as JReg

from lexls_tpu_torch import lexlse as tle
from lexls_tpu_torch.ops import factorize_fast_batched
from lexls_tpu_torch.oracle import generate as tgen
from lexls_tpu_torch.types import ParametersLexLSE, RegularizationType

torch.set_num_threads(1)

# kind -> (n, dims, fixed variables, TIKHONOV with zero factors); each
# instance draws its own level ranks, so the batch mixes rank patterns and
# leaves free variables for the least-norm solves
KINDS = {
    "plain": (10, (5, 6, 1), 0, False),
    "fixed": (10, (5, 6, 1), 3, False),
    "tikhonov": (12, (4, 3), 0, True),
}
B = 4


def _inputs(kind):
    n, dims, nf, _ = KINDS[kind]
    rng = np.random.default_rng(sorted(KINDS).index(kind))
    As, bs, fms, fvs = [], [], [], []
    for _ in range(B):
        ranks = [int(rng.integers(0, d + 1)) for d in dims]
        A, b, _, fi, fv = tgen.random_equality_hierarchy(rng, n, dims, ranks, fixed_variables=nf)
        fm, fval = np.zeros(n, bool), np.zeros(n)
        if fi is not None:
            fm[fi], fval[fi] = True, fv
        As.append(A), bs.append(b), fms.append(fm), fvs.append(fval)
    M = rng.standard_normal((n, n))
    m_rhs = rng.standard_normal(n)
    return np.stack(As), np.stack(bs), np.stack(fms), np.stack(fvs), M, m_rhs


@functools.lru_cache(maxsize=None)
def _program(dims, tik):
    """The jitted JAX program of one instance: every output at once (the
    unfixed and the fixed kind share it: the fixed variables are data)."""
    params = JParams(regularization_type=JReg.TIKHONOV if tik else JReg.NONE)

    def one(A, b, fm, fv, M, m_rhs):
        f = jle.factorize_fast(A, b, dims, params, fixed_mask=fm, fixed_val=fv,
                               reg_factors=jnp.zeros(len(dims)) if tik else None)
        lam_fixed, lam = jle.lambda_matrix(f, A_fixed_cols=A)
        out = dict(perm=f.perm, ranks=f.ranks, rank_row=f.rank_row, total_rank=f.total_rank,
                   x=jle.solve(f), x_ln=jle.solve_least_norm(f), x_ln1=jle.solve_least_norm_1(f),
                   x_gn=jle.solve_general_norm(f, M, m_rhs), v=jle.residual(f), lam=lam,
                   lam_fixed=lam_fixed)
        if tik:
            out["x_ln3"] = jle.solve_least_norm_3(f)
        return out

    return jax.jit(one)


@functools.lru_cache(maxsize=None)
def _jax(kind):
    """Every output of the JAX package for ``kind``, as NumPy, computed once
    per module and cached here (conftest drops compiled programs every 10
    tests).  One instance a call: under jit(vmap(...)) XLA:CPU gives
    another λ for one fixed-variable instance of this batch than the eager,
    the unbatched jitted and the port's computations, which agree to
    1e-15."""
    _, dims, _, tik = KINDS[kind]
    run = _program(dims, tik)
    As, bs, fms, fvs, M, m_rhs = _inputs(kind)
    outs = [run(*map(jnp.asarray, (As[i], bs[i], fms[i], fvs[i], M, m_rhs))) for i in range(B)]
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}


@functools.lru_cache(maxsize=None)
def _port(kind):
    """The port's factorization of the same batch and its inputs."""
    _, dims, _, tik = KINDS[kind]
    params = ParametersLexLSE(regularization_type=RegularizationType.TIKHONOV if tik
                              else RegularizationType.NONE)
    As, bs, fms, fvs, M, m_rhs = (torch.as_tensor(a) for a in _inputs(kind))
    f = factorize_fast_batched(As, bs, dims, params, fixed_mask=fms, fixed_val=fvs)
    return f, As, bs, M, m_rhs


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0, err_msg=msg)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_factorization_solve_and_residual_match_jax(kind):
    f, As, bs, _, _ = _port(kind)
    want = _jax(kind)
    for k in ("perm", "ranks", "rank_row", "total_rank"):
        np.testing.assert_array_equal(getattr(f, k).numpy(), want[k], err_msg=k)
    x, v = tle.solve(f), tle.residual(f)
    _close(x, want["x"], 1e-12, "solve")
    _close(v, want["v"], 1e-12, "residual")
    # the residual is A x - b of the basic solution
    _close(v, (As @ x[:, :, None])[:, :, 0].numpy() - bs.numpy(), 1e-10, "A x - b")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_least_norm_solves_match_jax(kind):
    f = _port(kind)[0]
    want = _jax(kind)
    solves = {"x_ln": tle.solve_least_norm, "x_ln1": tle.solve_least_norm_1}
    if KINDS[kind][3]:
        solves["x_ln3"] = tle.solve_least_norm_3
    for key, fn in solves.items():
        x = fn(f)
        _close(x, want[key], 1e-9, key)
        # the three variants solve one problem (tests/test_solve_variants.py)
        _close(x, want["x_ln"], 1e-9, f"{key} against x_ln")
    # with free variables, least norm is not the basic solution
    free = (f.total_rank < f.n_var) & ~f.fixed_mask.all(1)
    assert np.abs(want["x_ln"] - want["x"])[free.numpy()].max() > 1e-6


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_general_norm_matches_jax(kind):
    """A random M, shared by the batch or one copy per instance; M = I,
    m_rhs = 0 gives the least-norm solution."""
    f, _, _, M, m_rhs = _port(kind)
    want = _jax(kind)
    _close(tle.solve_general_norm(f, M, m_rhs), want["x_gn"], 1e-9, "shared M")
    Bn = f.lod.shape[0]
    _close(tle.solve_general_norm(f, M.expand(Bn, *M.shape), m_rhs.expand(Bn, -1)),
           want["x_gn"], 1e-9, "per-instance M")
    n = f.n_var
    eye = torch.eye(n, dtype=torch.float64)
    _close(tle.solve_general_norm(f, eye, torch.zeros(n, dtype=torch.float64)),
           want["x_ln"], 1e-8, "M = I")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_lambda_matrix_and_objective_sensitivity_match_jax(kind):
    f, As, _, _, _ = _port(kind)
    want = _jax(kind)
    lam_fixed, lam = tle.lambda_matrix(f, A_fixed_cols=As)
    _close(lam, want["lam"], 1e-10, "lam")
    _close(lam_fixed, want["lam_fixed"], 1e-10, "lam_fixed")
    if KINDS[kind][2]:
        assert np.abs(want["lam_fixed"]).max() > 1e-6
    for k in range(len(f.dims)):
        lf_k, lam_k = tle.objective_sensitivity(f, k, A_fixed_cols=As)
        assert torch.equal(lam_k, lam[:, :, k]) and torch.equal(lf_k, lam_fixed[:, :, k])
    assert not tle.lambda_matrix(f)[0].any()  # without the columns: no fixed multipliers


@pytest.mark.parametrize("dims", [(), (0,)])
def test_bounds_only_hierarchy_matches_jax(dims):
    """No general rows: every solve returns the fixed values (free
    variables 0), and the residual is empty."""
    n = 5
    fm = np.array([True, False, True, False, False])
    fv = np.array([2.0, 0.0, -1.0, 0.0, 0.0])
    A, b = np.zeros((0, n)), np.zeros(0)

    @jax.jit
    def ref(fm, fv):
        f = jle.factorize_fast(jnp.zeros((0, n)), jnp.zeros(0), dims, JParams(),
                               fixed_mask=fm, fixed_val=fv)
        return (jle.solve(f), jle.solve_least_norm_1(f),
                jle.solve_general_norm(f, jnp.eye(n), jnp.zeros(n)), jle.residual(f))

    x, x_ln1, x_gn, v = (np.asarray(a) for a in ref(jnp.asarray(fm), jnp.asarray(fv)))
    np.testing.assert_array_equal(x, fv)
    np.testing.assert_array_equal(x_ln1, x)
    np.testing.assert_array_equal(x_gn, x)
    ft = factorize_fast_batched(torch.as_tensor(A)[None], torch.as_tensor(b)[None], dims,
                                fixed_mask=torch.as_tensor(fm)[None],
                                fixed_val=torch.as_tensor(fv)[None])
    for got in (tle.solve(ft), tle.solve_least_norm(ft), tle.solve_least_norm_1(ft),
                tle.solve_general_norm(ft, torch.eye(n, dtype=torch.float64),
                                       torch.zeros(n, dtype=torch.float64))):
        np.testing.assert_array_equal(got[0].numpy(), x)
    assert tle.residual(ft).shape == (1, 0) and v.shape == (0,)
