"""The port's regularized factorization against the JAX package's.

Every regularization type runs in the port's ``factorize_fast_batched``
between a level's kernel-B1 launch and its Gauss elimination; on the CPU
B1 is its plain version.  The JAX side runs as its own tests run it,
``jax.vmap`` of ``lexls_tpu.lexlse.factorize_fast``.  Float64: perm and
ranks identical, lod and the null space to 1e-8 (the CGLS types to 1e-6,
the JAX tests' own tolerance for them).  The ``warm_tik_*`` fixtures (C++
reference output) go through the port's exact tier, held as
``tests/test_golden_parity.py`` holds them.  The exact tier against the
JAX package's is in ``test_torch_batched_reg.py``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlse as jlexlse
from lexls_tpu import types as JT
from lexls_tpu.io import dat as io_dat
from lexls_tpu.oracle import generate as jgen

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert, lexlse
from lexls_tpu_torch.ops import factorize_fast_batched

torch.set_num_threads(1)

RT = JT.RegularizationType
CG_TYPES = (RT.TIKHONOV_CG, RT.RT_NO_Z_CG)
DAMPED = (RT.TIKHONOV, RT.TIKHONOV_1, RT.TIKHONOV_2, RT.TIKHONOV_CG, RT.R, RT.R_NO_Z,
          RT.RT_NO_Z, RT.RT_NO_Z_CG, RT.TEST)


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0, err_msg=msg)


# ---------------------------------------------------------------------------
# The factorization
# ---------------------------------------------------------------------------

# one rank-deficient shape for every factorization test: n=10, three levels
# of ranks (3, 3, 2); instances 1 and 3 fix variables (simple bounds)
_N, _DIMS, _RANKS, _B = 10, (4, 5, 3), (3, 3, 2), 4
_REG = np.array([0.1, 0.2, 0.15])


def _factor_inputs():
    rng = np.random.default_rng(5)
    pairs = [jgen.random_equality_hierarchy(rng, _N, _DIMS, _RANKS)[:2] for _ in range(_B)]
    A, b = (np.stack(z) for z in zip(*pairs))
    fm = np.zeros((_B, _N), bool)
    fm[1, [2, 5]] = True
    fm[3, 0] = True
    fv = np.where(fm, rng.standard_normal((_B, _N)), 0.0)
    return A, b, fm, fv


def _factor_pair(params):
    """(port LexQR, JAX LexQR) of the same batch under ``params``."""
    inputs = _factor_inputs()
    jf = jax.jit(jax.vmap(lambda a, b, m, v: jlexlse.factorize_fast(
        a, b, _DIMS, params, m, v, jnp.asarray(_REG))))(*(jnp.asarray(z) for z in inputs))
    f = factorize_fast_batched(*convert.to_torch(inputs[:2], "cpu"), _DIMS,
                               convert.params_from(params, lt.ParametersLexLSE),
                               torch.as_tensor(inputs[2]), convert.to_torch(inputs[3], "cpu"),
                               torch.as_tensor(_REG))
    return f, jf


def _assert_factors_match(f, jf, atol):
    np.testing.assert_array_equal(f.perm.numpy(), np.asarray(jf.perm))
    np.testing.assert_array_equal(f.ranks.numpy(), np.asarray(jf.ranks))
    for name in ("lod", "hh", "null_space"):
        _close(getattr(f, name), getattr(jf, name), atol, name)


@pytest.mark.parametrize("rt", DAMPED, ids=[t.name for t in DAMPED])
def test_factorize_regularized_matches_jax(rt):
    """Each damped type on a batch where every level loses rank and two
    instances fix variables; TIKHONOV_1 also carries each objective's
    damped solution and residuals."""
    f, jf = _factor_pair(JT.ParametersLexLSE(regularization_type=rt))
    _assert_factors_match(f, jf, 1e-6 if rt in CG_TYPES else 1e-8)
    assert bool((f.ranks < torch.tensor(_DIMS)).all())
    # the damped rhs differs from the undamped one (the path is active)
    A, b = convert.to_torch(_factor_inputs()[:2], "cpu")
    f0 = factorize_fast_batched(A, b, _DIMS, fixed_mask=f.fixed_mask, fixed_val=f.fixed_val)
    assert float((f0.lod[:, :, -1] - f.lod[:, :, -1]).abs().max()) > 1e-6
    if rt == RT.TIKHONOV_1:
        _close(f.X_mu, jf.X_mu, 1e-8, "X_mu")
        _close(f.residual_mu, jf.residual_mu, 1e-8, "residual_mu")
        _close(f.reg_factors, np.broadcast_to(_REG, (_B, 3)), 0)
    else:
        assert f.X_mu.numel() == f.residual_mu.numel() == f.reg_factors.numel() == 0


@pytest.mark.parametrize("eps", [0.5, 5.0])
def test_variable_regularization_matches_jax(eps):
    """Conditioning-driven damping (``regularization.variable_factor``):
    the factor of each instance and level follows its conditioning
    estimate."""
    f, jf = _factor_pair(JT.ParametersLexLSE(regularization_type=RT.TIKHONOV,
                                             variable_regularization_factor=eps))
    _assert_factors_match(f, jf, 1e-8)


def test_regularized_lambda_matches_jax():
    """TIKHONOV_1's multipliers: ``objective_sensitivity_regularized`` for
    every objective and the seeds ``x_mu_rhs``."""
    f, jf = _factor_pair(JT.ParametersLexLSE(regularization_type=RT.TIKHONOV_1))
    lams, seeds = jax.jit(jax.vmap(lambda g: (
        [jlexlse.objective_sensitivity_regularized(g, j)[1] for j in range(len(_DIMS))],
        jlexlse.x_mu_rhs(g))))(jf)
    for j, want in enumerate(lams):
        got = lexlse.objective_sensitivity_regularized(f, j)
        assert float(got.abs().max()) > 1e-3
        _close(got, want, 1e-8, f"objective {j}")
    _close(lexlse.x_mu_rhs(f), seeds, 1e-8, "x_mu_rhs")


# ---------------------------------------------------------------------------
# The exact tier against the C++ reference's golden fixtures
# ---------------------------------------------------------------------------


def _level_norms(v, dims):
    edges = np.cumsum([0] + list(dims))
    return np.stack([np.linalg.norm(v[:, a:b], axis=1) for a, b in zip(edges, edges[1:])], 1)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _violation(A, lb, ub, x):
    Ax = A @ x
    return np.where(Ax <= lb, Ax - lb, np.where(Ax >= ub, Ax - ub, 0.0))


@pytest.mark.parametrize("name", [f"warm_tik_{i:02d}" for i in range(6)])
def test_warm_tik_golden(name):
    """The C++ reference's TIKHONOV warm starts (HierType 210), B=1 through
    the port's exact tier with each fixture's guess: status, per-level
    violation norms to 1e-8 and x to 1e-7 (the damped x is unique), as
    ``tests/test_golden_parity.py:128-157`` checks them.  Float64 only:
    the factors (~6e-4) square below float32's epsilon."""
    with open(os.path.join(GOLDEN, "index.json")) as fh:
        entry = json.load(fh)[name]
    with open(os.path.join(GOLDEN, name + ".json")) as fh:
        gold = json.load(fh)
    d = io_dat.load_dat_python(os.path.join(GOLDEN, entry["dat"]))
    prob = io_dat.to_inequality(d)
    prob.regularization = np.asarray(entry["reg_factors"], float)
    params = lt.ParametersLexLSI(regularization_type=lt.RegularizationType(entry["reg_type"]))
    c0, s0, n0 = lt.initial_activation(prob, d.active_guess_stacked())
    inputs = (prob.A[None], prob.lb[None], prob.ub[None], c0[None], s0[None], np.array([n0]),
              np.asarray(d.solution_guess)[None], np.zeros((1, prob.n_ctr)), prob.regularization)
    st = lt.solve_core_batched(*convert.to_torch(inputs, "cpu"), struct=lt.Structure.of(prob),
                               params=params, x_guess_specified=True, v0_specified=False)
    assert int(st.status[0]) == int(gold["status"])
    x = st.x[0].numpy()
    w_gold = np.concatenate([np.asarray(w) for w in gold["violation"]])
    np.testing.assert_allclose(
        _level_norms(_violation(prob.A, prob.lb, prob.ub, x)[None], prob.dims),
        _level_norms(w_gold[None], prob.dims), atol=1e-8)
    np.testing.assert_allclose(x, np.asarray(gold["x"]), atol=1e-7)
