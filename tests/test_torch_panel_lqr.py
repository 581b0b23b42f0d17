"""Kernel B1's plain version and the batched l-QR against the JAX package.

On the CPU ``panel_factorize`` runs its plain version; the JAX side runs
``panel_factorize(use_pallas=False)``, the same math as its Pallas kernel
(as ``tests/test_pallas_lqr.py`` runs it).  Float64; permutations, ranks
and pivot rows equal, values to 1e-12 (two summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lexls_tpu.lexlse as jle
from lexls_tpu.ops import pallas_lqr as jpl
from lexls_tpu.types import ParametersLexLSE

from lexls_tpu_torch import lexlse as tle
from lexls_tpu_torch.ops import factorize_fast_batched, panel_factorize
from lexls_tpu_torch.oracle import generate as tgen

torch.set_num_threads(1)


def _blocks(seed, B=5, dim=6, n=8):
    """Level blocks (B, dim, n+1): instance 1 all zero, instance 2 of rank
    2, instance 3 with more rows than columns' worth of rank."""
    rng = np.random.default_rng(seed)
    blk = rng.standard_normal((B, dim, n + 1))
    blk[1] = 0.0
    blk[2, 2:] = rng.standard_normal((dim - 2, 2)) @ blk[2, :2]
    blk[3, :, :3] = 0.0
    pos = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    return blk, pos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panel_ref_matches_jax(seed):
    blk, pos = _blocks(seed)
    B, _, np1 = blk.shape
    ci = np.zeros(B, np.int32)
    ci[4] = 2  # a later level: the first two positions are taken
    rr = np.zeros((B, np1 - 1), np.int32)
    kw = dict(fr=3, tol=1e-12)
    want = jpl.panel_factorize(jnp.asarray(blk), jnp.asarray(pos), jnp.asarray(pos),
                               jnp.asarray(ci), jnp.asarray(rr), use_pallas=False, **kw)
    args = [torch.as_tensor(a) for a in (blk, pos, pos, ci, rr)]
    got = panel_factorize(*args, **kw)  # CPU tensors: the plain version
    assert int(got[3][1]) == 0 and int(got[3][2]) == 2
    for w, g, exact in zip(want, got, (False, True, True, True, True, False)):
        if exact:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=0)


@pytest.mark.parametrize("ranks", [(3, 2, 2), (1, 3, 0)])
def test_factorize_and_solve_match_jax(ranks):
    rng = np.random.default_rng(sum(ranks))
    dims, B, n = (4, 3, 3), 4, 9
    As, bs = zip(*(tgen.random_equality_hierarchy(rng, n, dims, ranks)[:2] for _ in range(B)))
    As, bs = np.stack(As), np.stack(bs)
    params = ParametersLexLSE()
    fv = jax.vmap(lambda A, b: jle.factorize_fast(A, b, dims, params))(
        jnp.asarray(As), jnp.asarray(bs))
    ft = factorize_fast_batched(torch.as_tensor(As), torch.as_tensor(bs), dims)
    for f in ("perm", "rank_row", "ranks", "first_col", "total_rank"):
        np.testing.assert_array_equal(getattr(ft, f).numpy(), np.asarray(getattr(fv, f)),
                                      err_msg=f)
    np.testing.assert_allclose(ft.lod.numpy(), np.asarray(fv.lod), atol=1e-12, rtol=0)
    np.testing.assert_allclose(ft.hh.numpy(), np.asarray(fv.hh), atol=1e-12, rtol=0)
    np.testing.assert_allclose(tle.solve(ft).numpy(), np.asarray(jax.vmap(jle.solve)(fv)),
                               atol=1e-10, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_factorize_with_fixed_variables_matches_jax(seed):
    """Fixed variables (active simple bounds): their columns are zeroed,
    their values folded into the rhs, and the solve returns them."""
    rng = np.random.default_rng(50 + seed)
    dims, B, n = (4, 3, 3), 4, 9
    As, bs = zip(*(tgen.random_equality_hierarchy(rng, n, dims, (3, 2, 2))[:2]
                   for _ in range(B)))
    As, bs = np.stack(As), np.stack(bs)
    mask = rng.random((B, n)) < 0.3
    mask[0] = False
    val = rng.standard_normal((B, n))  # values outside the mask must be ignored
    params = ParametersLexLSE()
    fj = jpl.factorize_fast_batched(jnp.asarray(As), jnp.asarray(bs), dims, params,
                                    fixed_mask=jnp.asarray(mask), fixed_val=jnp.asarray(val),
                                    use_pallas=False)
    ft = factorize_fast_batched(torch.as_tensor(As), torch.as_tensor(bs), dims,
                                fixed_mask=torch.as_tensor(mask), fixed_val=torch.as_tensor(val))
    for f in ("perm", "rank_row", "ranks", "first_col", "total_rank", "fixed_mask"):
        np.testing.assert_array_equal(getattr(ft, f).numpy(), np.asarray(getattr(fj, f)),
                                      err_msg=f)
    for f in ("lod", "hh", "fixed_val"):
        np.testing.assert_allclose(getattr(ft, f).numpy(), np.asarray(getattr(fj, f)),
                                   atol=1e-12, rtol=0, err_msg=f)
    x = tle.solve(ft)
    np.testing.assert_allclose(x.numpy(), np.asarray(jax.vmap(jle.solve)(fj)), atol=1e-10, rtol=0)
    assert torch.equal(x[torch.as_tensor(mask)], torch.as_tensor(val)[torch.as_tensor(mask)])
