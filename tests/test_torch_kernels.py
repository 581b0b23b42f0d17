"""Kernel wrappers of the port: dispatch on the CPU, and the CUDA kernels
against their plain versions on the card.

This file imports no JAX, so its CUDA tests also run on a machine with a
GPU and no JAX (README: "The PyTorch / CUDA port").  Without a GPU they
skip.  Tolerances: float64 results equal to 1e-12 for B1 (same pivot
order, another summation order) and trajectories equal with x to 1e-8
for B2; float32 to 1e-4 / 1e-3 where the pivot orders or working sets
agree, since float32 roundoff may flip a pivot choice between two column
norms that tie to ~1e-6.
"""

import numpy as np
import pytest
import torch

import lexls_tpu_torch as lt
from lexls_tpu_torch.lexlsi import _initial_state, active_set_kwargs
from lexls_tpu_torch.oracle import random_inequality_hierarchy
from lexls_tpu_torch.ops import (
    fused_active_set,
    fused_active_set_ref,
    panel_factorize,
    panel_factorize_ref,
)
from lexls_tpu_torch.sequence import _device_initial_activation
from torch_parity import cuda_device  # noqa: F401

torch.set_num_threads(1)

BENCH_TOLS = dict(tol_linear_dependence=1e-7, tol_wrong_sign_lambda=1e-4,
                  tol_correct_sign_lambda=1e-6, tol_feasibility=1e-5)


def _panel_args(device, dtype, B=32, dim=12, n=20, seed=5):
    rng = np.random.default_rng(seed)
    blk = rng.standard_normal((B, dim, n + 1))
    blk[0, 4:] = rng.standard_normal((dim - 4, 4)) @ blk[0, :4]  # rank 4
    blk[1] = 0.0
    pos = torch.arange(n, dtype=torch.int32).expand(B, n).contiguous()
    args = (torch.as_tensor(blk, dtype=dtype), pos, pos.clone(),
            torch.zeros(B, dtype=torch.int32), torch.zeros(B, n, dtype=torch.int32))
    return [a.to(device) for a in args]


def _fused_problem(device, dtype, B=32, seed=17):
    """Phase-1 state of a cold solve of 4 levels of 6 rows over 20
    variables, and B2's keyword arguments."""
    rng = np.random.default_rng(seed)
    prob = random_inequality_hierarchy(rng, 20, [6, 6, 6, 6], equality_fraction=0.1,
                                       tight_fraction=0.5)
    struct = lt.Structure.of(prob)
    params = lt.ParametersLexLSI(max_number_of_factorizations=200, **BENCH_TOLS)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
    A = t(np.stack([prob.A + 1e-2 * rng.standard_normal(prob.A.shape) for _ in range(B)]))
    lb, ub = t(np.tile(prob.lb, (B, 1))), t(np.tile(prob.ub, (B, 1)))
    m, n = prob.n_ctr, prob.n_var
    c, s, ns = _device_initial_activation(
        A, lb, ub, torch.zeros(B, m, dtype=torch.int32, device=device), struct)
    st = _initial_state(A, lb, ub, c, s, ns, torch.zeros(B, n, dtype=dtype, device=device),
                        torch.zeros(B, m, dtype=dtype, device=device), struct, params,
                        False, False)
    args = (A, st.lb, st.ub, st.ctr_type, st.stamp, st.next_stamp, st.x, st.v, st.Ax, st.n_fact)
    return args, active_set_kwargs(struct, params, device)


def test_cpu_tensors_take_the_plain_versions():
    before = panel_factorize.launches, fused_active_set.launches
    args = _panel_args("cpu", torch.float64)
    for g, w in zip(panel_factorize(*args, fr=0, tol=1e-7),
                    panel_factorize_ref(*args, fr=0, tol=1e-7)):
        assert torch.equal(g, w)
    fargs, kw = _fused_problem("cpu", torch.float64, B=4)
    for g, w in zip(fused_active_set(*fargs, **kw), fused_active_set_ref(*fargs, **kw)):
        assert torch.equal(g, w)
    assert (panel_factorize.launches, fused_active_set.launches) == before


def test_other_devices_raise():
    args = [a.to("meta") for a in _panel_args("cpu", torch.float64)]
    with pytest.raises(ValueError, match="unsupported device"):
        panel_factorize(*args, fr=0, tol=1e-7)
    fargs, kw = _fused_problem("cpu", torch.float64, B=2)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_active_set(*(a.to("meta") for a in fargs), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_panel_kernel_matches_plain(cuda_device, dtype):  # noqa: F811
    args = _panel_args(cuda_device, dtype)
    before = panel_factorize.launches
    got = panel_factorize(*args, fr=0, tol=1e-7)
    want = panel_factorize_ref(*args, fr=0, tol=1e-7)
    torch.cuda.synchronize()
    assert panel_factorize.launches == before + 1
    assert int(got[3][0]) == 4 and int(got[3][1]) == 0
    same = (got[1] == want[1]).all(1) & (got[3] == want[3])
    if dtype == torch.float64:
        assert bool(same.all())
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(got[0][same], want[0][same], atol=tol, rtol=0)
    torch.testing.assert_close(got[5][same], want[5][same], atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_kernel_matches_plain(cuda_device, dtype):  # noqa: F811
    args, kw = _fused_problem(cuda_device, dtype)
    before = fused_active_set.launches
    got = fused_active_set(*args, **kw)
    want = fused_active_set_ref(*args, **kw)
    torch.cuda.synchronize()
    assert fused_active_set.launches == before + 1
    assert bool((got.status == 0).all()) and bool((want.status == 0).all())
    same = (got.ctr_type == want.ctr_type).all(1)
    if dtype == torch.float64:
        assert bool(same.all()) and torch.equal(got.it, want.it)
        assert torch.equal(got.stamp, want.stamp) and torch.equal(got.n_fact, want.n_fact)
    torch.testing.assert_close(got.x[same], want.x[same],
                               atol=1e-8 if dtype == torch.float64 else 1e-3, rtol=0)


@pytest.mark.cuda
def test_sequence_on_the_card_matches_the_cpu(cuda_device):  # noqa: F811
    rng = np.random.default_rng(23)
    prob = random_inequality_hierarchy(rng, 16, [5, 5, 5], equality_fraction=0.1,
                                       tight_fraction=0.4)
    B, T = 16, 4
    A_seq = prob.A + 1e-2 * np.cumsum(rng.standard_normal((B, T) + prob.A.shape), axis=1)
    lb_seq = np.broadcast_to(prob.lb, (B, T, prob.n_ctr)).copy()
    ub_seq = np.broadcast_to(prob.ub, (B, T, prob.n_ctr)).copy()
    params = lt.ParametersLexLSI(max_number_of_factorizations=100)
    struct = lt.Structure.of(prob)

    def run(device):
        t = [torch.as_tensor(a, device=device)
             for a in (A_seq, lb_seq, ub_seq, prob.regularization)]
        return lt.solve_sequence_batched_fused(*t, struct=struct, params=params)

    panel_factorize.launches = fused_active_set.launches = 0
    got = run(cuda_device)
    assert panel_factorize.launches == len(prob.dims) and fused_active_set.launches == T
    want = run("cpu")
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g.cpu(), w, atol=1e-8, rtol=0)
        else:
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_kernel_wrappers_check_their_inputs(cuda_device):  # noqa: F811
    args = _panel_args(cuda_device, torch.float64)
    with pytest.raises(TypeError):
        panel_factorize(args[0], args[1].long(), *args[2:], fr=0, tol=1e-7)
    with pytest.raises(ValueError, match="contiguous"):
        panel_factorize(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:],
                        fr=0, tol=1e-7)
