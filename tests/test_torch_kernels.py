"""Kernel wrappers of the port: dispatch on the CPU, and the CUDA kernels
against their plain versions on the card.

This file imports no JAX, so its CUDA tests also run on a machine with a
GPU and no JAX (README: "The PyTorch / CUDA port").  Without a GPU they
skip.  Tolerances: float64 results equal to 1e-12 for B1 (same pivot
order, another summation order) and trajectories equal with x to 1e-8
for B2; float32 to 1e-4 / 1e-3 where the pivot orders or working sets
agree, since float32 roundoff may flip a pivot choice between two column
norms that tie to ~1e-6.  Over the shapes of ``_SHAPES`` and ``_PANELS``
(large norms, long columns) B1's float64 tolerance is 1e-10.  Phase 1's
kernels: integers and working sets exact, Ax and v to 1e-6 (float32) or
1e-13 (float64) of sum_j |A_ij x_j| (another summation order).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert, tracing
from lexls_tpu_torch.active_set import (
    _form_initial_working_set,
    _form_step,
    _initialize_v0,
    _modify_x_guess,
    active_set_kwargs,
)
from lexls_tpu_torch.lexlsi import _initial_state
from lexls_tpu_torch.oracle import random_inequality_hierarchy
from lexls_tpu_torch.ops import (
    ActiveSetResult,
    activation,
    activation_ref,
    fused_active_set,
    fused_active_set_ref,
    panel_factorize,
    panel_factorize_ref,
    phase1_warm,
    phase1_warm_ref,
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


def _fused_problem(device, dtype, B=32, seed=17, simple=False, **options):
    """Phase-1 state of a cold solve of 4 levels of 6 rows over 20
    variables (with ``simple``: 8 bound rows, then levels of 6, 25 and 6
    rows, one of them wider than the 20 variables), and B2's keyword
    arguments; ``options`` are further solver parameters."""
    rng = np.random.default_rng(seed)
    dims = [8, 6, 25, 6] if simple else [6, 6, 6, 6]
    prob = random_inequality_hierarchy(rng, 20, dims, equality_fraction=0.1,
                                       tight_fraction=0.5, simple_bounds=simple)
    struct = lt.Structure.of(prob)
    params = lt.ParametersLexLSI(max_number_of_factorizations=200, **BENCH_TOLS, **options)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
    noise = 1e-2 * rng.standard_normal((B,) + prob.A.shape)
    noise[:, :struct.d0] = 0.0  # bound rows stay unit rows
    A = t(prob.A + noise)
    lb, ub = t(np.tile(prob.lb, (B, 1))), t(np.tile(prob.ub, (B, 1)))
    m, n = prob.n_ctr, prob.n_var
    c, s, ns = _device_initial_activation(
        A, lb, ub, torch.zeros(B, m, dtype=torch.int32, device=device), struct)
    st = _initial_state(A, lb, ub, c, s, ns, torch.zeros(B, n, dtype=dtype, device=device),
                        torch.zeros(B, m, dtype=dtype, device=device), struct, params,
                        False, False)
    args = (A, st.lb, st.ub, st.ctr_type, st.stamp, st.next_stamp, st.x, st.v, st.Ax, st.n_fact)
    return args, active_set_kwargs(struct, params, device)


KERNELS = ("panel_factorize", "fused_active_set", "activation", "phase1_warm")


def _launches(fn):
    """``fn()``, and the launches of each kernel it made
    (``{"panel_factorize": n, "fused_active_set": n, "activation": n,
    "phase1_warm": n}``, read from the port's tracing counters
    ``launches.<C entry>``)."""
    tracing.reset()
    with tracing.recording():
        out = fn()
    counters = tracing.snapshot().counters
    return out, {k: sum(v for name, v in counters.items()
                        if name.startswith(f"launches.lexls_{k}_"))
                 for k in KERNELS}


def _counts(**launched):
    """The launches of every kernel: those named, and 0 for the others."""
    return {k: launched.get(k, 0) for k in KERNELS}


def test_cpu_tensors_take_the_plain_versions():
    def run():
        args = _panel_args("cpu", torch.float64)
        for g, w in zip(panel_factorize(*args, fr=0, tol=1e-7),
                        panel_factorize_ref(*args, fr=0, tol=1e-7)):
            assert torch.equal(g, w)
        fargs, kw = _fused_problem("cpu", torch.float64, B=4)
        for g, w in zip(fused_active_set(*fargs, **kw), fused_active_set_ref(*fargs, **kw)):
            assert torch.equal(g, w)

    _, launches = _launches(run)
    assert launches == _counts()


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
    got, launches = _launches(lambda: panel_factorize(*args, fr=0, tol=1e-7))
    want = panel_factorize_ref(*args, fr=0, tol=1e-7)
    torch.cuda.synchronize()
    assert launches == _counts(panel_factorize=1)
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
    got, launches = _launches(lambda: fused_active_set(*args, **kw))
    want = fused_active_set_ref(*args, **kw)
    torch.cuda.synchronize()
    assert launches == _counts(fused_active_set=1)
    assert bool((got.status == 0).all()) and bool((want.status == 0).all())
    same = (got.ctr_type == want.ctr_type).all(1)
    if dtype == torch.float64:
        assert bool(same.all()) and torch.equal(got.it, want.it)
        assert torch.equal(got.stamp, want.stamp) and torch.equal(got.n_fact, want.n_fact)
    torch.testing.assert_close(got.x[same], want.x[same],
                               atol=1e-8 if dtype == torch.float64 else 1e-3, rtol=0)


def _assert_results_equal(got, want, dtype):
    """B2's kernel against its plain version: float64 trajectories and
    exports exact in the ints, floats to 1e-8; float32 where the final
    working sets agree."""
    assert bool((got.status == want.status).all())
    same = (got.ctr_type == want.ctr_type).all(1) & (got.posf == want.posf).all(1)
    if dtype == torch.float64:
        assert bool(same.all())
        for f in ("it", "stamp", "next_stamp", "n_act", "n_deact", "n_fact", "ranks"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    tol = 1e-8 if dtype == torch.float64 else 1e-3
    torch.testing.assert_close(got.x[same], want.x[same], atol=tol, rtol=0)
    K = got.rpad.shape[-1]
    live = torch.arange(K, device=got.rpad.device) < want.ranks[..., None]
    live2 = (live[..., :, None] & live[..., None, :])[same]
    torch.testing.assert_close(torch.where(live2, got.rpad[same], 0.0),
                               torch.where(live2, want.rpad[same], 0.0), atol=tol,
                               rtol=0 if dtype == torch.float64 else 1e-3)
    return same


@pytest.mark.cuda
@pytest.mark.parametrize("simple", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_kernel_pause_resume_export(cuda_device, dtype, simple):  # noqa: F811
    """``iter_cap=1`` then a resume with ``it0``, each against the plain
    version, and together against one uninterrupted launch; with
    ``simple`` the same over a simple-bounds level (d0 > 0)."""
    args, kw = _fused_problem(cuda_device, dtype, simple=simple)
    got1 = fused_active_set(*args, iter_cap=1, **kw)
    want1 = fused_active_set_ref(*args, iter_cap=1, **kw)
    torch.cuda.synchronize()
    _assert_results_equal(got1, want1, dtype)
    assert bool((got1.it == 1).all()) and bool((got1.status == -1).any())
    # status is not an input: finished instances are parked through the budget
    nf = torch.where(got1.status == -1, got1.n_fact, kw["max_fact"]).to(torch.int32)
    args2 = (args[0], args[1], args[2], got1.ctr_type, got1.stamp, got1.next_stamp, got1.x,
             got1.v, got1.Ax, nf, got1.it)
    got2 = fused_active_set(*args2, **kw)
    want2 = fused_active_set_ref(*args2, **kw)
    whole = fused_active_set(*args, **kw)
    torch.cuda.synchronize()
    _assert_results_equal(got2, want2, dtype)
    paused = got1.status == -1
    if dtype == torch.float64:
        for f in ("status", "it", "ctr_type", "stamp", "n_fact", "posf", "ranks"):
            assert torch.equal(getattr(got2, f)[paused], getattr(whole, f)[paused]), f
        assert torch.equal((got1.n_act + got2.n_act)[paused], whole.n_act[paused])
        torch.testing.assert_close(got2.x[paused], whole.x[paused], atol=1e-10, rtol=0)
    # an instance that finished in the first launch runs nothing in the
    # second: its inputs come back with the empty export
    done = ~paused
    if bool(done.any()):
        assert torch.equal(got2.x[done], got1.x[done])
        assert int(got2.ranks[done].sum()) == 0 and float(got2.rpad[done].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_kernel_simple_bounds_matches_plain(cuda_device, dtype):  # noqa: F811
    args, kw = _fused_problem(cuda_device, dtype, simple=True)
    assert kw["d0"] == 8 and len(kw["var_idx"]) == 8
    got = fused_active_set(*args, **kw)
    want = fused_active_set_ref(*args, **kw)
    torch.cuda.synchronize()
    same = _assert_results_equal(got, want, dtype)
    assert bool((got.status == 0).all()) and int(got.it.max()) > 2
    assert int(same.sum()) >= (len(same) if dtype == torch.float64 else len(same) // 2)


_STATE_FIELDS = ActiveSetResult._fields[17:]


def _assert_log_and_cycling_equal(got, want):
    """The bounds, the log and the detector of two float64 results: ints
    and bounds equal, logged values to 1e-8."""
    for f in _STATE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if g.dtype.is_floating_point and f == "log_value":
            torch.testing.assert_close(g, w, atol=1e-8, rtol=0, msg=f)
        else:
            assert torch.equal(g, w), f


@pytest.mark.cuda
@pytest.mark.parametrize("simple", [False, True])
def test_fused_kernel_log_and_cycling_match_plain(cuda_device, simple):  # noqa: F811
    """B2 with the working-set log and cycling handling on, float64: the
    log, the detector and the bounds against the plain version; then
    paused by ``iter_cap`` and resumed with ``it0``, ``log_state`` and
    ``cyc_state`` against the uninterrupted launch."""
    args, kw = _fused_problem(cuda_device, torch.float64, simple=simple,
                              log_working_set_enabled=True, cycling_handling_enabled=True)
    assert kw["log_cap"] == 202 and kw["cycling"]
    got = fused_active_set(*args, **kw)
    want = fused_active_set_ref(*args, **kw)
    torch.cuda.synchronize()
    _assert_results_equal(got, want, torch.float64)
    _assert_log_and_cycling_equal(got, want)
    assert int(got.log_len.min()) > 0 and bool((got.log_len == got.n_act + got.n_deact).all())
    assert bool((got.log_type == 0).any())  # removals are logged too

    got1 = fused_active_set(*args, iter_cap=3, **kw)
    paused = got1.status == -1
    assert bool(paused.any())
    nf = torch.where(paused, got1.n_fact, kw["max_fact"]).to(torch.int32)
    got2 = fused_active_set(
        args[0], got1.lb, got1.ub, got1.ctr_type, got1.stamp, got1.next_stamp, got1.x, got1.v,
        got1.Ax, nf, got1.it, got1[19:27], got1[27:31], **kw)
    torch.cuda.synchronize()
    sel = lambda r: type(r)(*(t[paused] for t in r))  # noqa: E731
    _assert_log_and_cycling_equal(sel(got2), sel(got))
    for f in ("status", "it", "ctr_type", "stamp"):
        assert torch.equal(getattr(got2, f)[paused], getattr(got, f)[paused]), f


@pytest.mark.cuda
@pytest.mark.parametrize("max_counter", [50, 0])
def test_fused_kernel_cycling_fixture(cuda_device, max_counter):  # noqa: F811
    """The frozen degenerate instance that re-adds the row it just removed
    (``tests/golden/cycling_fixtures.npz``, n=4, dims (2, 3)) through the
    kernel: one relaxation and PROBLEM_SOLVED, or with
    ``cycling_max_counter=0`` PROBLEM_SOLVED_CYCLING_HANDLING; against the
    plain version on the CPU."""
    fz = np.load(os.path.join(os.path.dirname(__file__), "golden", "cycling_fixtures.npz"))
    A, lb, ub, guess = (fz[f"relax_once_{k}"] for k in ("A", "lb", "ub", "guess"))
    prob = lt.InequalityHierarchy(A=A, lb=lb, ub=ub, dims=(2, 3), n_var=4)
    params = lt.ParametersLexLSI(max_number_of_factorizations=60, cycling_handling_enabled=True,
                                 log_working_set_enabled=True, cycling_max_counter=max_counter)
    c0, s0, n0 = lt.initial_activation(prob, guess)

    def run(device):
        t = lambda a: torch.as_tensor(np.asarray(a)[None], device=device)  # noqa: E731
        return lt.solve_core_fused(
            t(A), t(lb), t(ub), t(c0), t(s0), t(n0), t(np.zeros(4)), t(np.zeros(5)), None,
            struct=lt.Structure.of(prob), params=params, x_guess_specified=False,
            v0_specified=False)

    got, want = run(cuda_device), run("cpu")
    assert (got.cyc_counter.tolist(), got.status.tolist()) == (([1], [0]) if max_counter else
                                                               ([0], [1]))
    for f, w in convert.state_to_numpy(want).items():
        g = getattr(got, f).cpu().numpy()
        if w.dtype.kind == "f" and f not in ("lb", "ub"):
            np.testing.assert_allclose(g, w, atol=1e-8, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("simple", [False, True])
def test_solve_core_batched_on_the_card_matches_the_cpu(cuda_device, simple):  # noqa: F811
    """The exact tier on CUDA tensors (kernel B1 once per level per pass,
    plus phase 1) against the same on CPU tensors, float64, log and
    cycling handling on: the same decisions, x and v to 1e-8."""
    rng = np.random.default_rng(37)
    dims = [5, 4, 6, 5] if simple else [4, 6, 5]
    prob = random_inequality_hierarchy(rng, 14, dims, equality_fraction=0.1,
                                       tight_fraction=0.6, simple_bounds=simple)
    B = 16
    noise = 1e-2 * rng.standard_normal((B,) + prob.A.shape)
    noise[:, :prob.dims[0] * simple] = 0.0
    params = lt.ParametersLexLSI(max_number_of_factorizations=100, log_working_set_enabled=True,
                                 cycling_handling_enabled=True)
    struct = lt.Structure.of(prob)

    def run(device):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return lt.solve_core_batched(
            t(prob.A + noise), t(np.tile(prob.lb, (B, 1))), t(np.tile(prob.ub, (B, 1))),
            *lt.batched_initial_arrays(prob, B, device), None, struct=struct, params=params,
            x_guess_specified=False, v0_specified=False)

    got, launches = _launches(lambda: run(cuda_device))
    p = len(struct.lexlse_dims)
    assert launches["panel_factorize"] == p * (int(got.it.max()) + 1)
    want = run("cpu")
    assert bool((got.status == 0).all()) and int(got.n_deact.sum()) > 0
    for f, w in convert.state_to_numpy(want).items():
        g = getattr(got, f).cpu().numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-8, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.cuda
def test_tracked_sequence_on_the_card_matches_the_cpu(cuda_device):  # noqa: F811
    """The tracked sequence through the kernels against the same sequence
    on the CPU (float64: the same decisions; x to 1e-8)."""
    rng = np.random.default_rng(29)
    prob = random_inequality_hierarchy(rng, 16, [4, 5, 5, 5], equality_fraction=0.1,
                                       tight_fraction=0.4, simple_bounds=True)
    B, T = 16, 4
    d = 3e-3 * np.cumsum(rng.standard_normal((B, T) + prob.A.shape), axis=1)
    d[:, :, :4] = 0.0
    A_seq = prob.A + d
    lb_seq = np.broadcast_to(prob.lb, (B, T, prob.n_ctr)).copy()
    ub_seq = np.broadcast_to(prob.ub, (B, T, prob.n_ctr)).copy()
    params = lt.ParametersLexLSI(max_number_of_factorizations=100)
    struct = lt.Structure.of(prob)

    def run(device):
        t = [torch.as_tensor(a, device=device)
             for a in (A_seq, lb_seq, ub_seq, prob.regularization)]
        return lt.solve_sequence_batched_fused(*t, struct=struct, params=params, tracked=True,
                                               loop_cap=1)

    got, launches = _launches(lambda: run(cuda_device))
    assert launches["fused_active_set"] >= 1  # the cold bootstrap always launches B2
    want = run("cpu")
    assert bool((got[2] == 0).all())
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g.cpu(), w, atol=1e-8, rtol=0)
        else:
            assert torch.equal(g.cpu(), w)


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

    got, launches = _launches(lambda: run(cuda_device))
    assert launches == _counts(panel_factorize=len(prob.dims), fused_active_set=T, activation=T,
                               phase1_warm=T - 1)
    want = run("cpu")
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g.cpu(), w, atol=1e-8, rtol=0)
        else:
            assert torch.equal(g.cpu(), w)


# (n, general and bound level sizes, simple bounds, instances, iteration cap
# of the compared calls (0: to the end), forced layout): the bench shape,
# the test_01 shape, a level of more than 32 rows, a level of 0 rows, one
# level, an odd n, and the LOD in device memory (forced on a small shape,
# and by the rule on a shape whose state exceeds a block's shared memory)
_SHAPES = {
    "bench": (100, [30, 30, 30, 30], False, 8, 6, None),
    "test_01": (88, [60, 33, 3, 2, 97], True, 8, 6, None),
    "wide_level": (20, [40, 6], False, 16, 0, None),
    "empty_level": (20, [6, 0, 6], False, 16, 0, None),
    "one_level": (10, [12], False, 16, 0, None),
    "odd_n": (21, [6, 6, 6, 6], False, 16, 0, None),
    "lod_in_device_memory": (20, [6, 6, 6, 6], False, 16, 0, False),
    "too_large_for_shared": (160, [50, 50, 50, 50], False, 4, 3, None),
}


def _shape_problem(device, dtype, shape, **options):
    """Phase-1 state of a cold solve at one of ``_SHAPES`` and B2's keyword
    arguments (``_fused_problem`` at any shape)."""
    n, dims, simple, B, cap, lod_shared = _SHAPES[shape]
    rng = np.random.default_rng(41)
    prob = random_inequality_hierarchy(rng, n, dims, equality_fraction=0.1,
                                       tight_fraction=0.5, simple_bounds=simple)
    struct = lt.Structure.of(prob)
    tols = BENCH_TOLS if dtype == torch.float32 else {}
    params = lt.ParametersLexLSI(max_number_of_factorizations=300, **tols, **options)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
    noise = 1e-2 * rng.standard_normal((B,) + prob.A.shape)
    noise[:, :struct.d0] = 0.0
    A = t(prob.A + noise)
    lb, ub = t(np.tile(prob.lb, (B, 1))), t(np.tile(prob.ub, (B, 1)))
    m = prob.n_ctr
    c, s, ns = _device_initial_activation(
        A, lb, ub, torch.zeros(B, m, dtype=torch.int32, device=device), struct)
    st = _initial_state(A, lb, ub, c, s, ns, torch.zeros(B, n, dtype=dtype, device=device),
                        torch.zeros(B, m, dtype=dtype, device=device), struct, params,
                        False, False)
    args = (A, st.lb, st.ub, st.ctr_type, st.stamp, st.next_stamp, st.x, st.v, st.Ax, st.n_fact)
    return args, active_set_kwargs(struct, params, device), cap, lod_shared


@pytest.mark.cuda
@pytest.mark.parametrize("options", [False, True], ids=["plain_options", "log_and_cycling"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_fused_kernel_shapes_match_plain(cuda_device, shape, dtype, options):  # noqa: F811
    """B2 against its plain version over the shapes the layouts have to
    serve, with the log and cycling handling off and on: one call (capped
    where the plain version would take minutes), then paused by
    ``iter_cap=1`` and resumed against the uninterrupted call; no input
    tensor is written."""
    opts = dict(log_working_set_enabled=True, cycling_handling_enabled=True) if options else {}
    args, kw, cap, lod_shared = _shape_problem(cuda_device, dtype, shape, **opts)
    from lexls_tpu_torch.ops.fused import fused_layout
    lay = fused_layout(args[0].shape[1], args[0].shape[2], len(kw["dims"]), kw["d0"],
                       max(1, max(kw["dims"])), dtype, lod_shared)
    assert lay.in_shared == (shape not in ("lod_in_device_memory", "too_large_for_shared")
                             or (shape == "too_large_for_shared" and dtype == torch.float32))
    kept = [a.clone() for a in args] + [kw["prio"].clone(), kw["elig"].clone()]
    got = fused_active_set(*args, iter_cap=cap, lod_shared=lod_shared, **kw)
    want = fused_active_set_ref(*args, iter_cap=cap, **kw)
    torch.cuda.synchronize()
    same = _assert_results_equal(got, want, dtype)
    if dtype == torch.float64:
        _assert_log_and_cycling_equal(got, want)
    else:
        assert int(same.sum()) >= len(same) // 2
    assert int(got.it.max()) > 1 and bool((got.n_act + got.n_deact > 0).any())

    got1 = fused_active_set(*args, iter_cap=1, lod_shared=lod_shared, **kw)
    paused = got1.status == -1
    assert bool(paused.any())
    nf = torch.where(paused, got1.n_fact, kw["max_fact"]).to(torch.int32)
    resume = (args[0], got1.lb, got1.ub, got1.ctr_type, got1.stamp, got1.next_stamp, got1.x,
              got1.v, got1.Ax, nf, got1.it) + ((got1[19:27], got1[27:31]) if options else ())
    rcap = cap - 1 if cap else 0
    got2 = fused_active_set(*resume, iter_cap=rcap, lod_shared=lod_shared, **kw)
    torch.cuda.synchronize()
    if dtype == torch.float64:
        sel = lambda r: type(r)(*(t[paused] for t in r))  # noqa: E731
        for f in ("status", "it", "ctr_type", "stamp", "n_fact", "posf", "ranks"):
            assert torch.equal(getattr(got2, f)[paused], getattr(got, f)[paused]), f
        torch.testing.assert_close(got2.x[paused], got.x[paused], atol=1e-10, rtol=0)
        if options:
            _assert_log_and_cycling_equal(sel(got2), sel(got))
    for before, after in zip(kept, list(args) + [kw["prio"], kw["elig"]]):
        assert torch.equal(before, after)
    for a in got[:17] + ((got.lb, got.ub) if options else ()):
        assert all(a.data_ptr() != b.data_ptr() for b in args)


# (dim, n, forced layout): the bench level, more than 32 rows, no row, an
# odd n, the block in device memory (forced, and by the rule)
_PANELS = {
    "bench": (30, 100, None),
    "wide_level": (40, 20, None),
    "empty_level": (0, 21, None),
    "odd_n": (12, 21, None),
    "block_in_device_memory": (12, 20, False),
    "too_large_for_shared": (200, 180, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(_PANELS))
def test_panel_kernel_shapes_match_plain(cuda_device, shape, dtype):  # noqa: F811
    """B1 against its plain version over the shapes its layouts have to
    serve, starting from a permutation and a column index that an earlier
    level left; no input tensor is written."""
    from lexls_tpu_torch.ops.panel_lqr import panel_layout
    dim, n, blk_shared = _PANELS[shape]
    B = 8
    lay = panel_layout(dim, n, dtype, blk_shared)
    assert lay.in_shared == (shape not in ("block_in_device_memory", "too_large_for_shared")
                             or (shape == "too_large_for_shared" and dtype == torch.float32))
    rng = np.random.default_rng(7)
    blk = rng.standard_normal((B, dim, n + 1))
    perm = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    t = lambda a, dt=torch.int32: torch.as_tensor(a).to(dt).to(cuda_device)  # noqa: E731
    col_at = t(perm)
    pos = torch.empty_like(col_at).scatter_(
        1, col_at.long(), torch.arange(n, dtype=torch.int32, device=cuda_device).expand(B, n))
    ci = 3  # the columns at positions below ci are never chosen
    args = (t(blk, dtype), pos, col_at, torch.full((B,), ci, dtype=torch.int32,
                                                   device=cuda_device),
            t(rng.integers(0, 5, (B, n))))
    kept = [a.clone() for a in args]
    got = panel_factorize(*args, fr=5, tol=1e-7, blk_shared=blk_shared)
    want = panel_factorize_ref(*args, fr=5, tol=1e-7)
    torch.cuda.synchronize()
    same = (got[1] == want[1]).all(1) & (got[2] == want[2]).all(1) & (got[3] == want[3]) \
        & (got[4] == want[4]).all(1)
    if dtype == torch.float64:
        assert bool(same.all())
    else:
        assert int(same.sum()) >= B // 2
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    torch.testing.assert_close(got[0][same], want[0][same], atol=tol, rtol=0)
    torch.testing.assert_close(got[5][same], want[5][same], atol=tol, rtol=0)
    assert bool((got[3] == ci + min(dim, n - ci)).all())
    for before, after in zip(kept, args):
        assert torch.equal(before, after)


@pytest.mark.cuda
def test_a_launch_the_card_refuses_raises(cuda_device):  # noqa: F811
    """Forcing the LOD into shared memory where it does not fit asks for
    more dynamic shared memory than a block may have: the wrapper raises,
    and does not fall back to the other layout."""
    args, kw, _, _ = _shape_problem(cuda_device, torch.float64, "too_large_for_shared")
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_active_set(*args, lod_shared=True, **kw)
    got = fused_active_set(*args, iter_cap=1, **kw)  # and the card still works
    torch.cuda.synchronize()
    assert bool((got.it == 1).all())


@pytest.mark.cuda
def test_kernel_wrappers_check_their_inputs(cuda_device):  # noqa: F811
    args = _panel_args(cuda_device, torch.float64)
    with pytest.raises(TypeError):
        panel_factorize(args[0], args[1].long(), *args[2:], fr=0, tol=1e-7)
    with pytest.raises(ValueError, match="contiguous"):
        panel_factorize(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:],
                        fr=0, tol=1e-7)


# ---------------------------------------------------------------------------
# Phase 1 of a warm step: the activation and the hot start
# ---------------------------------------------------------------------------

# (n, level sizes, simple bounds, instances): the benchmark's ik100 shape at
# its batch, a simple-bounds level (8 bound rows, a level wider than n), and
# a small general shape for the CPU
_PHASE1 = {
    "ik100": (100, [30, 30, 30, 30], False, 384),
    "simple_bounds": (20, [8, 6, 25, 6], True, 64),
    "small": (20, [6, 6, 6, 6], False, 6),
}
# the parameters phase 1 reads: the defaults (no repair, the least initial
# violation), and every repair on with v0 from the feasibility tolerance
_PHASE1_OPTIONS = {
    "defaults": {},
    "modify": dict(modify_type_inactive_enabled=True, modify_type_active_enabled=True,
                   modify_x_guess_enabled=True, set_min_init_ctr_violation=False),
}


def _phase1_inputs(device, dtype, shape, options, solved=True):
    """A warm step's phase-1 inputs at one of ``_PHASE1``: perturbed copies
    solved cold through the whole-solve tier (with ``solved``; else a random
    x, v and guess), moved by 1e-3, and activated from the cold working set.
    Returns ((A, lb, ub, ctr_type, stamp, next_stamp, x, v), the guess, the
    structure, the parameters)."""
    n, dims, simple, B = _PHASE1[shape]
    rng = np.random.default_rng(43)
    prob = random_inequality_hierarchy(rng, n, dims, equality_fraction=0.1,
                                       tight_fraction=0.3, simple_bounds=simple)
    struct = lt.Structure.of(prob)
    tols = BENCH_TOLS if dtype == torch.float32 else {}
    params = lt.ParametersLexLSI(max_number_of_factorizations=250, **tols,
                                 **_PHASE1_OPTIONS[options])
    t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)  # noqa: E731
    m = prob.n_ctr
    noise = 1e-2 * rng.standard_normal((B,) + prob.A.shape)
    drift = 1e-3 * rng.standard_normal((B,) + prob.A.shape)
    noise[:, :struct.d0] = drift[:, :struct.d0] = 0.0  # bound rows stay unit rows
    A0, A1 = t(prob.A + noise), t(prob.A + noise + drift)
    lb, ub = t(np.tile(prob.lb, (B, 1))), t(np.tile(prob.ub, (B, 1)))
    if solved:
        c, s, ns = _device_initial_activation(
            A0, lb, ub, torch.zeros(B, m, dtype=torch.int32, device=device), struct)
        cold = lt.solve_core_fused(A0, lb, ub, c, s, ns, t(np.zeros((B, n))),
                                   t(np.zeros((B, m))), None, struct=struct, params=params,
                                   x_guess_specified=False, v0_specified=False)
        x, v, guess = cold.x, cold.v, cold.ctr_type
    else:
        x, v = t(rng.standard_normal((B, n))), t(rng.standard_normal((B, m)))
        guess = torch.as_tensor(rng.integers(0, 4, (B, m)), dtype=torch.int32, device=device)
    c, s, ns = _device_initial_activation(A1, lb, ub, guess, struct)
    return (A1, lb, ub, c, s, ns, x, v), guess, struct, params


@pytest.mark.parametrize("v0_specified", [False, True], ids=["v0", "v0_given"])
@pytest.mark.parametrize("options", list(_PHASE1_OPTIONS))
@pytest.mark.parametrize("shape", ["simple_bounds", "small"])
def test_phase1_cpu_tensors_take_the_plain_versions(shape, options, v0_specified):
    """On CPU tensors the two wrappers are their plain versions, field for
    field, and launch nothing."""
    args, guess, struct, params = _phase1_inputs("cpu", torch.float64, shape, options,
                                                 solved=False)
    kw = dict(struct=struct, params=params, v0_specified=v0_specified)

    def run():
        for g, w in zip(activation(*args[:3], guess, struct.d0),
                        activation_ref(*args[:3], guess, struct.d0)):
            assert torch.equal(g, w)
        got, want = phase1_warm(*args, **kw), phase1_warm_ref(*args, **kw)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f

    _, launches = _launches(run)
    assert launches == _counts()


@pytest.mark.parametrize("case", ["A_2d", "lb_shape", "ub_float32", "guess_int64",
                                  "activation_on_meta", "x_shape", "stamp_int64",
                                  "next_stamp_shape", "v0_float32", "phase1_warm_on_meta"])
def test_phase1_wrappers_reject_mismatched_inputs(case):
    args, guess, struct, params = _phase1_inputs("cpu", torch.float64, "small", "defaults",
                                                 solved=False)
    A, lb, ub, c, s, ns, x, v = args
    kw = dict(struct=struct, params=params, v0_specified=True)
    calls = {
        "A_2d": lambda: activation(A[0], lb, ub, guess, 0),
        "lb_shape": lambda: activation(A, lb[:, 1:], ub, guess, 0),
        "ub_float32": lambda: activation(A, lb, ub.float(), guess, 0),
        "guess_int64": lambda: activation(A, lb, ub, guess.long(), 0),
        "activation_on_meta": lambda: activation(*(a.to("meta") for a in (A, lb, ub, guess)), 0),
        "x_shape": lambda: phase1_warm(A, lb, ub, c, s, ns, x[:, 1:], v, **kw),
        "stamp_int64": lambda: phase1_warm(A, lb, ub, c, s.long(), ns, x, v, **kw),
        "next_stamp_shape": lambda: phase1_warm(A, lb, ub, c, s, ns[:, None], x, v, **kw),
        "v0_float32": lambda: phase1_warm(A, lb, ub, c, s, ns, x, v.float(), **kw),
        "phase1_warm_on_meta": lambda: phase1_warm(*(a.to("meta") for a in args), **kw),
    }
    with pytest.raises(ValueError, match="unsupported device" if "meta" in case
                       else "expected|must be"):
        calls[case]()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", ["ik100", "simple_bounds"])
def test_activation_kernel_matches_plain(cuda_device, shape, dtype):  # noqa: F811
    """The activation kernel against its plain version, bit for bit, from a
    solved working set and from random guesses, with an equality row of a
    zero normal (it stays out) and the bound rows' equalities (they do not)."""
    args, guess, struct, params = _phase1_inputs(cuda_device, dtype, shape, "defaults")
    A, lb, ub = args[0].clone(), args[1], args[2].clone()
    g0 = struct.d0  # the first general row: an equality everywhere, of zero normal in 0
    ub[:, :g0 + 1] = lb[:, :g0 + 1]  # and so is every bound row, of zero normal in 0
    A[0, :g0 + 1] = 0.0
    rng = np.random.default_rng(3)
    random_guess = torch.as_tensor(rng.integers(0, 4, tuple(guess.shape)), dtype=torch.int32,
                                   device=cuda_device)
    for g in (guess, random_guess):
        got, launches = _launches(lambda: activation(A, lb, ub, g, struct.d0))
        want = activation_ref(A, lb, ub, g, struct.d0)
        torch.cuda.synchronize()
        assert launches == _counts(activation=1)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(got[0][0, g0]) == int(lt.CtrType.INACTIVE) or int(g[0, g0]) in (1, 2)
        assert bool((got[0][:, :g0] == int(lt.CtrType.ACTIVE_EQ)).all())
        assert bool((got[0][1:, g0] == int(lt.CtrType.ACTIVE_EQ)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("v0_specified", [False, True], ids=["v0", "v0_given"])
@pytest.mark.parametrize("options", list(_PHASE1_OPTIONS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", ["ik100", "simple_bounds"])
def test_phase1_warm_kernel_matches_plain(cuda_device, shape, dtype, options,
                                          v0_specified):  # noqa: F811
    """The hot-start kernel against its plain version.  Exact: the working
    set against the plain repair run on the kernel's own A x (the guess's
    x), x, v and the step against the plain formulas on the kernel's own
    Ax and working set, x and the counters against the plain version.  Ax
    and v against the plain version within 1e-6 (float32) or 1e-13
    (float64) of sum_j |A_ij x_j|: the kernel sums A x in another order
    than cuBLAS, which may also flip a repair decision of a row whose A x
    lies within that of its bound.  No input is written."""
    args, _, struct, params = _phase1_inputs(cuda_device, dtype, shape, options)
    A, lb, ub, c, s, ns, x, v0 = args
    kw = dict(struct=struct, params=params, v0_specified=v0_specified)
    kept = [a.clone() for a in args]
    got, launches = _launches(lambda: phase1_warm(*args, **kw))
    want = phase1_warm_ref(*args, **kw)
    torch.cuda.synchronize()
    assert launches == _counts(phase1_warm=1)
    for before, after in zip(kept, args):
        assert torch.equal(before, after)
    moves_x = struct.simple_bounds and options == "modify" and not v0_specified
    if v0_specified:
        assert got.ctr_type is c and got.stamp is s and got.next_stamp is ns and got.v is v0
    else:
        unmoved = dataclasses.replace(params, modify_x_guess_enabled=False)
        Ax0 = phase1_warm(*args, struct=struct, params=unmoved, v0_specified=False).Ax \
            if moves_x else got.Ax
        for g, w in zip((got.ctr_type, got.stamp, got.next_stamp),
                        _form_initial_working_set(c, s, ns, Ax0, lb, ub, params)):
            assert torch.equal(g, w)
        if options == "modify":
            assert bool((got.ctr_type != c).any())
        assert torch.equal(got.v, _initialize_v0(got.ctr_type, got.Ax, lb, ub, params))
    if moves_x:
        assert torch.equal(got.x, _modify_x_guess(x, got.ctr_type, lb, ub, struct))
        assert not torch.equal(got.x, x)
    else:
        assert got.x is x
    assert torch.equal(got.x, want.x)
    Adx, dv = _form_step(A, lb, ub, got.ctr_type, got.Ax, got.v, want.dx)
    assert torch.equal(got.Adx, Adx) and torch.equal(got.dv, dv)
    assert torch.equal(got.dx, want.dx)
    tol = (1e-6 if dtype == torch.float32 else 1e-13) * (A.abs() @ got.x.abs()[:, :, None])[..., 0]
    assert bool(((got.Ax - want.Ax).abs() <= tol).all())
    assert bool(((got.v - want.v).abs() <= tol).all())
    for f in ("it", "n_act", "n_deact", "n_fact", "status", "cyc_counter", "cyc_prev_op",
              "cyc_prev_row", "cyc_prev_type", "log_len", "log_overflow"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_warm_step_launches_each_phase1_entry_once_and_never_waits(cuda_device,
                                                                   dtype):  # noqa: F811
    """A warm step of the benchmark's shape, the activation then
    ``solve_core_fused``, launches the activation, the hot start and B2 once
    each, and makes no host synchronization (torch's sync debug mode
    raises on one); its solves end solved."""
    args, guess, struct, params = _phase1_inputs(cuda_device, dtype, "ik100", "defaults")
    A, lb, ub, x, v0 = args[0], args[1], args[2], args[6], args[7]

    def step(ct, x):
        c, s, ns = _device_initial_activation(A, lb, ub, ct, struct)
        return lt.solve_core_fused(A, lb, ub, c, s, ns, x, v0, None, struct=struct,
                                   params=params, x_guess_specified=True, v0_specified=False)

    first, _ = _launches(lambda: step(guess, x))  # builds and caches what a step reads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, launches = _launches(lambda: step(first.ctr_type, first.x))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert launches == _counts(activation=1, phase1_warm=1, fused_active_set=1)
    assert bool((st.status == 0).all())
