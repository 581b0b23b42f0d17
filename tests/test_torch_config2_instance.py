"""Config 2's instance that kernel B2 left unsolved on the card, on the CPU.

``tests/data/config2_f32_unsolved.npz`` is instance 520 of the third solve
of ``bench_extra_torch.cold_chain`` at config 2 (B=1024, float32), as
``chip_smoke.py config2_chain`` saved it from an NVIDIA H100: A, lb and ub
as the card held them, and the card's answer (status 2, the budget of 150
factorizations spent, in the tracked and in the fused mode).  The chain
moves each A by the sum of the card's own float32 answers, so only the
card reaches this input; here it goes, with config 2's parameters
(``bench_extra_torch._f32_params(max_number_of_factorizations=150)``),
through:

* ``lexls_tpu.lexlsi.solve`` (the reference's exact tier) and the port's
  ``solve(device="cpu")`` in float64: status, iterations and working set
  equal, per-level ‖v_k‖ to 1e-8;
* the same in float32: status, iterations and working set equal, x
  within config 2's float32 limit, 1.5e-2 · (1 + |x|) (``chip_smoke.py``'s
  C2_TOL_X; float32's own error at config 2 is 6e-3, PERF.md), and
  per-level ‖v_k‖ within 1e-3 relative (float32 roundoff of residuals
  near zero: |Δ‖v_k‖| at most 1e-3 · (1 + ‖v_k‖));
* ``solve_core_fused`` and ``solve_core_cold_tracked`` in float32 on the
  CPU, which run the plain versions of kernels B1 and B2: status,
  iterations and working set equal to the exact tier's, and x within
  1e-3 · (1 + |x|) of it.

Every one of them solves the instance in 88 iterations.  What the card's
kernel decided otherwise is pinned last: at the last pivot step of level 0
in iteration 88, float32's downdated column norms, which choose the pivot,
are off the live norms by more than the rank tolerance, so the choice
among the remaining columns is made by rounding; float64's agree."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lexls_tpu.lexlsi as jli
from lexls_tpu import types as JT

import bench_extra_torch as bxt
import lexls_tpu_torch as lt
from lexls_tpu_torch import Structure, initial_activation
from lexls_tpu_torch.lexlsi import active_set_kwargs
from lexls_tpu_torch.ops import fused as fused_mod
from lexls_tpu_torch.ops.panel_lqr import _panel_step

torch.set_num_threads(1)

DATA = __import__("pathlib").Path(__file__).parent / "data" / "config2_f32_unsolved.npz"
DIMS, N = (44, 44), 88
PARAMS = bxt._f32_params(max_number_of_factorizations=150)
# config 2's non-default parameters, for the reference's own parameter object
JPARAMS = JT.ParametersLexLSI(**{k: getattr(PARAMS, k) for k in (
    "tol_linear_dependence", "tol_wrong_sign_lambda", "tol_correct_sign_lambda",
    "tol_feasibility", "max_number_of_factorizations")})
DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}
F32_TOL_X = 1.5e-2  # config 2's float32 limit on x, relative: |dx| <= F32_TOL_X (1 + |x|)


@pytest.fixture(scope="module")
def fixture():
    z = np.load(DATA)
    return {k: z[k] for k in z.files}


def _problem(z, module):
    """The instance as a hierarchy of ``module`` (float64 arrays holding the
    card's float32 values)."""
    return module.InequalityHierarchy(A=z["A"].astype(np.float64), lb=z["lb"].astype(np.float64),
                                      ub=z["ub"].astype(np.float64), dims=DIMS, n_var=N)


_SOLVES = {}


def _exact(z, dtype):
    """(the reference's result, the port's) of the exact tier, once a dtype."""
    if dtype not in _SOLVES:
        jdt, tdt = DTYPES[dtype]
        _SOLVES[dtype] = (jli.solve(_problem(z, JT), JPARAMS, dtype=jdt),
                          lt.solve(_problem(z, lt), PARAMS, dtype=tdt, device="cpu"))
    return _SOLVES[dtype]


def _level_norms(v):
    return np.array([np.linalg.norm(np.asarray(v)[a:a + d])
                     for a, d in zip(np.cumsum((0,) + DIMS[:-1]), DIMS)])


def _cold_inputs(z, dtype):
    prob = _problem(z, lt)
    ct0, st0, ns0 = initial_activation(prob)
    t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a))[None].to(dt)  # noqa: E731
    return prob, (t(z["A"]), t(z["lb"]), t(z["ub"]), t(ct0, torch.int32), t(st0, torch.int32),
                  torch.tensor([int(ns0)], dtype=torch.int32), torch.zeros(1, N, dtype=dtype),
                  torch.zeros(1, sum(DIMS), dtype=dtype))


def test_fixture_is_the_cards_unsolved_instance(fixture):
    """What the card recorded: an 88x88 float32 A and bounds, ended at
    status 2 after spending the budget of 150 factorizations."""
    assert fixture["A"].shape == (N, N) and fixture["A"].dtype == np.float32
    assert fixture["lb"].shape == fixture["ub"].shape == (N,)
    assert bool((fixture["lb"] <= fixture["ub"]).all())
    assert (int(fixture["status"]), int(fixture["it"]), int(fixture["n_fact"])) == (2, 150, 150)
    assert tuple(fixture["dims"]) == DIMS and int(fixture["n_var"]) == N


def test_float64_port_matches_reference(fixture):
    ref, got = _exact(fixture, "float64")
    assert got.status == ref.status == lt.TerminationStatus.PROBLEM_SOLVED
    assert got.n_iterations == ref.n_iterations
    np.testing.assert_array_equal(got.ctr_type, np.asarray(ref.ctr_type))
    np.testing.assert_allclose(_level_norms(got.v), _level_norms(ref.v), atol=1e-8, rtol=0)


def test_float32_port_matches_reference(fixture):
    ref, got = _exact(fixture, "float32")
    assert got.status == ref.status == lt.TerminationStatus.PROBLEM_SOLVED
    assert got.n_iterations == ref.n_iterations == 88
    np.testing.assert_array_equal(got.ctr_type, np.asarray(ref.ctr_type))
    rx = np.asarray(ref.x, dtype=np.float64)
    assert np.all(np.abs(np.asarray(got.x, dtype=np.float64) - rx) <= F32_TOL_X * (1 + np.abs(rx)))
    nr = _level_norms(ref.v)
    assert np.all(np.abs(_level_norms(got.v) - nr) <= 1e-3 * (1 + nr))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reference_solves_the_instance(fixture, dtype):
    """The reference's exact tier solves the instance in either dtype, as
    the port's plain versions do: the card's status 2 is not the
    reference's answer."""
    ref, _ = _exact(fixture, dtype)
    assert ref.status == JT.TerminationStatus.PROBLEM_SOLVED and ref.n_iterations == 88
    assert ref.n_iterations < JPARAMS.max_number_of_factorizations


@pytest.mark.parametrize("mode", ["fused", "tracked"])
def test_float32_plain_kernels_match_exact_tier(fixture, mode):
    """The fused tier (B2's plain version) and the cold tracker (B1's and
    B2's plain versions) in float32: status, iterations and working set
    equal to the exact tier's, x within 1e-3 (1 + |x|) of it."""
    _, exact = _exact(fixture, "float32")
    prob, cold = _cold_inputs(fixture, torch.float32)
    struct = Structure.of(prob)
    if mode == "fused":
        st = lt.solve_core_fused(*cold, torch.zeros(2), struct=struct, params=PARAMS,
                                 x_guess_specified=False, v0_specified=False)
    else:
        st = lt.solve_core_cold_tracked(*cold, struct=struct, params=PARAMS)[0]
    assert int(st.status[0]) == int(exact.status) == 0 and int(st.it[0]) == exact.n_iterations
    np.testing.assert_array_equal(st.ctr_type[0].numpy(), exact.ctr_type)
    x = st.x[0].double().numpy()
    assert np.all(np.abs(x - exact.x) <= 1e-3 * (1 + np.abs(exact.x)))


@pytest.mark.parametrize("dtype,noisy", [(torch.float32, True), (torch.float64, False)])
def test_last_pivot_of_level0_is_chosen_by_rounding(fixture, dtype, noisy):
    """Iteration 88, the one at which the card's B2 left its plain version:
    B2's plain version paused after 87 iterations gives its working set
    (all 44 rows of level 0 active), then level 0's pivot loop runs 43
    steps.  The 44th pivot is the remaining column with the largest
    downdated norm, and the level stops (rank 43) if that column's live
    norm squared is under the tolerance, 1e-7.  One remaining column, 38,
    has a live norm squared of 3.7e-8, under the tolerance, and the largest
    starting norm squared of them all, 3,184: float32's epsilon times that
    is 3.8e-4, of the order of the largest live norm squared, 5.6e-4.  In
    float32 the downdated norms are off the live norms by more than 1e-4,
    a thousand times the tolerance: which column is chosen, and so the
    rank, is decided by rounding (B2 on the card chose column 38 and
    stopped at rank 43).  In float64 they agree to 1e-9."""
    prob, cold = _cold_inputs(fixture, dtype)
    struct = Structure.of(prob)
    s = lt.lexlsi._initial_state(*cold[:3], *cold[3:6], cold[6], cold[7], struct, PARAMS,
                                 False, False)
    kw = active_set_kwargs(struct, PARAMS, "cpu")
    r = fused_mod.fused_active_set_ref(cold[0], s.lb, s.ub, s.ctr_type, s.stamp, s.next_stamp,
                                       s.x, s.v, s.Ax, s.n_fact, iter_cap=87, **kw)
    ct = r.ctr_type
    assert int(r.it[0]) == 87 and int((ct[0, :DIMS[0]] != 0).sum()) == DIMS[0]
    act = (ct != 0).to(dtype)
    rhs = torch.where(ct == int(lt.CtrType.ACTIVE_LB), r.lb, r.ub)
    blk = torch.cat([cold[0] * act[:, :, None], (rhs * act)[:, :, None]], 2)[:, :DIMS[0]]
    cn = (blk[:, :, :N] ** 2).sum(1)
    pos = torch.arange(N, dtype=torch.int32)[None].contiguous()
    ci, stopped = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.bool)
    hh = torch.zeros(1, DIMS[0], dtype=dtype)
    for counter in range(DIMS[0] - 1):
        blk, cn, pos, _, ci, stopped, _, hh, _ = _panel_step(
            counter, blk, cn, pos, None, ci, stopped, None, hh, fr=0,
            tol=PARAMS.tol_linear_dependence, lean=True)
    assert int(ci[0]) == DIMS[0] - 1
    rem = pos[0] >= DIMS[0] - 1
    live = blk[0, DIMS[0] - 1, :N][rem] ** 2
    gap = float((cn[0][rem] - live).abs().max())
    tol = PARAMS.tol_linear_dependence
    assert int((live < tol).sum()) == 1 and float(live.max()) > 1e3 * tol
    # the column under the tolerance (38) starts with the largest norm of
    # the remaining ones: float32's rounding of that norm alone is of the
    # order of the largest live norm, so float32 cannot rank it below them
    start = (cold[0][0, :DIMS[0]] * act[0, :DIMS[0], None]).pow(2).sum(0)[rem]
    tiny = int(torch.nonzero(live < tol)[0, 0])
    assert int(torch.nonzero(rem)[tiny, 0]) == 38 and tiny == int(start.argmax())
    assert torch.finfo(torch.float32).eps * float(start[tiny]) > float(live.max()) / 2
    if noisy:
        assert gap > 1e3 * tol
    else:
        assert gap < 1e-9
