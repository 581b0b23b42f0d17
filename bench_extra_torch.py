"""Secondary benchmarks of the PyTorch / CUDA port (``lexls_tpu_torch``):
the configurations of ``bench_extra.py`` on an NVIDIA GPU.

  1. the equality l-QR at the test_01.dat scale (88 variables, 4 general
     levels): one ``solve_equality_batched`` call (kernel B1 once per
     level, then the basic solve);
  2. two-sided inequalities at the 88-variable scale (dims (44, 44)), cold
     solves: ``tracked`` (``solve_core_cold_tracked``, the default) or
     ``fused`` (``solve_core_fused``, kernel B2);
  3. a deep rank-deficient hierarchy (6 levels) with TIKHONOV
     regularization, cold solves: ``tracked`` (the default) or ``exact``
     (``solve_batched``, the exact tier, kernel B1 in every pass).

Each problem builder draws exactly as ``bench_extra.py`` draws: the same
seed, the same order of generator calls (``lexls_tpu_torch.oracle``, a
copy of the JAX package's generator) and the same tolerances.  Each timed
function prints one JSON line in ``bench_extra.py``'s form (its metric
names and ``config`` strings, plus the dtype) and returns it.

Timing is ``bench_extra.py``'s ``_slope``: the median wall time of N
back-to-back solves at two values of N, each run ending in a fetch of one
scalar to the host, with each solve's A moved by ``1e-9 * sum(x)`` of the
one before so that no solve can start before the previous one ends.  The
sum leaves out NaN entries (``torch.nansum``): in float32, config 3 ends
two of its 1024 instances with a NaN x, and a NaN sum would turn every
later A into NaN, whose solves end at once and time nothing.  So that such
an answer still shows, each record also counts, over the last timed call,
the instances whose x is not finite (``nonfinite_x``) and, for configs 2
and 3, those that end in another status than ``PROBLEM_SOLVED``
(``unsolved``; config 3's budget of 64 factorizations ends most of its
instances at status 2, which ``bench_extra.py`` sums), and names the first
8 of those by index with status, iterations and factorizations
(``unsolved_at``).  The chain of solves is :func:`cold_chain`, which
``chip_smoke.py config2_chain`` replays on the card with the same
arguments.

    python3 bench_extra_torch.py

runs every configuration on the card (``LEXLS_BENCH_ONLY="2"`` picks some,
``LEXLS_BENCH_COLD_B`` sets config 2's B, ``LEXLS_BENCH_COLD_MODE`` and
``LEXLS_BENCH_REG_MODE`` the modes of configs 2 and 3,
``LEXLS_BENCH_DTYPE`` ``float32`` (the default) or ``float64``).  Without a
card it exits non-zero, unless ``LEXLS_BENCH_CPU=1`` asks for the CPU
(the kernels' plain versions, small B).
"""

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

# bench_extra.py's shapes: config 1 (:83), config 2 (:128-129), config 3 (:196-198)
EQ_N, EQ_DIMS = 88, (33, 3, 2, 97)
COLD_N, COLD_DIMS = 88, (44, 44)
REG_N, REG_DIMS, REG_RANKS, REG_FACTOR = 24, (6, 5, 5, 4, 4, 4), (4, 3, 3, 2, 2, 2), 0.05


def bench_device():
    """The card, or the CPU when ``LEXLS_BENCH_CPU=1`` asks for it; never a
    silent fallback.  Raises ``RuntimeError`` without a card."""
    if os.environ.get("LEXLS_BENCH_CPU") == "1":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this bench needs a GPU "
                           "(LEXLS_BENCH_CPU=1 runs it on the CPU)")
    return torch.device("cuda", 0)


def bench_dtype():
    """``LEXLS_BENCH_DTYPE``: float32 (the default, as the TPU bench) or float64."""
    name = os.environ.get("LEXLS_BENCH_DTYPE", "float32")
    if name not in ("float32", "float64"):
        raise ValueError(f"LEXLS_BENCH_DTYPE={name!r}: float32 or float64")
    return getattr(torch, name)


def _batch(device, card_b, cpu_b=4):
    """bench_extra.py's B: its TPU value on the card, 4 on the CPU."""
    return card_b if device.type == "cuda" else cpu_b


def synchronize(device):
    """Wait for the card (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _f32_params(**kw):
    from lexls_tpu_torch import ParametersLexLSI

    return ParametersLexLSI(tol_linear_dependence=1e-7, tol_wrong_sign_lambda=1e-4,
                            tol_correct_sign_lambda=1e-6, tol_feasibility=1e-5, **kw)


def _cold_batch(prob, B, base, dtype, device):
    """Config 2's and 3's batched inputs: A (B, m, n), the shared bounds,
    the cold activation of ``initial_activation(prob)``, and the factors."""
    from lexls_tpu_torch import initial_activation

    ct0, st0, ns0 = initial_activation(prob)
    m = prob.n_ctr
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    return dict(
        A=t(base).to(dtype).contiguous(),
        lb=t(prob.lb).to(dtype).expand(B, m).contiguous(),
        ub=t(prob.ub).to(dtype).expand(B, m).contiguous(),
        ctr_type0=t(ct0).expand(B, m).contiguous(),
        stamp0=t(st0).expand(B, m).contiguous(),
        next_stamp0=t(ns0).to(torch.int32).expand(B).contiguous(),
        reg=t(prob.regularization).to(dtype))


def config1_problem(B, dtype, device):
    """``bench_extra.py:84-95``: one random equality hierarchy (seed 0,
    n=88, dims (33, 3, 2, 97)), then B copies of A and after them B copies
    of b, each perturbed by 1e-3.  Returns (As (B, m, n), bs (B, m),
    params)."""
    from lexls_tpu_torch import ParametersLexLSE
    from lexls_tpu_torch.oracle import random_equality_hierarchy

    rng = np.random.default_rng(0)
    A, b, _, _, _ = random_equality_hierarchy(rng, EQ_N, list(EQ_DIMS))
    As = np.stack([A + 1e-3 * rng.standard_normal(A.shape) for _ in range(B)])
    bs = np.stack([b + 1e-3 * rng.standard_normal(b.shape) for _ in range(B)])
    t = lambda a: torch.as_tensor(a, device=device).to(dtype).contiguous()  # noqa: E731
    return t(As), t(bs), ParametersLexLSE(tol_linear_dependence=1e-7)


def config2_problem(B, dtype, device):
    """``bench_extra.py:126-145``: one random two-sided hierarchy (seed 0,
    n=88, dims (44, 44), equality_fraction 0.05, tight_fraction 0.3), a
    budget of 150 factorizations and the f32 tolerances, then B copies of
    A perturbed by 1e-3.  Returns (prob, params, inputs), inputs a dict of
    tensors as :func:`_cold_batch` builds it."""
    from lexls_tpu_torch.oracle import random_inequality_hierarchy

    rng = np.random.default_rng(0)
    prob = random_inequality_hierarchy(rng, COLD_N, list(COLD_DIMS), equality_fraction=0.05,
                                       tight_fraction=0.3)
    params = _f32_params(max_number_of_factorizations=150)
    base = np.stack([prob.A + 1e-3 * rng.standard_normal(prob.A.shape) for _ in range(B)])
    return prob, params, _cold_batch(prob, B, base, dtype, device)


def config3_problem(B, dtype, device):
    """``bench_extra.py:195-215``: one random hierarchy of six rank-deficient
    levels (seed 0, n=24, ranks (4, 3, 3, 2, 2, 2), equality_fraction 0.1),
    factors 0.05 under TIKHONOV, a budget of 64 and the f32 tolerances,
    then B copies of A perturbed by 1e-3.  Returns (prob, params,
    inputs)."""
    from lexls_tpu_torch import RegularizationType
    from lexls_tpu_torch.oracle import random_inequality_hierarchy

    rng = np.random.default_rng(0)
    prob = random_inequality_hierarchy(rng, REG_N, list(REG_DIMS), ranks=list(REG_RANKS),
                                       equality_fraction=0.1)
    prob.regularization = np.full(len(REG_DIMS), REG_FACTOR)
    params = _f32_params(regularization_type=RegularizationType.TIKHONOV,
                         max_number_of_factorizations=64)
    base = np.stack([prob.A + 1e-3 * rng.standard_normal(prob.A.shape) for _ in range(B)])
    return prob, params, _cold_batch(prob, B, base, dtype, device)


def _slope(run, Ns, reps, device):
    """``bench_extra.py``'s ``_slope``: ``run(N)`` does N back-to-back
    solves and returns a scalar tensor; each timed run ends when that
    scalar reaches the host.  Every N runs once first (the kernels' build
    and the allocator's warm-up), then once more and ``reps`` timed times.
    Returns seconds per solve: the difference of the medians over the
    difference of the Ns."""
    for N in Ns:
        run(N).item()
    med = {}
    for N in Ns:
        run(N).item()
        ts = []
        for _ in range(reps):
            synchronize(device)
            t0 = time.perf_counter()
            run(N).item()
            ts.append(time.perf_counter() - t0)
        med[N] = statistics.median(ts)
    return (med[max(Ns)] - med[min(Ns)]) / (max(Ns) - min(Ns))


UNSOLVED_AT = 8  # instances named in a record's ``unsolved_at``


def _record(metric, B, s, config, dtype, x, state=None):
    """The record of one config: the rate, and over the last call's ``x``
    (and solver ``state``) the instances with a non-finite x (and those not
    solved: their count, and the first UNSOLVED_AT of them by index, with
    status, iterations and factorizations)."""
    rate = B / max(s, 1e-9)
    rec = {"metric": metric, "value": round(rate, 2), "unit": "solves/s", "config": config,
           "dtype": str(dtype).replace("torch.", ""),
           "nonfinite_x": int((~torch.isfinite(x)).any(1).sum())}
    if state is not None:
        bad = torch.nonzero(state.status != 0).flatten()
        rec["unsolved"] = int(bad.numel())
        rec["unsolved_at"] = [
            {"index": i, "status": int(state.status[i]), "it": int(state.it[i]),
             "n_fact": int(state.n_fact[i])} for i in bad[:UNSOLVED_AT].tolist()]
    print(json.dumps(rec), flush=True)
    return rec


def cold_chain(solve, A, N):
    """``N`` back-to-back cold solves from ``A`` (B, m, n), as
    ``bench_extra.py``'s timed run makes them: each solve's A is the one
    before moved by ``1e-9 * nansum(x)`` of its answer, so no solve can
    start before the previous one ends.  Returns (acc, steps): ``acc`` the
    sum of every solve's iterations, a scalar tensor to fetch, and
    ``steps`` the (A, state) of each solve."""
    acc, steps = torch.zeros((), dtype=A.dtype, device=A.device), []
    for _ in range(N):
        st = solve(A)
        steps.append((A, st))
        A, acc = A + 1e-9 * st.x.nansum(), acc + st.it.sum()
    return acc, steps


def bench_equality(device, dtype, B):
    """Config 1: equality l-QR solves/s, N back-to-back
    ``solve_equality_batched`` calls (``bench_extra.py:97-114``)."""
    from lexls_tpu_torch import solve_equality_batched
    from lexls_tpu_torch.active_set import full_fp32

    full_fp32()
    As, bs, params = config1_problem(B, dtype, device)

    last = {}

    def run(N):
        Ac, acc = As, torch.zeros((), dtype=dtype, device=device)
        for _ in range(N):
            xs = last["x"] = solve_equality_batched(Ac, bs, EQ_DIMS, params)
            total = xs.nansum()
            Ac, acc = Ac + 1e-9 * total, acc + total
        return acc

    return _record("equality_lqr_solves_per_s", B, _slope(run, (1, 9), 5, device),
                   f"B={B} n={EQ_N} dims={EQ_DIMS} (test_01 scale)", dtype, last["x"])


def config2_solver(prob, params, inp, mode="tracked"):
    """Config 2's cold solve ``solve(A)`` of A (B, m, n) with the other
    inputs of :func:`config2_problem`: ``tracked`` through
    ``solve_core_cold_tracked``, ``fused`` through ``solve_core_fused``
    (kernel B2); ``stats``, a list, takes the tracker's counters.  Returns
    the solver state."""
    from lexls_tpu_torch import Structure, solve_core_cold_tracked, solve_core_fused

    if mode not in ("tracked", "fused"):
        raise ValueError(f"config 2 mode {mode!r}: tracked or fused")
    struct = Structure.of(prob)
    m, n = prob.n_ctr, prob.n_var
    fixed = (inp["lb"], inp["ub"], inp["ctr_type0"], inp["stamp0"], inp["next_stamp0"])

    def solve(A, stats=None):
        x0 = torch.zeros(A.shape[0], n, dtype=A.dtype, device=A.device)
        v0 = torch.zeros(A.shape[0], m, dtype=A.dtype, device=A.device)
        if mode == "tracked":
            return solve_core_cold_tracked(A, *fixed, x0, v0, struct=struct, params=params,
                                           stats=stats)[0]
        return solve_core_fused(A, *fixed, x0, v0, inp["reg"], struct=struct, params=params,
                                x_guess_specified=False, v0_specified=False)

    return solve


def bench_inequality_cold(device, dtype, B, mode="tracked"):
    """Config 2: cold solves/s, N back-to-back cold solves
    (``bench_extra.py:147-185``) of :func:`cold_chain` through
    :func:`config2_solver`."""
    from lexls_tpu_torch.active_set import full_fp32

    full_fp32()
    prob, params, inp = config2_problem(B, dtype, device)
    solve = config2_solver(prob, params, inp, mode)
    last = {}

    def run(N):
        acc, steps = cold_chain(solve, inp["A"], N)
        last["st"] = steps[-1][1]
        return acc

    return _record("inequality_cold_solves_per_s", B, _slope(run, (1, 3), 3, device),
                   f"B={B} n=88 dims=(44,44) two-sided cold {mode}", dtype, last["st"].x,
                   last["st"])


def bench_deep_regularized(device, dtype, B, mode="tracked"):
    """Config 3: cold solves/s under TIKHONOV (``bench_extra.py:220-253``):
    ``tracked`` through ``solve_core_cold_tracked(reg=...)``, ``exact``
    through ``solve_batched`` (the exact tier)."""
    from lexls_tpu_torch import Structure, solve_batched, solve_core_cold_tracked
    from lexls_tpu_torch.active_set import full_fp32

    if mode not in ("tracked", "exact"):
        raise ValueError(f"config 3 mode {mode!r}: tracked or exact")
    full_fp32()
    prob, params, inp = config3_problem(B, dtype, device)
    struct = Structure.of(prob)
    m, n = prob.n_ctr, prob.n_var
    fixed = (inp["lb"], inp["ub"], inp["ctr_type0"], inp["stamp0"], inp["next_stamp0"])

    def solve(A):
        x0 = torch.zeros(B, n, dtype=dtype, device=device)
        v0 = torch.zeros(B, m, dtype=dtype, device=device)
        if mode == "tracked":
            return solve_core_cold_tracked(A, *fixed, x0, v0, struct=struct, params=params,
                                           reg=inp["reg"])[0]
        return solve_batched(A, *fixed, x0, v0, inp["reg"], struct=struct, params=params)

    last = {}

    def run(N):
        acc, steps = cold_chain(solve, inp["A"], N)
        last["st"] = steps[-1][1]
        return acc

    return _record("deep_regularized_cold_solves_per_s", B, _slope(run, (1, 4), 3, device),
                   f"B={B} n=24 levels=6 rank-deficient tikhonov {mode}", dtype, last["st"].x,
                   last["st"])


def run_all(device=None, dtype=None):
    """Every configuration that ``LEXLS_BENCH_ONLY`` (comma-separated
    config numbers, default "1,2,3") names, as ``bench_extra.py:256-266``.
    Returns the records."""
    device = bench_device() if device is None else torch.device(device)
    dtype = bench_dtype() if dtype is None else dtype
    only = {z.strip() for z in os.environ.get("LEXLS_BENCH_ONLY", "1,2,3").split(",")}
    out = []
    if "1" in only:
        out.append(bench_equality(device, dtype, _batch(device, 384)))
    if "2" in only:
        B = int(os.environ.get("LEXLS_BENCH_COLD_B", _batch(device, 1024)))
        out.append(bench_inequality_cold(device, dtype, B,
                                         os.environ.get("LEXLS_BENCH_COLD_MODE", "tracked")))
    if "3" in only:
        out.append(bench_deep_regularized(device, dtype, _batch(device, 1024),
                                          os.environ.get("LEXLS_BENCH_REG_MODE", "tracked")))
    return out


if __name__ == "__main__":
    try:
        dev = bench_device()
    except RuntimeError as e:
        print(f"bench_extra_torch: {e}", file=sys.stderr)
        sys.exit(2)
    run_all(dev)
