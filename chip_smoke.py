#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``lexls_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases:
  1. the toolchain: torch/CUDA versions, device, triton, power limit;
  2. build the CUDA kernels from ``lexls_tpu_torch/csrc`` with nvcc
     (ptxas registers and spills), and print for every shape below the
     kernels' shared-memory bytes, the layout their rule picks (the large
     array in shared or in device memory) and the resident blocks per SM;
  3. kernel B1 (panel factorization) against its plain version at the
     bench level shape, plus a rank-deficient block, in float64 and
     float32: the wrapper's call by CUDA events and the kernel's own device
     time by events around its launch;
  4. kernel B2 (whole active-set solve) against its plain version on the
     bench problem, cold and warm, in float64 and float32, with its pause
     (``iter_cap=1``), resume (``it0``) and factor export; in float64 with
     the working-set log and cycling handling on (log, detector and
     bounds identical, also across a pause) and against the same launch
     with them off; timed with the log on and with both on beside the
     times with them off, with the kernel's own device time and what else
     the wrapper launches (nothing), and with the LOD in shared and in
     device memory in turns; then phase 1's kernels (``csrc/phase1.cu``,
     the activation and the hot start) on a warm step at B=384 and
     B=10,240 against their plain versions, each kernel's own device time
     beside its bound, the plain version's device time and both host
     issue times (``python3 chip_smoke.py phase1`` runs this alone); every
     later phase also checks phase 1's launches: one activation a step,
     one hot start a warm step or a fixture with x0;
  5. kernel B2 with simple bounds (``d0 > 0``) against its plain version at
     the ``test_01`` shape (n=88, 60 bound rows, general levels of 33, 3, 2
     and 97 rows), then the tracked path over that shape against the fused
     path (float64, T=3);
  6. B2 against ``solve_core_batched`` (the exact tier, kernel B1 in every
     iteration) on the cold bench problem in float64 with log and cycling
     handling on: decisions and logs equal, B1's launches counted; the
     frozen cycling fixture through the kernel; the ``test_01`` shape in
     float32, warm step, with cycling handling off and on, and what the
     logs of the solves that spend their budget show;
  7. the fused path: ``solve_sequence_batched_fused`` at the bench shape
     (n=100, 4 levels of 30 rows, B=384, T=14, float32, ``bench.py``'s
     tolerances), with launch counts and correctness checks, also against
     the same sequence with the warm steps through B2's plain version;
  8. the tracked path, ``tracked=True`` with ``bench.py``'s knobs
     (``loop_cap=1, ns_iters=2, trip1_noext=True``): launch counts, every
     solve PROBLEM_SOLVED, per-level residual norms against the fused
     path's, how many instances each warm step resolved in the tracker and
     how many it handed to B2; then warm solves/s of both paths as the
     slope between T=2 and T=14, 11 rounds with the paths interleaved, and
     one line for ``loop_cap=0``;
  9. ``torch.profiler`` traces of one T=14 sequence of each path (device
     time per kernel, B2's share, busy share) and of one tracker trip (its
     time and its kernel launches); the host's time to issue one warm step
     of the fused path beside its launches and device time, which says
     whether the host or the card sets the pace of a stream of warm steps;
 10. the fused path with log and cycling handling on (T=3) against the
     same with them off, and the exact tier's sequence,
     ``solve_sequence_batched_native`` (T=3): every solve PROBLEM_SOLVED,
     per-level residual norms against the fused path's, cold and warm
     time, B1's launches and its share of the device time;
 11. regularization at ``bench_extra.py``'s config 3 (n=24, six
     rank-deficient levels, factors 0.05): B1 under every regularization
     type against its plain version (float64, B=64); cold solves in
     float32 at B=1024 through the exact tier (TIKHONOV) and the tracker
     (TIKHONOV, TIKHONOV_CG), their solved endpoints checked as fixed
     points, with cold solves/s, launches, host and device time per pass
     and the device's busy share; the exact tier on the card against the
     CPU in float64 (B=128); and ``solve_sequence_batched_native`` with
     TIKHONOV (T=3), each warm step timed alone.  ``python3 chip_smoke.py
     regularized`` runs this phase alone;
 12. the C++ golden corpus (``tests/golden``, read with the port's own
     ``.dat`` parser): ``lexls_tpu_torch.solve`` on 52 fixtures in float64
     through kernel B1 (and on the CPU, identical), ``solve_core_fused``
     (kernel B2) and the tracker on the 46 unregularized ones in float32,
     B2 against its plain version in float64, and the trace and
     ``use_phase1_v0`` at the bench shape, card against CPU.  ``python3
     chip_smoke.py golden`` runs this phase alone;
 13. the equality layer (``solve_equality_batched``, ``LexLSE``; B1 once
     per level): ``bench_extra.py``'s config 1 (n=88, dims (33, 3, 2, 97),
     B=384) in float32 and float64 against the CPU, with equality solves/s,
     B1's launches and own time per call and the host's time to issue a
     call; the least-norm solves at its width (first three levels);
     ``eq_00..05`` of the golden corpus through ``LexLSE``.  ``python3
     chip_smoke.py equality`` runs this phase alone;
 14. config 5, independent hierarchies sharded across devices
     (``BASELINE.md:38``): a one-rank NCCL process group and
     ``make_host_mesh(1, 1)``, then ``make_sharded_solver_2d`` in the
     ``xla``, ``fused`` and ``tracked`` modes on the bench problem at
     B=10,240 in float32, cold, each mode's state identical to its unsharded
     call and its metrics exact, with cold solves/s beside the same call at
     B=384, launches, the device's busy share and peak memory, and the
     metrics' all-reduce timed; ``make_sharded_sequence_solver`` in every
     mode (T=3); the modes against each other in float64 (B=256).
     ``python3 chip_smoke.py sharded`` runs this phase alone;
 15. the tracker's pyramid (``shrink``) and slab handover
     (``handover_slab``): (a) the fall profile of ``tools/trk_stats.py``
     (``loop_cap=0``, ``debug_fall``) at the bench shape, per warm step the
     iterations, the falls by trip and reason and the instances alive after
     trips 1-3, which size the pyramid; (b) the tracked sequence at the
     bench shape with ``loop_cap=0`` without and with the pyramid, and with
     ``loop_cap=1`` without and with a slab, each against its run without
     the option, warm solves/s by the slope in interleaved rounds, launches
     per warm step, and the same runs in float64 (B=256, ``ns_iters=3``
     so that carries pass float64's certificate); (c) at config 5's
     B=10,240 five ways (two pyramids) over five warm steps, each step
     timed, with trips, busy share and peak memory; (d) kernel B2 launched
     at slab width there against its plain version, and the instances
     outside the slab bit-identical to the tracker's state.  ``python3 chip_smoke.py
     slabs`` runs this phase alone;
 16. config 2 of ``bench_extra.py`` (two-sided inequalities, n=88, dims
     (44, 44), a budget of 150; the problem of
     ``bench_extra_torch.config2_problem``), B=1024 float32, cold: the exact
     tier (B1 every pass), the fused tier (B2, B1 in phase 1) and the
     tracker, each driven with its launches counted, every status and NaN x
     counted, float32's exact tier against float64's and fused and tracked
     against float32's exact tier (x to 1.5e-2 relative, and within a tenth
     of the neighbouring instances' relative distance), cold solves/s, B2's own
     device time, launches, busy share, peak memory and B2's bound; B1 and
     B2 on the last 128
     instances against their plain versions; float64 (B=256) fused against
     the exact tier, decisions identical.  ``python3 chip_smoke.py config2``
     runs this phase alone;
 17. config 2's bench chain (``bench_extra_torch.cold_chain``, each A
     moved by the sum of the last answer, so the inputs depend on the
     card's own float32 results) replayed three times in the tracked and
     three times in the fused mode, N=3, B=1024: each instance that ends
     unsolved printed and saved under ``build/config2_chain/``, and
     the first solved again at B=1 by B2 and its plain version, in float32
     and float64, with where their working sets part and why (each level's
     rank there, and B1 against its plain version on level 0).  ``python3
     chip_smoke.py config2_chain`` runs this phase alone;
 18. the package installed: the wheel built by pip from a copy of the
     tree and installed into a temporary directory (``install_port``, which
     ``tests/test_torch_packaging.py`` runs too), then, in a fresh interpreter
     outside the checkout with a fresh ``XDG_CACHE_HOME``, the kernels
     built from the installed sources into that cache and the fused warm
     sequence run at B=384, T=3, held against the same call from the
     checkout.  ``python3 chip_smoke.py installed`` runs this phase alone.

Prints one JSON line with the per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device, when the package ``lexls_tpu_torch`` is not
beside it (exit code 1), or when any phase fails.  With phase names as
arguments (``python3 chip_smoke.py panel fused``) only those phases run
and no result is printed.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_VAR, DIMS, B, T_MAX = 100, (30, 30, 30, 30), 384, 14
TS = (2, 14)
REPS = 11  # timing rounds of the main path, as bench.py's repetitions
# the test_01 shape: 60 simple bounds, the largest level wider than n; the
# kernel is held against its plain version on SB_B_PLAIN instances (in
# float32 a tenth of them may end in another working set, and with 16
# instances that tenth was a single one)
SB_N, SB_DIMS, SB_B_PLAIN, SB_CAP, SB_T = 88, (60, 33, 3, 2, 97), 64, 12, 3
# the C++ golden corpus (tests/golden, PARITY.md:89-101) and the float32
# tolerances of tools/golden_fused_tpu.py:63-69
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
GOLDEN_F32 = dict(max_number_of_factorizations=250, tol_linear_dependence=1e-7,
                  tol_wrong_sign_lambda=1e-4, tol_correct_sign_lambda=1e-6, tol_feasibility=1e-5)
# (d): the bench shape at B=64 with a budget of 40 factorizations (its cold
# solve takes some 200 passes, minutes for the CPU side of the comparison)
GOLDEN_TRACE_B, GOLDEN_TRACE_BUDGET = 64, 40
# bench_extra.py's config 1 (bench_extra.py:77-114; its shape is
# bench_extra_torch's EQ_N, EQ_DIMS): the equality l-QR at test_01's general
# levels, B perturbed copies, timed over EQ_REPS calls; its least-norm check
# takes the first three levels (50 free variables) on a few instances
EQ_TOL, EQ_REPS = 1e-7, 20
EQ_LN_LEVELS, EQ_LN_B = 3, 8
# phase 1's kernels are timed at the bench batch and at the cold cell's
PHASE1_B_LARGE = 10240


def _card():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


KERNELS = ("panel_factorize", "fused_active_set", "activation", "phase1_warm")


def _launch_counts():
    """{kernel: launches} since the last ``tracing.reset()``: the port's
    tracing counters ``launches.<C entry>``, which count while tracing is on
    (inside ``tracing.recording()`` or a profiler)."""
    from lexls_tpu_torch import tracing

    counters = tracing.snapshot().counters
    return {k: sum(v for name, v in counters.items() if name.startswith(f"launches.lexls_{k}_"))
            for k in KERNELS}


@contextlib.contextmanager
def _counting():
    """Count the kernels' launches inside the block: the dict it yields
    holds {kernel: launches} once the block ends."""
    from lexls_tpu_torch import tracing

    counts = {}
    tracing.reset()
    with tracing.recording():
        yield counts
    counts.update(_launch_counts())


def _cuda_times(fn, reps, warmup=True):
    """Milliseconds of ``fn`` in each of ``reps`` runs (CUDA events), after
    one warm-up run unless the caller has just run ``fn``."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _cuda_ms(fn, reps, warmup=True):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    return statistics.median(_cuda_times(fn, reps, warmup))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over its memory rate and the operations over its float32
    rate outside the tensor cores (``lexls_tpu_torch/perf.py``, NVIDIA's
    H100 SXM data sheet)."""
    from lexls_tpu_torch.perf import H100_HBM_BYTES_S, H100_PEAK_F32

    t_bytes, t_ops = nbytes / H100_HBM_BYTES_S, flops / H100_PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _sum_dc(r, d, c):
    """sum over j < r of (d - j)(c - j), elementwise over arrays."""
    return r * d * c - (d + c) * r * (r - 1) / 2 + (r - 1) * r * (2 * r - 1) / 6


def _panel_flops(r, dim, cols):
    """Floating-point operations of one level's pivot loop with r accepted
    steps over ``cols`` remaining columns: the column norms, and per step
    the pivot norm, w = u^T block and the rank-1 update over the trailing
    columns and the rhs, and the norm downdate."""
    return 2 * dim * cols + 2 * _sum_dc(r, dim, 1) + 4 * _sum_dc(r, dim, cols + 1) \
        + 2 * _sum_dc(r, 1, cols)


def _active_set_flops(res, dims, n, m):
    """Floating-point operations that this call's data needed of kernel B2
    (general levels): per instance, its iterations times one iteration at
    its exported level ranks (factorize, eliminate, solve, step, ratio
    test), plus a multiplier sweep for each iteration that did not block."""
    ranks = res.ranks.double().cpu().numpy()                      # (B, p)
    its = res.it.double().cpu().numpy()
    sweeps = its - res.n_act.double().cpu().numpy()
    p = len(dims)
    per_it = np.full(len(its), 2.0 * m * n + 8 * m)               # Adx, dv, ratio test
    per_sweep = np.zeros(len(its))
    fc = np.zeros(len(its))
    below = m
    for k, d in enumerate(dims):
        r = ranks[:, k]
        below -= d
        cols = n - fc
        per_it += _panel_flops(r, d, cols)
        per_it += below * r * r + 2 * below * r * (cols + 1 - r)   # L, trailing update
        per_it += 2 * r * (cols - r) + r * r                      # backward substitution
        per_sweep += (p - k) * (4 * _sum_dc(r, d, 1) + 2 * d * fc)  # replay, back-propagation
        fc = fc + r
    return float((its * per_it + sweeps * per_sweep).sum())


def _bench_problem(dtype, dev, Bn=B):
    """The workload of ``bench.py:133-166``, as the bench draws it
    (``bench_torch.bench_problem`` and ``bench_params``): one random 4x30
    hierarchy over 100 variables, ``Bn`` perturbed copies (the first B of
    any larger batch are the B of a smaller one), and a drift stream of
    T_MAX steps shared by all.  Returns (prob, params, base, drifts, lb,
    ub), the bounds of one instance."""
    from bench_torch import bench_params, bench_problem

    prob, base, drifts, lbs, ubs = bench_problem(Bn, T_MAX, dtype, dev)
    return prob, bench_params(), base, drifts, lbs[0], ubs[0]


def _phase1(A, lbs, ubs, struct, params, x=None, ct=None):
    """Phase-1 state of one (cold or warm) step, as the solver builds it."""
    from lexls_tpu_torch.lexlsi import _initial_state
    from lexls_tpu_torch.sequence import _device_initial_activation

    B_, m, n = A.shape
    if ct is None:
        ct = torch.zeros(B_, m, dtype=torch.int32, device=A.device)
    c, s, ns = _device_initial_activation(A, lbs, ubs, ct, struct)
    warm = x is not None
    x0 = x if warm else torch.zeros(B_, n, dtype=A.dtype, device=A.device)
    v0 = torch.zeros(B_, m, dtype=A.dtype, device=A.device)
    return _initial_state(A, lbs, ubs, c, s, ns, x0, v0, struct, params, warm, False)


def _panel_diff(got, want):
    """(instances whose pivot order, positions or rank differ, the largest
    |block| or |hh| error where they agree) of two B1 results."""
    same = (got[1] == want[1]).all(1) & (got[2] == want[2]).all(1) \
        & (got[3] == want[3]) & (got[4] == want[4]).all(1)
    err = max(float((got[0] - want[0]).abs().amax(dim=(1, 2))[same].max()),
              float((got[5] - want[5]).abs().amax(1)[same].max()))
    return int((~same).sum()), err


def check_panel(dev, report):
    """B1 against panel_factorize_ref on the first level of the bench
    problem with every row active (B=384, dim=30, n=100, rhs = ub),
    instance 0 made rank-deficient."""
    from lexls_tpu_torch.ops import panel_factorize, panel_factorize_ref

    for dtype in (torch.float64, torch.float32):
        prob, params, base, drifts, lb, ub = _bench_problem(dtype, dev)
        A = base + drifts[0]
        rhs = ub.expand(B, -1)
        block = torch.cat([A, rhs[:, :, None]], 2)[:, :DIMS[0]].contiguous()
        mix = torch.as_tensor(np.random.default_rng(2).standard_normal((20, 10)),
                              device=dev).to(dtype)
        block[0, 10:] = mix @ block[0, :10]  # rank 10 of 30
        pos = torch.arange(N_VAR, dtype=torch.int32, device=dev).expand(B, N_VAR).contiguous()
        args = (block, pos, pos.clone(), torch.zeros(B, dtype=torch.int32, device=dev),
                torch.zeros(B, N_VAR, dtype=torch.int32, device=dev))
        kw = dict(fr=0, tol=params.tol_linear_dependence)
        got = panel_factorize(*args, **kw)
        want = panel_factorize_ref(*args, **kw)
        torch.cuda.synchronize()
        ndiff, err = _panel_diff(got, want)
        rank0 = int(got[3][0])
        name = "f64" if dtype == torch.float64 else "f32"
        print(f"[B1 {name}] pivot orders differing: {ndiff}/{B}; max |err| where equal: "
              f"{err:.3e}; rank of the rank-deficient block: {rank0} (expect 10)")
        # float32 sums in another order flip a pivot choice where two
        # column norms tie to ~1e-6 relative: about 3% of instances here
        tol, max_diff = (1e-10, 0) if dtype == torch.float64 else (1e-3, B // 10)
        if ndiff > max_diff or err > tol or rank0 != 10:
            raise SystemExit(f"B1 {name} disagrees with its plain version")
        ms = _cuda_ms(lambda: panel_factorize(*args, **kw), 20)
        plain_ms = _cuda_ms(lambda: panel_factorize_ref(*args, **kw), 3)
        print(f"[B1 {name}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call (B={B})")
        own_ms, _ = _own_device_time(f"[B1 {name}]", "panel_factorize_kernel",
                                     lambda: panel_factorize(*args, **kw), 20)
        if dtype == torch.float32:  # the main path's dtype
            r = got[3].double().cpu().numpy()
            flops = float(_panel_flops(r, DIMS[0], np.full_like(r, N_VAR)).sum())
            bound_ms, bound_by = _bound(_nbytes(*args) + _nbytes(*got), flops)
            print(f"[B1 {name}] bound {bound_ms:.5f} ms by {bound_by} "
                  f"({flops / 1e6:.2f} MFLOP, {(_nbytes(*args) + _nbytes(*got)) / 1e6:.2f} MB); "
                  f"each instance is a chain of {int(got[3].max())} pivot steps, one after "
                  f"another")
            report["panel_factorize"].update(max_abs_err=err, ms=ms, own_ms=own_ms,
                                             plain_ms=plain_ms, bound_ms=bound_ms,
                                             bound_by=bound_by)


def _state_args(A, s):
    return (A, s.lb, s.ub, s.ctr_type, s.stamp, s.next_stamp, s.x, s.v, s.Ax, s.n_fact)


def _resume_args(A, r, max_fact):
    """B2's arguments to resume from the result ``r`` of a paused call,
    its bounds, log and detector included.  Status is not an input of the
    kernel: an instance that finished in that call is parked through its
    factorization budget, as the tracker's handover parks resolved
    instances."""
    nf = torch.where(r.status == -1, r.n_fact, max_fact).to(torch.int32)
    return (A, r.lb, r.ub, r.ctr_type, r.stamp, r.next_stamp, r.x, r.v, r.Ax, nf, r.it,
            r[19:27], r[27:31])


def _counters_equal(got, want):
    """Whether two B2 results agree in every status and counter."""
    return all(bool((getattr(got, f) == getattr(want, f)).all())
               for f in ("status", "it", "stamp", "next_stamp", "n_fact"))


def _compare_results(label, got, want, exact):
    """Kernel B2's result against another result of the same call (its
    plain version's, or an uninterrupted run's): statuses, iteration
    counts, working sets, stamps, positions and ranks, x, and the exported
    R on [:rank, :rank] (its error relative to the largest |R| entry, when
    that exceeds 1: float32 rounds in proportion).  ``exact`` (float64):
    every integer equal and floats to 1e-8; otherwise statuses equal and
    floats to 1e-3 where the working sets and pivot orders agree.  Returns
    the largest |x| error."""
    same = (got.ctr_type == want.ctr_type).all(1) & (got.posf == want.posf).all(1) \
        & (got.ranks == want.ranks).all(1)
    ints_equal = _counters_equal(got, want)
    xerr = float((got.x - want.x).abs().amax(1)[same].max())
    K = got.rpad.shape[-1]
    live = torch.arange(K, device=got.rpad.device) < want.ranks[..., None]
    live2 = (live[..., :, None] & live[..., None, :])[same]
    rscale = max(1.0, float(torch.where(live2, want.rpad[same], 0.0).abs().max()))
    rerr = float(torch.where(live2, got.rpad[same] - want.rpad[same], 0.0).abs().max()) / rscale
    print(f"{label} trajectories differing: {int((~same).sum())}/{len(same)}; counters equal: "
          f"{ints_equal}; max |x err| {xerr:.3e}, max |R err| / max(1, |R|) on [:rank,:rank] "
          f"{rerr:.3e} where equal")
    if exact:
        ok = bool(same.all()) and ints_equal and xerr <= 1e-8 and rerr <= 1e-8
    else:
        ok = bool((got.status == want.status).all()) and xerr <= 1e-3 and rerr <= 1e-3 \
            and int((~same).sum()) <= len(same) // 10
    if not ok:
        raise SystemExit(f"{label} disagrees")
    return xerr


_LOG_FIELDS = ("lb", "ub", "log_obj", "log_ctr", "log_type", "log_value", "log_rank",
               "log_cycling", "log_len", "log_overflow", "cyc_counter", "cyc_prev_op",
               "cyc_prev_row", "cyc_prev_type")


def _compare_logs(label, got, want):
    """The bounds, the working-set log and the cycling detector of two
    float64 results: every integer and the bounds equal, the logged values
    to 1e-8."""
    bad = [f for f in _LOG_FIELDS if f != "log_value"
           and not torch.equal(getattr(got, f), getattr(want, f))]
    verr = float((got.log_value - want.log_value).abs().max()) if got.log_value.numel() else 0.0
    print(f"{label} log entries {int(got.log_len.sum())} (longest {int(got.log_len.max())}), "
          f"overflows {int(got.log_overflow.sum())}, detections {int(got.cyc_counter.sum())}; "
          f"fields differing: {bad or 'none'}; max |log value err| {verr:.3e}")
    if bad or verr > 1e-8:
        raise SystemExit(f"{label} log, detector or bounds disagree")


def _rows(r, mask):
    return type(r)(*(t[mask] for t in r))


def _print_bound(label, args, kw, res, struct, n=N_VAR):
    """Print and return B2's bound for one call: every input and output
    once over the memory rate, or the operations that the call's
    iterations needed (at the exported ranks, those of each instance's last
    iteration) over the float32 rate, whichever is larger.  The relaxed
    bounds and the detector are outputs only under cycling handling and
    the log only when it is on: otherwise the result carries the input
    bounds themselves and placeholders that the kernel never touches."""
    outs = list(res[:17])
    if kw["log_cap"]:
        outs += res[19:27]
    if kw["cycling"]:
        outs += [res.lb, res.ub, *res[27:31]]
    nbytes = _nbytes(*(a for a in args if torch.is_tensor(a)), kw["prio"], kw["elig"], *outs)
    flops = _active_set_flops(res, struct.lexlse_dims, n, struct.m)
    bound_ms, bound_by = _bound(nbytes, flops)
    steps = int(res.ranks.sum(1).max())
    print(f"{label} bound {bound_ms:.5f} ms by {bound_by} ({flops / 1e6:.2f} MFLOP for "
          f"{int(res.it.sum())} iterations, {nbytes / 1e6:.2f} MB); the bound takes the whole "
          f"card to stream or multiply, while the longest instance is a chain of "
          f"{int(res.it.max())} iterations of up to {steps} pivot steps each, one after another")
    return bound_ms, bound_by


def _own_device_time(label, kernel, fn, calls):
    """A kernel's own device time per call, by CUDA events recorded right
    around its launch (``tracing.recording(device_events=True)``), beside the
    count and device time of everything else the wrapper launches, from a
    torch.profiler trace of the same calls: the CUDA-event time of the whole
    call cannot tell the kernel from the host's time to issue it.  ``kernel``
    is a part of the kernel's name in csrc/.  Returns (own ms, other
    launches per call)."""
    from lexls_tpu_torch import tracing

    fn()
    torch.cuda.synchronize()
    tracing.reset()
    with tracing.recording(device_events=True):
        for _ in range(calls):
            torch.cuda.synchronize()  # an idle card: the events bracket the kernel alone
            fn()
        torch.cuda.synchronize()
    events = tracing.snapshot().device_events
    own = statistics.median(start.elapsed_time(end) for _, start, end in events)
    rows, wall_ms = _profile(lambda: [fn() for _ in range(calls)])
    others = sum(r[1] for r in rows if kernel not in r[2])
    other_ms = sum(r[0] for r in rows if kernel not in r[2]) / 1e3
    print(f"{label} the kernel's own device time {own:.4f} ms (median of {len(events)} launches, "
          f"events around the launch); beside it the wrapper launches {others / calls:g} other "
          f"kernels per call ({other_ms / calls:.4f} ms of device time; torch.profiler); profiled "
          f"host wall {wall_ms / calls:.4f} ms per call")
    return own, others / calls


def _options_device_time(label, args, kws, calls=10):
    """B2's own device time per call under each set of options, and what
    else its wrapper launches (nothing, since the kernel reads the caller's
    state and writes its own outputs)."""
    from lexls_tpu_torch.ops import fused_active_set

    own = {}
    for what, kw in kws:
        own[what], others = _own_device_time(f"{label} options {what}:", "fused_kernel",
                                             lambda: fused_active_set(*args, **kw), calls)
        if what == "off" and others > 2:
            raise SystemExit(f"{label} the wrapper issues {others:g} launches beside the kernel")
    return own


def _time_layouts(label, args, kw, struct, reps):
    """B2 with the LOD in shared memory and with the LOD in device memory
    (the small vectors in shared memory either way), in turns; the rule of
    ``fused_layout`` picks one by the bytes."""
    from lexls_tpu_torch.ops import fused_active_set
    from lexls_tpu_torch.ops.fused import fused_layout

    A = args[0]
    lay = fused_layout(struct.m, A.shape[2], len(struct.lexlse_dims), struct.d0,
                       max(1, max(struct.lexlse_dims)), A.dtype)
    if lay.nbytes_all_shared > 232448:
        print(f"{label} the LOD cannot live in shared memory here ({lay.nbytes_all_shared} bytes)")
        return
    turns = [_cuda_ms(lambda f=f: fused_active_set(*args, lod_shared=f, **kw), reps)
             for f in (True, False, False, True)]
    print(f"{label} kernel ms per call with the LOD in shared / device / device / shared "
          f"memory: {' / '.join(f'{t:.4f}' for t in turns)}; the rule takes "
          f"{'shared' if lay.in_shared else 'device'} memory ({lay.nbytes_all_shared} bytes)")


def print_layouts():
    """The shared-memory bytes, the layout that the rule picks and the
    resident blocks per SM (by the bytes, and as the card reports them for
    the built kernel) of every shape this script runs, and of one shape
    whose LOD does not fit."""
    from lexls_tpu_torch.ops.fused import fused_layout, fused_occupancy
    from lexls_tpu_torch.ops.panel_lqr import panel_layout, panel_occupancy

    sb_general = SB_DIMS[1:]
    for dtype in (torch.float32, torch.float64):
        name = "f64" if dtype == torch.float64 else "f32"
        shapes = (("bench", sum(DIMS), N_VAR, len(DIMS), 0, max(DIMS)),
                  ("test_01", sum(SB_DIMS), SB_N, len(sb_general), SB_DIMS[0], max(sb_general)),
                  ("config 2", 88, 88, 2, 0, 44),
                  ("n=160, m=200", 200, 160, 4, 0, 50))
        for what, m, n, p, d0, dmax in shapes:
            lay = fused_layout(m, n, p, d0, dmax, dtype)
            print(f"[layout B2 {name} {what}] m={m} n={n} p={p} d0={d0}: LOD in "
                  f"{'shared' if lay.in_shared else 'device'} memory (all shared would be "
                  f"{lay.nbytes_all_shared} bytes), {lay.nbytes} bytes of shared memory a block, "
                  f"row stride {lay.ld}; blocks per SM {lay.blocks_per_sm} by the bytes, "
                  f"{fused_occupancy(lay, dtype)} as the card reports")
        for what, dim, n in (("bench", DIMS[0], N_VAR), ("test_01", max(sb_general), SB_N),
                             ("config 2", 44, 88)):
            lay = panel_layout(dim, n, dtype)
            print(f"[layout B1 {name} {what}] dim={dim} n={n}: block in "
                  f"{'shared' if lay.in_shared else 'device'} memory, {lay.nbytes} bytes of "
                  f"shared memory a block; blocks per SM {lay.blocks_per_sm} by the bytes, "
                  f"{panel_occupancy(lay, dtype)} as the card reports")


def check_phase1(dev, report):
    """Phase 1's kernels (``csrc/phase1.cu``) on a warm step of the bench
    problem, float32, at B=384 and B=10,240: the activation from the cold
    working set, and the hot start from the cold answer.  Each against its
    plain version on the same CUDA tensors (the activation equal; of the hot
    start's fields Ax, v and dv to 1e-6 of sum |A x|, every other one equal,
    and v, Adx and dv equal to the plain formulas on its own Ax), then timed:
    the kernel's own device time (CUDA events around its launch, under
    ``tracing.recording(device_events=True)``) beside its bound (every
    input and output once over 3.35 TB/s, or its operations over 67
    TFLOP/s) and the plain version's device time (CUDA events around the
    call), and the host's time to issue each (perf_counter, no synchronize;
    the median of 50 calls)."""
    from lexls_tpu_torch import Structure, solve_core_fused
    from lexls_tpu_torch.lexlsi import _form_step, _initialize_v0
    from lexls_tpu_torch.ops import activation, activation_ref, phase1_warm, phase1_warm_ref

    def issue_us(fn, calls=50):
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    for Bn in (B, PHASE1_B_LARGE):
        prob, params, base, drifts, lb, ub = _bench_problem(torch.float32, dev, Bn)
        struct = Structure.of(prob)
        m, n = prob.n_ctr, prob.n_var
        A0, A1 = ((base + drifts[k]).contiguous() for k in (0, 1))
        lbs, ubs = lb.expand(Bn, m).contiguous(), ub.expand(Bn, m).contiguous()
        zi = torch.zeros(Bn, m, dtype=torch.int32, device=dev)
        zx, zv = (torch.zeros(Bn, k, dtype=torch.float32, device=dev) for k in (n, m))
        cold = solve_core_fused(A0, lbs, ubs, *activation(A0, lbs, ubs, zi, struct.d0), zx, zv,
                                None, struct=struct, params=params, x_guess_specified=False,
                                v0_specified=False)
        act_args = (A1, lbs, ubs, cold.ctr_type, struct.d0)
        c, s, ns = activation(*act_args)
        want = activation_ref(*act_args)
        warm_args = (A1, lbs, ubs, c, s, ns, cold.x, zv)
        kw = dict(struct=struct, params=params, v0_specified=False)
        got_w, want_w = phase1_warm(*warm_args, **kw), phase1_warm_ref(*warm_args, **kw)
        # Ax, and v and dv from it, within 1e-6 of sum |A x| (another summation order);
        # v, Adx and dv equal to the plain formulas on the kernel's own Ax and working set;
        # every other field equal to the plain version's
        scale = (A1.abs() @ got_w.x.abs()[:, :, None])[..., 0].clamp_min(1e-30)
        err = {f: float(((getattr(got_w, f) - getattr(want_w, f)).abs() / scale).max())
               for f in ("Ax", "v", "dv")}
        own_Adx, own_dv = _form_step(A1, lbs, ubs, got_w.ctr_type, got_w.Ax, got_w.v, got_w.dx)
        own = {"v": _initialize_v0(got_w.ctr_type, got_w.Ax, lbs, ubs, params), "Adx": own_Adx,
               "dv": own_dv}
        differ = [f"activation {k}" for k, g, w in zip(("ctr_type", "stamp", "next_stamp"),
                                                       (c, s, ns), want) if not torch.equal(g, w)]
        differ += [f for f in got_w._fields
                   if f not in err and not torch.equal(getattr(got_w, f), getattr(want_w, f))]
        differ += [f"{f} on its own Ax" for f, w in own.items()
                   if not torch.equal(getattr(got_w, f), w)]
        print(f"[phase1 B={Bn}] against the plain versions: the activation's fields and the hot "
              f"start's {len(got_w._fields) - len(err)} exact fields equal, and v, Adx and dv "
              f"on its own Ax: {not differ} {differ}; max |err| / sum |A x|: "
              + ", ".join(f"{f} {e:.3e}" for f, e in err.items()) + " (bound 1e-6)")
        if differ or max(err.values()) > 1e-6:
            raise SystemExit(f"phase 1's kernels disagree with their plain versions at B={Bn}")
        es, bm = 4, Bn * m
        a_bytes = A1.numel() * es
        nbytes = {"activation": a_bytes + 2 * bm * es + 3 * bm * 4 + Bn * 4,
                  "phase1_warm": a_bytes + 2 * bm * es + 2 * Bn * n * es + 2 * bm * 4 + Bn * 4
                  + 4 * bm * es + 2 * bm * 4 + 5 * Bn * 4 + Bn}
        flops = {"activation": 2 * bm * n, "phase1_warm": 2 * bm * n + 12 * bm}
        for key, kernel, fn, ref in (
                ("activation", "activation_kernel", lambda: activation(*act_args),
                 lambda: activation_ref(*act_args)),
                ("phase1_warm", "warm_kernel", lambda: phase1_warm(*warm_args, **kw),
                 lambda: phase1_warm_ref(*warm_args, **kw))):
            own, others = _own_device_time(f"[phase1 {key} B={Bn}]", kernel, fn, 20)
            plain = _cuda_ms(ref, 20)
            bound_ms, by = _bound(nbytes[key], flops[key])
            host, host_plain = issue_us(fn), issue_us(ref)
            print(f"[phase1 {key} B={Bn}] own {own:.4f} ms against a bound of {bound_ms:.4f} ms "
                  f"by {by} ({nbytes[key] / 1e6:.2f} MB, {flops[key] / 1e6:.2f} MFLOP; "
                  f"{100 * bound_ms / own:.1f}% of its roofline); the plain version "
                  f"{plain:.4f} ms on the card; host issue {host:.1f} us, the plain version's "
                  f"{host_plain:.1f} us")
            if others:
                raise SystemExit(f"phase1 {key}: the wrapper launches {others:g} other kernels")
            report[key].setdefault("card_ms", {})[f"B{Bn}"] = round(own, 5)
            report[key].setdefault("plain_ms", {})[f"B{Bn}"] = round(plain, 5)
            report[key].setdefault("bound_ms", {})[f"B{Bn}"] = round(bound_ms, 5)


def check_fused(dev, report):
    """B2 against fused_active_set_ref on the bench problem, cold (step 0)
    and warm (step 1 from the kernel's step-0 result): one uninterrupted
    call, then a call paused by ``iter_cap=1`` and resumed with ``it0``,
    which must retrace the uninterrupted call, with the exported factors
    against the plain version's.  In float64 both run with the working-set
    log and cycling handling on (and the kernel also with them off, which
    must not change its trajectory), so the pause carries the log and the
    detector across; float32 runs them off and times the kernel with the
    log on and with both on beside that."""
    import dataclasses

    from lexls_tpu_torch.lexlsi import Structure, active_set_kwargs
    from lexls_tpu_torch.ops import fused_active_set, fused_active_set_ref

    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        exact = dtype == torch.float64
        prob, params, base, drifts, lb, ub = _bench_problem(dtype, dev)
        struct = Structure.of(prob)
        kw_off = active_set_kwargs(struct, params, dev)
        kw_log = active_set_kwargs(
            struct, dataclasses.replace(params, log_working_set_enabled=True), dev)
        kw_both = active_set_kwargs(
            struct, dataclasses.replace(params, log_working_set_enabled=True,
                                        cycling_handling_enabled=True), dev)
        kw = kw_both if exact else kw_off
        lbs, ubs = lb.expand(B, -1).contiguous(), ub.expand(B, -1).contiguous()
        prev = None
        for step in (0, 1):
            A = (base + drifts[step]).contiguous()
            s = _phase1(A, lbs, ubs, struct, params, *(prev or (None, None)))
            args = _state_args(A, s)
            got = fused_active_set(*args, **kw)
            want = fused_active_set_ref(*args, **kw)
            torch.cuda.synchronize()
            label = f"[B2 {name} {'cold' if step == 0 else 'warm'}]"
            if exact:
                label += " log+cycling"
                _compare_logs(f"{label} kernel against plain:", got, want)
                off = fused_active_set(*args, **kw_off)
                same_off = all(torch.equal(a, b) for a, b in zip(got[:17], off[:17]))
                print(f"{label} the kernel with both options off: results identical "
                      f"{same_off}; log rows {tuple(off.log_obj.shape)}")
                if not same_off or int(got.cyc_counter.sum()) != 0:
                    # no cycle occurs here, so the options may only record
                    raise SystemExit(f"{label} the options changed the trajectory")
            print(f"{label} status(kernel) {torch.bincount(got.status + 1).tolist()} "
                  f"(-1,0,1,2 counts); iterations max {int(got.it.max())} mean "
                  f"{float(got.it.float().mean()):.3f}")
            xerr = _compare_results(f"{label} kernel against plain:", got, want, exact)
            if not bool((got.status == 0).all()):
                raise SystemExit(f"{label} not every instance solved")

            # pause after one iteration, then resume to the end
            got1 = fused_active_set(*args, iter_cap=1, **kw)
            want1 = fused_active_set_ref(*args, iter_cap=1, **kw)
            got2 = fused_active_set(*_resume_args(A, got1, kw["max_fact"]), **kw)
            torch.cuda.synchronize()
            paused = got1.status == -1
            print(f"{label} iter_cap=1: paused {int(paused.sum())}/{B}, iterations "
                  f"{sorted(set(got1.it.tolist()))}")
            _compare_results(f"{label} iter_cap=1, kernel against plain:", got1, want1, exact)
            if not bool((got1.it == 1).all()) or not bool(((got1.status == 0) | paused).all()):
                raise SystemExit(f"{label} iter_cap=1 did not pause after one iteration")
            # paused instances resumed must end where the uninterrupted call
            # ended, and their counters sum; finished ones run nothing more
            if step == 0 and not bool(paused.any()):
                raise SystemExit(f"{label} no instance paused: the resume was not exercised")
            if bool(paused.any()):
                sel = lambda r: _rows(r, paused)  # noqa: E731
                resumed = sel(got2)._replace(n_act=(got1.n_act + got2.n_act)[paused])
                _compare_results(f"{label} resumed with it0 against uninterrupted:", resumed,
                                 sel(got), exact)
                if exact:
                    _compare_logs(f"{label} resumed with it0, log_state, cyc_state against "
                                  f"uninterrupted:", resumed, sel(got))
                if exact and not bool((resumed.n_act == got.n_act[paused]).all()):
                    raise SystemExit(f"{label} activations of the two phases do not sum")
                _compare_results(f"{label} resumed export against the plain version's:",
                                 resumed, sel(want), exact)
            done = ~paused
            if bool(done.any()) and not (
                    torch.equal(got2.x[done], got1.x[done]) and int(got2.ranks[done].sum()) == 0
                    and bool((got2.it[done] == got1.it[done]).all())):
                raise SystemExit(f"{label} a finished instance did not keep its inputs")

            reps = 3 if step == 0 else 10
            if step == 0:
                ms = _cuda_ms(lambda: fused_active_set(*args, **kw), reps)
                ms1 = _cuda_ms(lambda: fused_active_set(*args, iter_cap=1, **kw), 10)
                print(f"{label} kernel {ms:.4f} ms per call, {ms1:.4f} ms with iter_cap=1 (B={B})")
                if dtype == torch.float32:
                    _print_bound(label, args, kw, got, struct)
            else:
                ms = _cuda_ms(lambda: fused_active_set(*args, **kw), reps)
                plain_ms = _cuda_ms(lambda: fused_active_set_ref(*args, **kw), 2)
                print(f"{label} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call (B={B})")
            # the options' cost: off, log on, both on, off again, in turns
            turns = [_cuda_ms(lambda k=k: fused_active_set(*args, **k), reps)
                     for k in (kw_off, kw_log, kw_both, kw_off)]
            print(f"{label.split(' log')[0]} kernel ms per call with the options off / log on "
                  f"/ log and cycling on / off again: "
                  f"{' / '.join(f'{t:.4f}' for t in turns)}")
            if step == 1:
                own = _options_device_time(label.split(' log')[0], args,
                                           (("off", kw_off), ("log on", kw_log),
                                            ("log and cycling on", kw_both),
                                            ("off again", kw_off)))
            else:
                own = _options_device_time(label.split(' log')[0], args, (("off", kw_off),),
                                           calls=3)
            if dtype == torch.float32:
                report["fused_active_set"]["own_ms_" + ("cold" if step == 0 else "warm")] = \
                    own["off"]
            _time_layouts(label.split(' log')[0], args, kw_off, struct, reps)
            if step == 1 and dtype == torch.float32:  # the main path's most frequent call
                bound_ms, bound_by = _print_bound(label, args, kw, got, struct)
                report["fused_active_set"].update(
                    max_abs_err=xerr, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
            prev = (got.x, got.ctr_type)


def _simple_bounds_problem(steps):
    """One random hierarchy of the test_01 shape with a simple-bounds level,
    its structure, and ``steps`` independent perturbations of the general
    rows for each of B instances, (steps, B, m, n); the bound rows stay
    unit rows."""
    from lexls_tpu_torch.lexlsi import Structure
    from lexls_tpu_torch.oracle import random_inequality_hierarchy

    rng = np.random.default_rng(3)
    prob = random_inequality_hierarchy(rng, SB_N, list(SB_DIMS), equality_fraction=0.1,
                                       tight_fraction=0.3, simple_bounds=True)
    struct = Structure.of(prob)
    noise = 1e-3 * rng.standard_normal((steps, B) + prob.A.shape)
    noise[:, :, :struct.d0] = 0.0
    return prob, struct, noise


def check_simple_bounds(dev):
    """B2 with a simple-bounds level (d0 > 0) against its plain version at
    the test_01 shape: SB_B_PLAIN instances cold for SB_CAP iterations (a
    cold solve here takes several hundred, too many for the plain version)
    and a whole warm step; the kernel also solves B instances cold."""
    from lexls_tpu_torch.lexlsi import active_set_kwargs
    from lexls_tpu_torch.ops import fused_active_set, fused_active_set_ref
    from lexls_tpu_torch.types import ParametersLexLSI

    prob, struct, noise = _simple_bounds_problem(2)
    d0 = struct.d0
    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        exact = dtype == torch.float64
        tols = {} if exact else dict(tol_linear_dependence=1e-7, tol_wrong_sign_lambda=1e-4,
                                     tol_correct_sign_lambda=1e-6, tol_feasibility=1e-5)
        params = ParametersLexLSI(max_number_of_factorizations=1000, **tols)
        kw = active_set_kwargs(struct, params, dev)
        t = lambda a: torch.as_tensor(a, device=dev).to(dtype)  # noqa: E731
        A0, A1 = t(prob.A + noise[0]), t(prob.A + noise[1])
        lbs, ubs = t(np.tile(prob.lb, (B, 1))), t(np.tile(prob.ub, (B, 1)))
        s = _phase1(A0, lbs, ubs, struct, params)
        cold = fused_active_set(*_state_args(A0, s), **kw)
        torch.cuda.synchronize()
        label = f"[B2 simple bounds {name}]"
        print(f"{label} n={SB_N} dims={SB_DIMS} (d0={d0}, Kmax={cold.rpad.shape[-1]}), cold "
              f"B={B}: status {torch.bincount(cold.status + 1).tolist()} (-1,0,1,2); iterations "
              f"mean {float(cold.it.float().mean()):.2f} max {int(cold.it.max())}; bound rows "
              f"active at the end, mean {float((cold.ctr_type[:, :d0] != 0).float().sum(1).mean()):.1f}")
        if not bool((cold.status == 0).all()) or not bool(torch.isfinite(cold.x).all()):
            raise SystemExit(f"{label} cold solve failed")
        fixed = (cold.ctr_type[:, :d0] == 1) | (cold.ctr_type[:, :d0] == 3)
        xb = cold.x[:, list(struct.var_idx)]
        if float((xb - s.lb[:, :d0]).abs()[fixed].max()) > 1e-4:
            raise SystemExit(f"{label} a variable fixed at its lower bound is not there")

        Bp = SB_B_PLAIN
        head = lambda args: tuple(a[:Bp].contiguous() for a in args)  # noqa: E731
        args = head(_state_args(A0, s))
        _compare_results(f"{label} cold, iter_cap={SB_CAP}, B={Bp}, kernel against plain:",
                         fused_active_set(*args, iter_cap=SB_CAP, **kw),
                         fused_active_set_ref(*args, iter_cap=SB_CAP, **kw), exact)
        # the warm step: whole in float64; in float32 this degenerate shape
        # (57 of 60 bounds active) takes hundreds of iterations and some
        # instances cycle until the budget ends (measure_test01_cycling
        # looks at them), so float32 compares the first SB_CAP iterations
        # and only reports what the whole step does
        s1 = _phase1(A1, lbs, ubs, struct, params, cold.x, cold.ctr_type)
        cap = dict(iter_cap=0 if exact else SB_CAP)
        what = "warm step" if exact else f"warm step, iter_cap={SB_CAP}"
        args = head(_state_args(A1, s1))
        got, want = fused_active_set(*args, **cap, **kw), fused_active_set_ref(*args, **cap, **kw)
        torch.cuda.synchronize()
        print(f"{label} {what}, B={Bp}: iterations mean {float(got.it.float().mean()):.2f} "
              f"max {int(got.it.max())}, removals {int(got.n_deact.sum())}")
        _compare_results(f"{label} {what}, B={Bp}, kernel against plain:", got, want, exact)
        if exact and not bool((got.status == 0).all()):
            raise SystemExit(f"{label} warm step not solved")
        whole = fused_active_set(*_state_args(A1, s1), **kw)
        print(f"{label} whole warm step, kernel, B={B}: status "
              f"{torch.bincount(whole.status + 1).tolist()} (-1,0,1,2; -1 = budget of "
              f"{params.max_number_of_factorizations} spent); iterations mean "
              f"{float(whole.it.float().mean()):.2f} max {int(whole.it.max())}")
        ms = _cuda_ms(lambda: fused_active_set(*_state_args(A1, s1), **cap, **kw), 5)
        print(f"{label} {what}, kernel {ms:.4f} ms per call (B={B})")


def check_tracked_simple_bounds(dev):
    """The tracked path over a simple-bounds level at the test_01 shape,
    float64 (float32 cycles at this shape, see ``check_simple_bounds``):
    B sequences of SB_T steps, a cold solve and warm steps whose general
    rows drift, against the fused path on the same sequences."""
    from bench_torch import TRACKED
    from lexls_tpu_torch import solve_sequence_batched_fused
    from lexls_tpu_torch.types import ParametersLexLSI

    prob, struct, noise = _simple_bounds_problem(SB_T)
    params = ParametersLexLSI(max_number_of_factorizations=1000)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    A_seq = t(np.moveaxis(prob.A + np.cumsum(noise, axis=0), 0, 1))  # (B, SB_T, m, n)
    lb_seq = t(np.broadcast_to(prob.lb, (B, SB_T, prob.n_ctr)).copy())
    ub_seq = t(np.broadcast_to(prob.ub, (B, SB_T, prob.n_ctr)).copy())
    run = lambda **kw: solve_sequence_batched_fused(  # noqa: E731
        A_seq, lb_seq, ub_seq, t(prob.regularization), struct=struct, params=params, **kw)
    _, v, status, it, _, _ = run()
    stats = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tx, tv, tstatus, tit, _, _ = run(tracked=True, stats=stats, **TRACKED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nf, nt = _level_norms(v, prob.dims), _level_norms(tv, prob.dims)
    rel = float(((nt - nf).abs() / (1.0 + nf)).amax())
    print(f"[tracked path, simple bounds f64] n={SB_N} dims={SB_DIMS} B={B} T={SB_T}: "
          f"{wall:.3f} s host wall; solved {int((tstatus == 0).sum())}/{B * SB_T} (fused path "
          f"{int((status == 0).sum())}); iterations per step, mean "
          f"{[round(float(c), 2) for c in tit.double().mean(0)]} (fused path "
          f"{[round(float(c), 2) for c in it.double().mean(0)]}); (tracker trips, handed to "
          f"B2) per step {stats}; per-level |v| against the fused path: max |diff| / (1 + |v|) "
          f"{rel:.3e}")
    if not bool((tstatus == 0).all()) or not bool((status == 0).all()) \
            or not bool(torch.isfinite(tx).all()) or rel > 1e-6:
        raise SystemExit("tracked path with simple bounds failed or disagrees with the fused path")


def check_exact_tier(dev):
    """B2 against ``solve_core_batched`` on the card: the cold bench
    problem in float64 with the working-set log and cycling handling on.
    The exact tier factorizes through kernel B1 and does the rest of the
    iteration in torch, so it shares no stage with B2: statuses, iteration
    counts, working sets, logs and detector state must be equal, x and v
    to 1e-8.  B1 is launched once per level by the cold phase 1 and once
    per level in every pass of the loop, and a pass runs while any
    instance is alive."""
    import dataclasses

    from lexls_tpu_torch import Structure, batched_initial_arrays, solve_core_batched
    from lexls_tpu_torch import solve_core_fused

    prob, params, base, drifts, lb, ub = _bench_problem(torch.float64, dev)
    params = dataclasses.replace(params, log_working_set_enabled=True,
                                 cycling_handling_enabled=True)
    struct = Structure.of(prob)
    A = (base + drifts[0]).contiguous()
    args = (A, lb.expand(B, -1).contiguous(), ub.expand(B, -1).contiguous(),
            *batched_initial_arrays(prob, B, dev), None)
    kw = dict(struct=struct, params=params, x_guess_specified=False, v0_specified=False)
    fused = solve_core_fused(*args, **kw)
    with _counting() as counts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exact = solve_core_batched(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, passes, p = counts["panel_factorize"], int(exact.it.max()), len(struct.lexlse_dims)
    ints = ("status", "it", "ctr_type", "stamp", "next_stamp", "n_act", "n_deact", "n_fact")
    bad = [f for f in ints + _LOG_FIELDS if f != "log_value"
           and not torch.equal(getattr(exact, f), getattr(fused, f))]
    ndiff = int((exact.ctr_type != fused.ctr_type).any(1).sum())
    errs = {f: float((getattr(exact, f) - getattr(fused, f)).abs().max())
            for f in ("x", "v", "log_value")}
    print(f"[B2 against solve_core_batched f64 cold, log+cycling] B={B}: exact tier {wall:.3f} s "
          f"host wall, {passes} passes, B1 launches {launches} (expect {p} x ({passes} + 1) = "
          f"{p * (passes + 1)}); status {torch.bincount(exact.status + 1).tolist()} (-1,0,1,2); "
          f"log entries {int(exact.log_len.sum())}; working sets differing {ndiff}/{B}; fields "
          f"differing: {bad or 'none'}; max |err| x {errs['x']:.3e}, v {errs['v']:.3e}, log value "
          f"{errs['log_value']:.3e}")
    if bad or max(errs.values()) > 1e-8 or launches != p * (passes + 1) \
            or not bool((exact.status == 0).all()):
        raise SystemExit("B2 and solve_core_batched disagree, or B1's launches are off")


def check_cycling_fixture(dev):
    """The frozen degenerate instance of ``tests/golden/cycling_fixtures.npz``
    (n=4, dims (2, 3)), which re-adds the constraint it just removed,
    through the kernel in float64: one relaxation and PROBLEM_SOLVED; with
    ``cycling_max_counter=0`` PROBLEM_SOLVED_CYCLING_HANDLING."""
    from pathlib import Path

    from lexls_tpu_torch import InequalityHierarchy, ParametersLexLSI, Structure
    from lexls_tpu_torch import initial_activation, solve_core_fused

    fz = np.load(Path(__file__).resolve().parent / "tests" / "golden" / "cycling_fixtures.npz")
    A, lb, ub, guess = (fz[f"relax_once_{k}"] for k in ("A", "lb", "ub", "guess"))
    prob = InequalityHierarchy(A=A, lb=lb, ub=ub, dims=(2, 3), n_var=4)
    t = lambda a: torch.as_tensor(np.asarray(a)[None], device=dev)  # noqa: E731
    c0, s0, n0 = initial_activation(prob, guess)
    for max_counter, want in ((50, (1, 0)), (0, (0, 1))):
        params = ParametersLexLSI(max_number_of_factorizations=60, log_working_set_enabled=True,
                                  cycling_handling_enabled=True, cycling_max_counter=max_counter)
        st = solve_core_fused(t(A), t(lb), t(ub), t(c0), t(s0), t(n0), t(np.zeros(4)),
                              t(np.zeros(5)), None, struct=Structure.of(prob), params=params,
                              x_guess_specified=False, v0_specified=False)
        got = (int(st.cyc_counter[0]), int(st.status[0]))
        moved = float((st.lb - t(lb)).abs().sum() + (st.ub - t(ub)).abs().sum())
        print(f"[B2 cycling fixture f64] cycling_max_counter={max_counter}: (counter, status) "
              f"{got} (expect {want}); iterations {int(st.it[0])}; log entries "
              f"{int(st.log_len[0])}, flagged {int(st.log_cycling.sum())}; bounds moved by "
              f"{moved:.3e}")
        if got != want or (max_counter and (moved == 0.0 or int(st.log_cycling.sum()) != 1)):
            raise SystemExit("the cycling fixture did not end as the reference does")


def _log_loops(res, rows):
    """For each instance in ``rows``, the period of the loop its log ends
    in: the smallest P whose last P entries (objective, row, type) repeat
    the P before them three times over, 0 if none up to 64.  P = 2 with
    one constraint removed and added back is the pair that cycling
    handling detects."""
    key = (res.log_obj * 4096 + res.log_ctr) * 8 + res.log_type
    out = []
    for b in rows:
        seq = key[b, :int(res.log_len[b])].tolist()
        period = 0
        for P in range(1, 65):
            if len(seq) >= 4 * P and all(seq[-P:] == seq[-(k + 1) * P:-k * P] for k in (1, 2, 3)):
                period = P
                break
        pair = period == 2 and seq[-1] // 8 == seq[-2] // 8
        out.append((period, pair))
    return out


def measure_test01_cycling(dev):
    """The ``test_01`` shape in float32, warm step, B=384 (a measurement,
    nothing fails on its counts): the kernel with cycling handling off and
    on, each with the log off and on; how many solves spend their budget,
    how many cycles are detected, how many end
    PROBLEM_SOLVED_CYCLING_HANDLING, and whether the logs of those that
    spend the budget end in a REMOVE/ADD pair of one constraint or in a
    longer loop.  The log must not change what the kernel does."""
    from collections import Counter

    from lexls_tpu_torch.lexlsi import active_set_kwargs
    from lexls_tpu_torch.ops import fused_active_set
    from lexls_tpu_torch.types import ParametersLexLSI

    prob, struct, noise = _simple_bounds_problem(2)
    t = lambda a: torch.as_tensor(a, device=dev).to(torch.float32)  # noqa: E731
    A0, A1 = t(prob.A + noise[0]), t(prob.A + noise[1])
    lbs, ubs = t(np.tile(prob.lb, (B, 1))), t(np.tile(prob.ub, (B, 1)))
    tols = dict(tol_linear_dependence=1e-7, tol_wrong_sign_lambda=1e-4,
                tol_correct_sign_lambda=1e-6, tol_feasibility=1e-5)
    base = ParametersLexLSI(max_number_of_factorizations=1000, **tols)
    s = _phase1(A0, lbs, ubs, struct, base)
    cold = fused_active_set(*_state_args(A0, s), **active_set_kwargs(struct, base, dev))
    s1 = _phase1(A1, lbs, ubs, struct, base, cold.x, cold.ctr_type)
    args = _state_args(A1, s1)
    small = float((torch.minimum(lbs.abs(), ubs.abs()) < 0.25).float().mean())
    print(f"[test_01 f32 warm] n={SB_N} dims={SB_DIMS} B={B}, budget 1000, cycling_relax_step "
          f"1e-8, cycling_max_counter 50; share of rows with a bound below 0.25 in size (where "
          f"float32 keeps a step of 1e-8): {small:.3f}")
    results = {}
    for cyc in (False, True):
        for log in (False, True):
            params = ParametersLexLSI(max_number_of_factorizations=1000,
                                      cycling_handling_enabled=cyc, log_working_set_enabled=log,
                                      **tols)
            kw = active_set_kwargs(struct, params, dev)
            r = results[cyc, log] = fused_active_set(*args, **kw)
            ms = _cuda_ms(lambda: fused_active_set(*args, **kw), 2)
            spent = r.status == -1
            print(f"[test_01 f32 warm] cycling {'on ' if cyc else 'off'} log "
                  f"{'on ' if log else 'off'}: budget spent {int(spent.sum())}/{B}, ended "
                  f"PROBLEM_SOLVED {int((r.status == 0).sum())}, "
                  f"PROBLEM_SOLVED_CYCLING_HANDLING {int((r.status == 1).sum())}; detections "
                  f"{int(r.cyc_counter.sum())} in {int((r.cyc_counter > 0).sum())} instances; "
                  f"iterations mean {float(r.it.float().mean()):.2f} max {int(r.it.max())}; "
                  f"kernel {ms:.3f} ms")
        a, b = results[cyc, False], results[cyc, True]
        if not all(torch.equal(x, y) for x, y in zip(a[:19], b[:19])):
            raise SystemExit("[test_01 f32 warm] the log changed what the kernel does")
    for cyc in (False, True):
        r = results[cyc, True]
        rows = torch.nonzero(r.status == -1)[:, 0].tolist()
        host = type(r)(*(x.cpu() for x in r))
        loops = _log_loops(host, rows)
        pairs = sum(1 for _, pair in loops if pair)
        periods = Counter(P for P, pair in loops if not pair)
        print(f"[test_01 f32 warm] cycling {'on' if cyc else 'off'}: of {len(rows)} solves that "
              f"spent the budget, logs ending in a REMOVE/ADD pair of one constraint: {pairs}; "
              f"in a longer loop, by period: {dict(sorted(periods.items()))} (0 = no loop up to "
              f"period 64); log overflows {int(r.log_overflow.sum())}")
    on = results[True, True]
    ended = on.status == 1
    if bool(ended.any()):
        moved = ((on.lb != lbs) | (on.ub != ubs)).sum(1)
        print(f"[test_01 f32 warm] cycling on: in the {int(ended.sum())} solves ended by the "
              f"detector, bounds that a relaxation moved: mean "
              f"{float(moved[ended].float().mean()):.2f} per instance; counter mean "
              f"{float(on.cyc_counter[ended].float().mean()):.1f}")


def _plain_sequence(A_seq, lb_seq, ub_seq, struct, params):
    """The sequence loop of ``solve_sequence_batched_fused`` with every warm
    step's active-set loop through B2's plain version (the cold step, which
    the slope cancels, runs through the kernel as in the library).
    Returns (x, status, ctr_type), status as the active-set loop leaves it
    (UNKNOWN where the factorization budget ran out)."""
    from lexls_tpu_torch.lexlsi import active_set_kwargs
    from lexls_tpu_torch.ops import fused_active_set, fused_active_set_ref

    kw = active_set_kwargs(struct, params, A_seq.device)
    x = ct = None
    outs = []
    for t in range(A_seq.shape[1]):
        A, lb, ub = (a[:, t].contiguous() for a in (A_seq, lb_seq, ub_seq))
        s = _phase1(A, lb, ub, struct, params, x, ct)
        run = fused_active_set if t == 0 else fused_active_set_ref
        out = run(A, s.lb, s.ub, s.ctr_type, s.stamp, s.next_stamp, s.x, s.v, s.Ax, s.n_fact,
                  **kw)
        x, ct = out.x, out.ctr_type
        outs.append((out.x, out.status, out.ctr_type))
    return tuple(torch.stack(f, 1) for f in zip(*outs))


def _sequence_times(fn, Ts, reps):
    """Milliseconds of ``fn(T)`` for each T (CUDA events), the Ts
    interleaved within each of ``reps`` rounds after one warm-up round,
    so that a drift of the card's clock falls on every T alike.
    Returns {T: [ms of round 0, 1, ...]}."""
    times = {T: [] for T in Ts}
    for r in range(reps + 1):
        for T in Ts:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn(T)
            end.record()
            end.synchronize()
            if r > 0:
                times[T].append(start.elapsed_time(end))
    return times


def _warm_rate(times, lo, hi):
    """Warm solves/s per round, from the slope of that round's T=lo and
    T=hi times; returns (ms per warm step per round, rate per round)."""
    steps = [(b - a) / (hi - lo) for a, b in zip(times[lo], times[hi])]
    return steps, [B / (s / 1e3) for s in steps]


def _spread(vals):
    q = statistics.quantiles(vals, n=4, method="inclusive")
    return (f"median {statistics.median(vals):.4f} (min {min(vals):.4f}, q1 {q[0]:.4f}, "
            f"q3 {q[2]:.4f}, max {max(vals):.4f})")


def profile_sequence(label, run):
    """Device time per kernel over one T=T_MAX sequence (torch.profiler)
    and the share of it that B2 takes; busy share against the profiled
    host wall.  Prints 'not measured' when the profiler sees no device
    time."""
    rows, wall_ms = _profile(lambda: run(T_MAX))
    total = sum(r[0] for r in rows) / 1e3
    if total == 0:
        print(f"[profile {label}] the profiler shows no device time: device shares not measured")
        return
    b2 = sum(r[0] for r in rows if "fused_kernel" in r[2]) / 1e3  # csrc/fused.cu
    print(f"[profile {label}] T={T_MAX} sequence, profiled host wall {wall_ms:.3f} ms; device "
          f"time {total:.3f} ms ({100 * total / wall_ms:.1f}% of the profiled wall) in "
          f"{sum(r[1] for r in rows)} kernel launches; B2 {b2:.3f} ms "
          f"({100 * b2 / total:.1f}% of device time); everything else {total - b2:.3f} ms")
    for us, count, key in rows[:6]:
        print(f"  {us / 1e3:10.3f} ms  {count:6d} calls  {key[:90]}")


def _profile(fn):
    """(device-side rows (self device us, count, name), host wall ms) of
    one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side rows only: a host op (aten::...) also carries the device
    # time of the kernels it launched, which would count them twice
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    return rows, wall_ms


def measure_warm_step_host(A_seq, lb_seq, ub_seq, reg, struct, params, x, ct, steps=12):
    """Whether the host or the card sets the pace of a warm step of the
    fused path: warm steps 1..steps as the sequence loop runs them (each
    from the recorded x and working set of the step before), the host's
    time to issue them (``time.perf_counter()`` with no synchronise before
    the second reading), the time until the card has finished them, and
    the kernel launches and device time of one such step (torch.profiler)."""
    from lexls_tpu_torch import solve_core_fused
    from lexls_tpu_torch.sequence import _device_initial_activation

    Bn, _, m, n = A_seq.shape
    v0 = torch.zeros(Bn, m, dtype=A_seq.dtype, device=A_seq.device)

    def warm_step(t):
        A, lb, ub = (a[:, t].contiguous() for a in (A_seq, lb_seq, ub_seq))
        c, s, ns = _device_initial_activation(A, lb, ub, ct[:, t - 1], struct)
        return solve_core_fused(A, lb, ub, c, s, ns, x[:, t - 1].contiguous(), v0, reg,
                                struct=struct, params=params, x_guess_specified=True,
                                v0_specified=False)

    def all_steps():
        return [warm_step(t) for t in range(1, steps + 1)]

    all_steps()
    host, wall = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_steps()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3 / steps)
        wall.append((t2 - t0) * 1e3 / steps)
    rows, _ = _profile(lambda: warm_step(1))
    dev_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    h, w = statistics.median(host), statistics.median(wall)
    print(f"[fused path, one warm step] host time to issue it {h:.4f} ms (median of 5 runs of "
          f"{steps} steps, no synchronise; all {[round(v, 4) for v in host]}); until the card "
          f"has finished it {w:.4f} ms; {launches} kernel launches and {dev_ms:.4f} ms of device "
          f"time in one step (torch.profiler): the "
          f"{'host' if h > dev_ms else 'card'} sets the pace")


def profile_trip(A_seq, lb_seq, ub_seq, reg, struct, params):
    """One tracker trip in isolation, the first trip of warm step 1 as
    ``solve_core_tracked`` runs it with the bench's knobs: its time (CUDA
    events) and its kernel launches (torch.profiler), beside the same two
    numbers for the phase 1 that precedes it."""
    from bench_torch import TRACKED
    from lexls_tpu_torch import bootstrap_carried, solve_core_fused
    from lexls_tpu_torch import tracker as trk
    from lexls_tpu_torch.sequence import _device_initial_activation

    Bn, _, m, n = A_seq.shape
    dev, dtype = A_seq.device, A_seq.dtype
    z = lambda *shape: torch.zeros(*shape, dtype=dtype, device=dev)  # noqa: E731
    A0, A1 = A_seq[:, 0].contiguous(), A_seq[:, 1].contiguous()
    lb, ub = lb_seq[:, 0].contiguous(), ub_seq[:, 0].contiguous()
    c, s_, ns = _device_initial_activation(
        A0, lb, ub, torch.zeros(Bn, m, dtype=torch.int32, device=dev), struct)
    st0, factors = solve_core_fused(A0, lb, ub, c, s_, ns, z(Bn, n), z(Bn, m), reg,
                                    struct=struct, params=params, x_guess_specified=False,
                                    v0_specified=False, return_factors=True)
    car = bootstrap_carried(factors)
    phase1 = lambda: _phase1(A1, lb, ub, struct, params, st0.x, st0.ctr_type)  # noqa: E731
    s1 = phase1()
    c0 = trk._Trip(s=s1, rinv=car.rinv, pos=car.pos, ranks=car.ranks,
                   fall=torch.zeros(Bn, dtype=torch.bool, device=dev),
                   chg_hot=z(Bn, m), chg_sign=z(Bn, 1), chg_c=z(Bn, m - struct.d0),
                   chg_w=z(Bn, n + 1))
    trip = lambda: trk._trip(  # noqa: E731
        c0, A1, struct=struct, params=params, ns_iters=TRACKED["ns_iters"],
        cert_tol=trk.default_cert_tol(dtype), ext_steps=0, nochg=True)
    out = trip()
    resolved = int((out.s.status == 0).sum())
    for name, fn in (("tracker trip", trip), ("phase 1", phase1)):
        ms = _cuda_ms(fn, 10)
        rows, wall_ms = _profile(fn)
        dev_ms = sum(r[0] for r in rows) / 1e3
        print(f"[profile {name}] warm step 1, B={Bn}: {ms:.4f} ms per call (CUDA events, "
              f"median of 10); {sum(r[1] for r in rows)} kernel launches, device time "
              f"{dev_ms:.4f} ms, profiled host wall {wall_ms:.3f} ms")
    print(f"[profile tracker trip] resolved {resolved}/{Bn} instances in that trip")


def _level_norms(v, dims):
    edges = np.cumsum([0] + list(dims))
    return torch.stack([v[..., a:b].norm(dim=-1) for a, b in zip(edges, edges[1:])], -1)


def run_main_paths(dev, report):
    """The fused path and the tracked path at the bench shape, each with
    its launch counts, then both timed in interleaved rounds."""
    from bench_torch import TRACKED
    from lexls_tpu_torch import Structure, solve_sequence_batched_fused

    prob, params, base, drifts, lb, ub = _bench_problem(torch.float32, dev)
    struct = Structure.of(prob)
    m = prob.n_ctr
    A_seq = base[:, None] + drifts[None]  # (B, T, m, n)
    lb_seq = lb.expand(B, T_MAX, m).contiguous()
    ub_seq = ub.expand(B, T_MAX, m).contiguous()
    reg = torch.as_tensor(prob.regularization, device=dev)

    def run(T, **kw):
        return solve_sequence_batched_fused(A_seq[:, :T], lb_seq[:, :T], ub_seq[:, :T], reg,
                                            struct=struct, params=params, **kw)

    def run_tracked(T, stats=None):
        return run(T, tracked=True, stats=stats, **TRACKED)

    def drive(label, fn):
        """One run of a path with the launch counts zeroed just before and
        read just after; checks shape, finiteness and statuses."""
        with _counting() as launches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(T_MAX)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        x, v, status, it = out[:4]
        print(f"[{label}] B={B} T={T_MAX} float32: {wall:.3f} s host wall (first run); "
              f"launches {launches}; status counts "
              f"{torch.bincount(status.flatten() + 1).tolist()} (-1,0,1,2); warm iterations "
              f"mean {float(it[:, 1:].float().mean()):.4f} max {int(it[:, 1:].max())}; cold "
              f"iterations mean {float(it[:, 0].float().mean()):.4f}")
        for k, c in launches.items():
            if c == 0:
                raise SystemExit(f"{label} did not launch {k}")
        if (launches["activation"], launches["phase1_warm"]) != (T_MAX, T_MAX - 1):
            raise SystemExit(f"{label}: phase 1 is one activation a step and one hot start a "
                             f"warm step, {T_MAX} and {T_MAX - 1}")
        if x.shape != (B, T_MAX, N_VAR) or not bool(torch.isfinite(x).all()) \
                or not bool(torch.isfinite(v).all()):
            raise SystemExit(f"{label}: x/v not finite or of the wrong shape")
        if not bool((status == 0).all()):
            raise SystemExit(f"{label}: not every solve is PROBLEM_SOLVED")
        return out, launches

    (x, v, status, it, n_fact, ct), fused_launches = drive("fused path", run)

    # reference: the same sequence with the warm steps through the plain B2
    px, pstatus, pct = _plain_sequence(A_seq, lb_seq, ub_seq, struct, params)
    same = (pct == ct).all(2)
    xerr = float((px - x).abs().amax(2)[same].max())
    print(f"[fused path] against plain warm steps: working sets differing "
          f"{int((~same).sum())}/{B * T_MAX}; max |x err| where equal {xerr:.3e}; "
          f"plain statuses solved {int((pstatus == 0).sum())}/{B * T_MAX}")
    if xerr > 1e-3 or not bool((pstatus == 0).all()):
        raise SystemExit("fused path disagrees with its plain reference")

    # the tracked path, against the fused path's per-level residual norms
    stats = []
    (tx, tv, tstatus, tit, _, tct), tracked_launches = drive(
        "tracked path", lambda T: run_tracked(T, stats))
    nf, nt = _level_norms(v, prob.dims), _level_norms(tv, prob.dims)
    rel = ((nt - nf).abs() / (1.0 + nf)).amax()
    print(f"[tracked path] per-level |v| against the fused path: max |diff| / (1 + |v|) "
          f"{float(rel):.3e}; final working sets differing {int((tct != ct).any(2).sum())}/"
          f"{B * T_MAX}")
    if float(rel) > 1e-3:
        raise SystemExit("tracked path: per-level residual norms differ from the fused path's")
    fell = [f for _, f in stats]
    print(f"[tracked path] cold step: {stats[0][0]} tracker trips, {fell[0]}/{B} instances "
          f"finished in B2; warm steps: handed to B2 per step {fell[1:]} of {B} (resolved in "
          f"the tracker: {[B - f for f in fell[1:]]}); share resolved without B2 "
          f"{1 - sum(fell[1:]) / (B * (T_MAX - 1)):.4f}")
    for k in report:
        report[k]["launches"] = tracked_launches[k]
        report[k]["launches_by_path"] = {"fused": fused_launches[k],
                                         "tracked": tracked_launches[k]}
    stats0 = []
    t0 = time.perf_counter()
    out0 = run(T_MAX, tracked=True, stats=stats0, **dict(TRACKED, loop_cap=0))
    torch.cuda.synchronize()
    print(f"[tracked path, loop_cap=0] {time.perf_counter() - t0:.3f} s host wall; solved "
          f"{int((out0[2] == 0).sum())}/{B * T_MAX}; trips per warm step "
          f"{[t for t, _ in stats0[1:]]}; handed to B2 per warm step {[f for _, f in stats0[1:]]}")
    if not bool((out0[2] == 0).all()):
        raise SystemExit("tracked path, loop_cap=0: not every solve is PROBLEM_SOLVED")

    # both paths in every round, so that a drift of the clock falls on both
    lo, hi = TS
    paths = {"fused": run, "tracked": run_tracked}
    keys = [(name, T) for name in paths for T in (1, lo, hi)]
    times = _sequence_times(lambda key: paths[key[0]](key[1]), keys, REPS)
    rates = {}
    for name in paths:
        tn = {T: times[(name, T)] for T in (1, lo, hi)}
        steps, rates[name] = _warm_rate(tn, lo, hi)
        for T in (1, lo, hi):
            print(f"[{name}] T={T} ms: {_spread(tn[T])}")
        print(f"[{name}] ms per warm step: {_spread(steps)}")
        print(f"[{name}] warm solves/s over {REPS} rounds: {_spread(rates[name])}")
    ratio = [a / b for a, b in zip(rates["tracked"], rates["fused"])]
    print(f"[tracked / fused] warm solves/s ratio per round: {_spread(ratio)}")
    times_0 = _sequence_times(lambda T: run(T, tracked=True, **dict(TRACKED, loop_cap=0)), TS, 3)
    print(f"[tracked, loop_cap=0] warm solves/s over 3 rounds: "
          f"{_spread(_warm_rate(times_0, lo, hi)[1])}")
    times_p = _sequence_times(
        lambda T: _plain_sequence(A_seq[:, :T], lb_seq[:, :T], ub_seq[:, :T], struct, params),
        TS, 1)
    _, rates_p = _warm_rate(times_p, lo, hi)
    print(f"[fused path] plain B2 in warm steps, T={lo} ms: {times_p[lo][0]:.4f}; "
          f"T={hi} ms: {times_p[hi][0]:.4f}; warm solves/s (1 round): {rates_p[0]:.4f}")
    profile_sequence("fused path", run)
    measure_warm_step_host(A_seq, lb_seq, ub_seq, reg, struct, params, x, ct)
    profile_sequence("tracked path", run_tracked)
    profile_trip(A_seq, lb_seq, ub_seq, reg, struct, params)


def run_new_paths(dev, report):
    """Two further paths at the bench shape, float32, B=384, T=3, each
    driven through its entry point with the launch counts zeroed just
    before and read just after: the fused path with the working-set log
    and cycling handling on (against the same with them off), and the
    exact tier's sequence, which launches B1 in every iteration."""
    import dataclasses

    from lexls_tpu_torch import (Structure, solve_core_batched, solve_sequence_batched_fused,
                                 solve_sequence_batched_native)
    from lexls_tpu_torch.sequence import _device_initial_activation

    T = 3
    prob, params, base, drifts, lb, ub = _bench_problem(torch.float32, dev)
    struct = Structure.of(prob)
    m = prob.n_ctr
    A_seq = (base[:, None] + drifts[None])[:, :T].contiguous()
    lb_seq, ub_seq = lb.expand(B, T, m).contiguous(), ub.expand(B, T, m).contiguous()
    reg = torch.as_tensor(prob.regularization, device=dev)
    both = dataclasses.replace(params, log_working_set_enabled=True,
                               cycling_handling_enabled=True)

    def drive(label, fn, key):
        with _counting() as launches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(T)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        x, v, status, it = out[:4]
        print(f"[{label}] B={B} T={T} float32: {wall:.3f} s host wall (first run); launches "
              f"{launches}; status counts {torch.bincount(status.flatten() + 1).tolist()} "
              f"(-1,0,1,2); iterations per step, mean "
              f"{[round(float(c), 2) for c in it.double().mean(0)]}, max {it.amax(0).tolist()}")
        if x.shape != (B, T, N_VAR) or not bool(torch.isfinite(x).all()) \
                or not bool(torch.isfinite(v).all()) or not bool((status == 0).all()):
            raise SystemExit(f"{label}: not every solve is PROBLEM_SOLVED, finite and in shape")
        if (launches["activation"], launches["phase1_warm"]) != (T, T - 1):
            raise SystemExit(f"{label}: phase 1 is one activation a step and one hot start a "
                             f"warm step, {T} and {T - 1}: {launches}")
        for k in report:
            report[k]["launches_by_path"][key] = launches[k]
        return out, launches

    fused = lambda T_, p=params: solve_sequence_batched_fused(  # noqa: E731
        A_seq[:, :T_], lb_seq[:, :T_], ub_seq[:, :T_], reg, struct=struct, params=p)
    native = lambda T_: solve_sequence_batched_native(  # noqa: E731
        A_seq[:, :T_], lb_seq[:, :T_], ub_seq[:, :T_], reg, struct=struct, params=params)

    off = fused(T)
    on, launches = drive("fused path, log and cycling on", lambda T_: fused(T_, both),
                         "fused_log_cycling")
    same = all(torch.equal(a, b) for a, b in zip(on, off))
    print(f"[fused path, log and cycling on] results identical to the path with them off: {same}")
    if launches["fused_active_set"] != T or not same:
        # no cycle is detected on this workload, so the options only record
        raise SystemExit("fused path with log and cycling on: wrong launches or results")

    (x, v, status, it, _, ct), launches = drive("exact tier", native, "native")
    p = len(struct.lexlse_dims)
    passes = int(it.amax(0).sum())
    nf, nn = _level_norms(off[1], prob.dims), _level_norms(v, prob.dims)
    rel = float(((nn - nf).abs() / (1.0 + nf)).amax())
    print(f"[exact tier] passes of the loop {passes}; B1 launches {launches['panel_factorize']} "
          f"(expect {p} x ({passes} + 1) = {p * (passes + 1)}); per-level |v| against the fused "
          f"path: max |diff| / (1 + |v|) {rel:.3e}; final working sets differing "
          f"{int((ct != off[5]).any(2).sum())}/{B * T}")
    if launches["panel_factorize"] != p * (passes + 1) or launches["fused_active_set"] != 0 \
            or rel > 1e-3:
        raise SystemExit("exact tier: B1's launches are off or it disagrees with the fused path")
    # the cold step varies between runs by more than a warm step takes, so
    # a slope over T resolves nothing here: each warm step is timed alone,
    # as the sequence runs it, from the step before it
    cold = _sequence_times(native, (1,), 3)[1]
    z = torch.zeros(B, m, dtype=A_seq.dtype, device=dev)

    def warm_step(t):
        A = A_seq[:, t].contiguous()
        c, s, ns = _device_initial_activation(A, lb_seq[:, t], ub_seq[:, t], ct[:, t - 1], struct)
        return solve_core_batched(A, lb_seq[:, t], ub_seq[:, t], c, s, ns, x[:, t - 1], z, reg,
                                  struct=struct, params=params, x_guess_specified=True,
                                  v0_specified=False)

    warm = [_cuda_ms(lambda t=t: warm_step(t), 5) for t in range(1, T)]
    per_pass = [w / int(it[:, t].max()) for t, w in zip(range(1, T), warm)]
    print(f"[exact tier] cold step {statistics.median(cold):.3f} ms (T=1, median of 3; all "
          f"{[round(c, 1) for c in cold]}); warm steps alone {[round(w, 3) for w in warm]} ms "
          f"(median of 5 each; {[round(q, 3) for q in per_pass]} ms a pass); warm solves/s "
          f"{B / (statistics.mean(warm) / 1e3):.1f}")
    rows, wall_ms = _profile(lambda: native(T))
    total = sum(r[0] for r in rows) / 1e3
    if total == 0:
        print("[profile exact tier] the profiler shows no device time: shares not measured")
        return
    b1 = [(r[0], r[1]) for r in rows if "panel_factorize_kernel" in r[2]]  # csrc/panel_lqr.cu
    b1_ms, b1_n = sum(u for u, _ in b1) / 1e3, sum(c for _, c in b1)
    print(f"[profile exact tier] T={T} sequence, profiled host wall {wall_ms:.3f} ms; device "
          f"time {total:.3f} ms ({100 * total / wall_ms:.1f}% of the profiled wall) in "
          f"{sum(r[1] for r in rows)} kernel launches; B1 {b1_ms:.3f} ms in {b1_n} launches "
          f"({100 * b1_ms / total:.1f}% of device time, {b1_ms / max(b1_n, 1):.4f} ms a launch)")
    for us, count, key in rows[:6]:
        print(f"  {us / 1e3:10.3f} ms  {count:6d} calls  {key[:90]}")
    report["panel_factorize"]["path2_ms_per_launch"] = b1_ms / max(b1_n, 1)


# bench_extra.py config 3 (bench_extra.py:188-218; its shape is
# bench_extra_torch's REG_N, REG_DIMS): deep rank-deficient Tikhonov
REG_B, REG_B_PLAIN, REG_B64, REG_T = 1024, 64, 128, 3


def _config3_problem(Bn, dtype, dev, rt=None):
    """Config 3 of ``bench_extra.py:188-218``, as the bench draws it
    (``bench_extra_torch.config3_problem``): one random hierarchy of six
    rank-deficient levels over 24 variables, factors 0.05, the f32
    tolerances, and Bn copies of A perturbed by 1e-3; ``rt`` replaces the
    regularization type.  Returns (prob, params, A (Bn, m, n), lb, ub, reg)
    with the bounds broadcast."""
    import dataclasses

    from bench_extra_torch import config3_problem

    prob, params, inp = config3_problem(Bn, dtype, dev)
    if rt is not None:
        params = dataclasses.replace(params, regularization_type=rt)
    return prob, params, inp["A"], inp["lb"], inp["ub"], inp["reg"]


def check_regularized_panel(dev):
    """B1 under every regularization type against its plain version:
    ``factorize_fast_batched`` on the card and on the CPU (B1's plain
    version), float64, config 3's shape, B=64, each instance's working set
    a random draw of the rows' types; the nine damped types and TIKHONOV
    with a variable factor of 5.0.  perm and ranks identical; lod, the
    null space and TIKHONOV_1's X_mu and residual_mu to 1e-10 relative.
    The CG types' ten fixed trips do not converge at this shape: their
    output moves with the rounding of their input (a change of A by 1e-15
    relative moves the JAX package's own CG x by up to 7e-2), so they are
    held to 1e-6 or to ten times the plain version's own change under such
    a perturbation of A, whichever is larger."""
    import dataclasses

    from lexls_tpu_torch import Structure
    from lexls_tpu_torch.lexlsi import _masked_general
    from lexls_tpu_torch.ops import factorize_fast_batched
    from lexls_tpu_torch.types import RegularizationType as RT

    prob, params, A, lb, ub, reg = _config3_problem(REG_B_PLAIN, torch.float64, dev)
    struct = Structure.of(prob)
    ct = torch.as_tensor(np.random.default_rng(3).integers(0, 4, A.shape[:2]), device=dev)
    Ag, bg, fm, fv = _masked_general(A, lb, ub, ct.to(torch.int32), struct)
    cases = [(rt, 0.0) for rt in RT if rt != RT.NONE] + [(RT.TIKHONOV, 5.0)]
    for rt, vf in cases:
        lp = dataclasses.replace(params, regularization_type=rt,
                                 variable_regularization_factor=vf).lexlse_parameters()
        got = factorize_fast_batched(Ag, bg, struct.lexlse_dims, lp, fm, fv, reg)
        want = factorize_fast_batched(Ag.cpu(), bg.cpu(), struct.lexlse_dims, lp, fm.cpu(),
                                      fv.cpu(), reg.cpu())
        same = torch.equal(got.perm.cpu(), want.perm) and torch.equal(got.ranks.cpu(), want.ranks)

        def rel_err(got, want):
            return max(float((getattr(got, f).cpu() - getattr(want, f)).abs().max()
                             / (1.0 + getattr(want, f).abs().max()))
                       for f in ("lod", "null_space", "X_mu", "residual_mu")
                       if getattr(want, f).numel())

        err, tol, note = rel_err(got, want), 1e-10, ""
        if rt in (RT.TIKHONOV_CG, RT.RT_NO_Z_CG):
            nudged = factorize_fast_batched(Ag.cpu() * (1.0 + 1e-15), bg.cpu(),
                                            struct.lexlse_dims, lp, fm.cpu(), fv.cpu(), reg.cpu())
            spread = rel_err(nudged, want)
            tol = max(1e-6, 10.0 * spread)
            note = f"; the plain version's own change under A * (1 + 1e-15): {spread:.3e}"
        label = rt.name + (f" variable {vf}" if vf else "")
        print(f"[B1 regularized f64] {label}: perm and ranks identical {same}; max relative |err| "
              f"of lod, null space, X_mu, residual_mu {err:.3e} (limit {tol:.3g}){note}")
        if not same or err > tol:
            raise SystemExit(f"B1 under {label} disagrees with its plain version")


def _fixed_point_check(label, st, A, lb, ub, reg, struct, params):
    """One exact iteration on the card from every solved endpoint, status
    reset: it must declare the instance solved with the working set
    unchanged and v within 1e-3.  An instance whose damped normal
    equations broke down in float32 (Cholesky of a matrix that rounding
    left indefinite: NaN, as the JAX package's ``_tikhonov_full`` gives
    on the same inputs) ends with a non-finite x; such instances are
    counted, may be at most 1% of the batch, and are left out of the
    check."""
    import dataclasses

    from lexls_tpu_torch.lexlsi import _factorize_masked, _masked_general, _verify_with_f

    s = dataclasses.replace(st, status=torch.full_like(st.status, -1))
    Ag, bg, fm, fv = _masked_general(A, lb, ub, s.ctr_type, struct)
    f = _factorize_masked(Ag, bg, fm, fv, struct, params, reg)
    s1 = _verify_with_f(s, A, Ag, f, torch.ones_like(st.status, dtype=torch.bool), struct, params)
    finite = torch.isfinite(st.x).all(1) & torch.isfinite(st.v).all(1)
    solved = (st.status == 0) & finite
    ok = bool((s1.status[solved] == 0).all()) and bool(
        (s1.ctr_type[solved] == st.ctr_type[solved]).all())
    dv = float((s1.v - st.v)[solved].abs().amax()) if bool(solved.any()) else 0.0
    n_bad = int((~finite).sum())
    print(f"[{label}] fixed-point check of the {int(solved.sum())} solved endpoints: solved again "
          f"with the working set unchanged {ok}; max |v change| {dv:.3e} (limit 1e-3); "
          f"non-finite x (damped normal equations broken down): {n_bad} (statuses "
          f"{st.status[~finite].tolist()})")
    if not ok or dv > 1e-3 or n_bad > st.x.shape[0] // 100:
        raise SystemExit(f"{label}: a solved endpoint is not a fixed point, or too many "
                         "instances broke down")


def run_regularized(dev, report):
    """Config 3 on the card (``bench_extra.py:188-253``, full width): B1
    under every regularization type against its plain version; cold solves
    in float32 at B=1024 through the exact tier with TIKHONOV and the
    tracker with TIKHONOV and TIKHONOV_CG, each driven with the launch
    counts zeroed just before and read just after, its solved endpoints
    checked as fixed points and timed (median of 3 calls by CUDA events
    after the driven one); float64 at B=128 on the card against the CPU; a
    warm sequence through ``solve_sequence_batched_native`` (T=3), each
    warm step timed alone.  Last, each path under ``torch.profiler`` with a
    budget of 4 factorizations (a whole solve is some 10^5 launches, whose
    trace takes the profiler minutes to digest; the passes are alike, since
    most instances run to the budget), for the host and device time of a
    pass, and the exact tier timed once more after the profiles."""
    import dataclasses

    from bench_extra_torch import REG_DIMS, REG_N
    from lexls_tpu_torch import (Structure, batched_initial_arrays, solve_core_batched,
                                 solve_core_cold_tracked, solve_sequence_batched_native)
    from lexls_tpu_torch.sequence import _device_initial_activation
    from lexls_tpu_torch.types import RegularizationType as RT

    t_phase = time.perf_counter()
    check_regularized_panel(dev)
    p = len(REG_DIMS)
    paths = {}
    for key, rt, tracked in (("regularized_exact", RT.TIKHONOV, False),
                             ("regularized_tracked", RT.TIKHONOV, True),
                             ("regularized_tracked_cg", RT.TIKHONOV_CG, True)):
        prob, params, A, lb, ub, reg = _config3_problem(REG_B, torch.float32, dev, rt)
        struct = Structure.of(prob)
        init = [a.to(torch.float32) if a.is_floating_point() else a
                for a in batched_initial_arrays(prob, REG_B, dev)]

        def solve(stats=None, params=params, A=A, lb=lb, ub=ub, reg=reg, struct=struct,
                  init=init, tracked=tracked):
            if tracked:
                return solve_core_cold_tracked(A, lb, ub, *init, struct=struct, params=params,
                                               reg=reg, stats=stats)[0]
            return solve_core_batched(A, lb, ub, *init, reg, struct=struct, params=params,
                                      x_guess_specified=False, v0_specified=False)

        stats = []
        with _counting() as launches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = solve(stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        for k in report:
            report[k].setdefault("launches_by_path", {})[key] = launches[k]
        if launches["panel_factorize"] == 0 or launches["fused_active_set"] != 0 \
                or st.x.shape != (REG_B, REG_N):
            raise SystemExit(f"{key}: wrong launches {launches}, or x of the wrong shape")
        # B1 takes p launches for phase 1 and p for each pass of the exact
        # tier, the tracker's bootstrap iteration included
        passes = launches["panel_factorize"] // p - 1
        trips, handed = stats[0] if stats else (0, 0)
        counts = torch.bincount(st.status + 1, minlength=4).tolist()
        print(f"[{key}] config 3, B={REG_B} float32: {wall:.3f} s host wall (first run); "
              f"status counts {counts} (-1,0,1,2); iterations mean "
              f"{float(st.it.double().mean()):.2f} max {int(st.it.max())}; launches {launches}; "
              f"exact-tier passes {passes}" + (f"; tracker trips {trips}, instances handed to "
                                               f"_exact_tail {handed}/{REG_B}" if tracked else ""))
        _fixed_point_check(key, st, A, lb, ub, reg, struct, params)
        ms = _cuda_ms(solve, 3, warmup=False)
        print(f"[{key}] cold solves/s {REG_B / (ms / 1e3):.1f} ({ms:.3f} ms a solve, median of 3 "
              f"by CUDA events; {ms / (passes + trips):.3f} ms a pass or trip)")
        paths[key] = (solve, params, st, ms)
    same = paths["regularized_exact"][2].status == paths["regularized_tracked"][2].status
    print(f"[regularized] statuses of the tracked path (TIKHONOV) agreeing with the exact tier's: "
          f"{int(same.sum())}/{REG_B}")

    # float64: the exact tier on the card against the same on the CPU
    prob, params, A, lb, ub, reg = _config3_problem(REG_B64, torch.float64, dev)
    struct = Structure.of(prob)
    init = batched_initial_arrays(prob, REG_B64, dev)
    kw = dict(struct=struct, params=params, x_guess_specified=False, v0_specified=False)
    card = solve_core_batched(A, lb, ub, *init, reg, **kw)
    cpu = solve_core_batched(*(t.cpu() for t in (A, lb, ub, *init, reg)), **kw)
    same = all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
               for f in ("status", "it", "ctr_type", "n_act", "n_deact"))
    xerr = float((card.x.cpu() - cpu.x).abs().max())
    trk, _ = solve_core_cold_tracked(A, lb, ub, *init, struct=struct, params=params, reg=reg)
    print(f"[regularized f64] B={REG_B64}: exact tier on the card against the CPU: statuses, "
          f"iterations and working sets identical {same}; max |x err| {xerr:.3e} (target 1e-10); "
          f"status counts {torch.bincount(cpu.status + 1, minlength=4).tolist()}; tracked path "
          f"statuses agreeing with the exact tier's {int((trk.status == card.status).sum())}/"
          f"{REG_B64}")
    if not same or xerr > 1e-8:
        raise SystemExit("regularized exact tier: the card and the CPU disagree")

    # the warm sequence, TIKHONOV, float32: each warm step timed alone
    prob, params, A, lb, ub, reg = _config3_problem(REG_B, torch.float32, dev)
    struct = Structure.of(prob)
    m = prob.n_ctr
    drifts = torch.as_tensor(1e-3 * np.cumsum(np.random.default_rng(1).standard_normal(
        (REG_T,) + prob.A.shape), axis=0), device=dev).to(torch.float32)
    A_seq = (A[:, None] + drifts[None]).contiguous()
    lb_seq, ub_seq = lb[:, None].expand(-1, REG_T, -1), ub[:, None].expand(-1, REG_T, -1)
    with _counting() as launches:
        x, _, status, it, _, ct = solve_sequence_batched_native(A_seq, lb_seq, ub_seq, reg,
                                                                struct=struct, params=params)
    b1 = launches["panel_factorize"]
    for k in report:
        report[k]["launches_by_path"]["regularized_native"] = launches[k]
    finite = torch.isfinite(x).all(2)
    if int((~finite).sum()) > finite.numel() // 100 or b1 == 0:
        raise SystemExit("regularized sequence: x not finite in over 1% of the solves, or B1 "
                         "not launched")
    z = torch.zeros(REG_B, m, dtype=torch.float32, device=dev)

    def warm_step(t):
        A_t = A_seq[:, t].contiguous()
        c, s_, ns = _device_initial_activation(A_t, lb, ub, ct[:, t - 1], struct)
        return solve_core_batched(A_t, lb, ub, c, s_, ns, x[:, t - 1].contiguous(), z, reg,
                                  struct=struct, params=params, x_guess_specified=True,
                                  v0_specified=False)

    warm = [_cuda_ms(lambda t=t: warm_step(t), 3, warmup=False) for t in range(1, REG_T)]
    print(f"[regularized sequence] T={REG_T}, B={REG_B} float32: status counts per step "
          f"{[torch.bincount(status[:, t] + 1, minlength=4).tolist() for t in range(REG_T)]}; "
          f"iterations per step, mean {[round(float(c), 2) for c in it.double().mean(0)]}, max "
          f"{it.amax(0).tolist()}; non-finite x per step {(~finite).sum(0).tolist()}; B1 "
          f"launches {b1}; warm steps alone "
          f"{[round(w, 3) for w in warm]} ms (median of 3 each): warm solves/s "
          f"{REG_B / (statistics.mean(warm) / 1e3):.1f}")

    # the profiles, last: a pass's host and device time and launches; the
    # exact tier without regularization beside them gives the regularizer's
    # share of a pass (the difference, over the p levels)
    paths["exact_unregularized"] = (paths["regularized_exact"][0], dataclasses.replace(
        paths["regularized_exact"][1], regularization_type=RT.NONE), None, None)
    per_pass = {}
    for key, (solve, params, _, _) in paths.items():
        short = dataclasses.replace(params, max_number_of_factorizations=4)
        stats = []
        with _counting() as launches:
            rows, wall_ms = _profile(lambda: solve(stats, params=short))
        b1 = launches["panel_factorize"]
        steps = b1 // p - 1 + (stats[0][0] if stats else 0)
        dev_ms = sum(r[0] for r in rows) / 1e3
        per_pass[key] = (wall_ms / steps, dev_ms / steps, sum(r[1] for r in rows) / steps)
        print(f"[profile {key}] budget 4, {steps} passes or trips: a pass or trip takes host "
              f"{wall_ms / steps:.3f} ms, device {dev_ms / steps:.3f} ms in "
              f"{sum(r[1] for r in rows) / steps:.1f} kernel launches "
              f"({b1 / steps:.2f} of B1 by its count); device busy "
              f"{100 * dev_ms / wall_ms:.1f}% of the profiled wall")
        for us, count, name in rows[:3]:
            print(f"  {us / 1e3:10.3f} ms  {count:6d} calls  {name[:90]}")
    reg_level = [(a - b) / p for a, b in zip(per_pass["regularized_exact"],
                                             per_pass["exact_unregularized"])]
    print(f"[profile regularizer] TIKHONOV's damping and null space, per level and pass: host "
          f"{reg_level[0]:.3f} ms, device {reg_level[1]:.4f} ms, {reg_level[2]:.1f} launches")
    solve, _, _, ms = paths["regularized_exact"]
    print(f"[regularized_exact] one more solve after the profiles: "
          f"{_cuda_ms(solve, 1, warmup=False):.3f} ms (before them: {ms:.3f} ms)")
    print(f"[regularized] phase wall {time.perf_counter() - t_phase:.1f} s")


def _golden_cases():
    """The 52 fixtures of the golden phase, read with the port's own
    ``.dat`` parser: ``ineq_00..19`` cold, ``warm_00..07``,
    ``warm_sb_00..05``, ``warm_tik_00..05`` and ``seq_00..03`` at t1-t3
    warm-started with the guess and x they carry (``warm_tik`` with its
    TIKHONOV factors).  Each case: (name, problem, solve keywords, gold,
    regularized)."""
    from lexls_tpu_torch.io import dat as io_dat

    with open(os.path.join(GOLDEN, "index.json")) as f:
        index = json.load(f)
    names = ([f"ineq_{i:02d}" for i in range(20)] + [f"warm_{i:02d}" for i in range(8)]
             + [f"warm_sb_{i:02d}" for i in range(6)] + [f"warm_tik_{i:02d}" for i in range(6)]
             + [f"seq_{i:02d}_t{t}" for i in range(4) for t in (1, 2, 3)])
    cases = []
    for name in names:
        d = io_dat.load_dat_python(os.path.join(GOLDEN, index[name]["dat"]))
        prob = io_dat.to_inequality(d)
        regularized = bool(index[name].get("reg_type"))
        if regularized:
            prob.regularization = np.asarray(index[name]["reg_factors"], float)
        kw = {}
        if index[name].get("warm"):
            kw = dict(x0=d.solution_guess, active_guess=d.active_guess_stacked())
        with open(os.path.join(GOLDEN, name + ".json")) as f:
            gold = json.load(f)
        cases.append((name, prob, kw, gold, regularized))
    return cases


def _violation_norms(prob, x):
    """Per-level norms of the constraint violation (``objective.h:611-630``)
    of ``x`` (NumPy, float64)."""
    Ax = prob.A @ np.asarray(x, np.float64)
    w = np.where(Ax <= prob.lb, Ax - prob.lb, np.where(Ax >= prob.ub, Ax - prob.ub, 0.0))
    return np.array([np.linalg.norm(w[prob.level_slice(k)]) for k in range(prob.n_obj)])


def _gold_norms(prob, gold):
    """Per-level norms of the violation that the reference recorded."""
    w = np.concatenate([np.asarray(v, np.float64) for v in gold["violation"]])
    return np.array([np.linalg.norm(w[prob.level_slice(k)]) for k in range(prob.n_obj)])


def _golden_batch(prob, kw, dtype, dev):
    """The batch of one that a tier takes for one fixture: (A, lb, ub,
    ctr_type, stamp, next_stamp, x0, v0) on ``dev``, and whether x0 is a
    guess."""
    from lexls_tpu_torch import initial_activation

    c0, s0, n0 = initial_activation(prob, kw.get("active_guess"))
    x0 = kw.get("x0")
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dtype)[None]

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev).reshape(1, -1)

    return ((t(prob.A), t(prob.lb), t(prob.ub), i(c0), i(s0), i(n0)[:, 0],
             t(np.zeros(prob.n_var) if x0 is None else x0), t(np.zeros(prob.n_ctr))),
            x0 is not None)


def _route_line(label, ok, total, seconds, launches, misses):
    print(f"[golden {label}] passed {ok}/{total} in {seconds:.3f} s; launches {launches}"
          + (f"; misses: {misses}" if misses else ""))


def run_golden(dev, report):
    """The golden phase (:func:`_golden`) with tracing on, so that its
    launch counters count."""
    from lexls_tpu_torch import tracing

    with tracing.recording():
        _golden(dev, report)


def _golden(dev, report):
    """The C++ golden corpus on the card (``tests/golden``, the only oracle
    from the real lexls), each route driven with the launch counts zeroed
    just before it and read just after.  (a) ``lexls_tpu_torch.solve`` on
    the 52 fixtures in float64 (the exact tier, kernel B1 once per level a
    pass): status, per-level violation norms to 1e-8 of the gold's (and a
    relative 1e-7, as ``tests/test_golden_parity.py`` holds them),
    factorizations on the warm and sequence fixtures, x to 1e-7 on
    ``warm_tik``, B1 at least levels x passes; the same solves on the CPU
    in this process, statuses, iterations and working sets identical.  (b)
    ``solve_core_fused`` (kernel B2) with B=1 on the 46 unregularized
    fixtures in float32 at ``tools/golden_fused_tpu.py``'s tolerances:
    solved where the gold is, x finite, norms within 1e-3 x max(1, it/16);
    and B2 against its plain version on the CPU from the same phase-1
    state, float64: statuses, iterations and working sets identical, x to
    1e-8.  (``warm_tik`` stays out of float32: mu = factor^2 is below its
    epsilon.)  (c) ``solve_core_cold_tracked`` on the same 46, float32,
    the checks of (b).  (d) the trace and ``use_phase1_v0`` through
    ``solve_core_batched`` at the bench shape (B=64, float64, a budget of 40
    factorizations): card and CPU agree, trace arrays and x to 1e-10,
    operations and rows identical."""
    import dataclasses

    from lexls_tpu_torch import (ParametersLexLSI, RegularizationType, Structure,
                                 batched_initial_arrays, solve, solve_core_batched,
                                 solve_core_cold_tracked, solve_core_fused)
    from lexls_tpu_torch.lexlsi import _initial_state, active_set_kwargs
    from lexls_tpu_torch import tracing
    from lexls_tpu_torch.ops import fused_active_set, fused_active_set_ref

    t_phase = time.perf_counter()
    cases = _golden_cases()
    misses = []

    def params_of(regularized):
        return ParametersLexLSI(regularization_type=RegularizationType.TIKHONOV
                                if regularized else RegularizationType.NONE)

    def zero():
        tracing.reset()
        torch.cuda.synchronize()
        return time.perf_counter()

    def read(key, t0):
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        for k in report:
            report[k].setdefault("launches_by_path", {})[key] = launches[k]
        return seconds, launches

    # (a) the host API, the exact tier through B1, float64
    ok_a, results, b1_short, seconds_of = 0, {}, [], {}
    t0 = zero()
    for name, prob, kw, gold, regularized in cases:
        before, t_solve = _launch_counts()["panel_factorize"], time.perf_counter()
        res = solve(prob, params_of(regularized), device="cuda", **kw)  # NumPy out: synced
        seconds_of[name] = time.perf_counter() - t_solve
        p = len(Structure.of(prob).lexlse_dims)
        if _launch_counts()["panel_factorize"] - before < p * res.n_iterations:
            b1_short.append(name)
        results[name] = res
        norms, want = _violation_norms(prob, res.x), _gold_norms(prob, gold)
        err = float(np.abs(norms - want).max())
        # np.testing's rtol of 1e-7 beside the 1e-8, as tests/test_golden_parity.py
        good = int(res.status) == int(gold["status"]) and np.allclose(norms, want, rtol=1e-7,
                                                                      atol=1e-8)
        if regularized:
            good = good and np.allclose(res.x, np.asarray(gold["x"]), rtol=1e-7, atol=1e-7)
        elif not name.startswith("ineq_"):
            good = good and res.n_factorizations == int(gold["factorizations"])
        ok_a += good
        if not good:
            misses.append(f"exact {name}: status {int(res.status)} (gold {gold['status']}), "
                          f"|dnorm| {err:.2e}, factorizations {res.n_factorizations} (gold "
                          f"{gold.get('factorizations')})")
    seconds, launches = read("golden_exact", t0)
    _route_line("(a) solve, exact tier, f64", ok_a, len(cases), seconds, launches,
                [m for m in misses if m.startswith("exact")])
    passes = {n: r.n_iterations for n, r in results.items()}
    top = max(passes, key=passes.get)
    print(f"[golden (a)] passes per solve: max {passes[top]} ({top}: {seconds_of[top]:.4f} s, "
          f"{1e3 * seconds_of[top] / passes[top]:.3f} ms a pass), total "
          f"{sum(passes.values())}; B1 launches "
          f"{launches['panel_factorize']} (at least levels x passes on every fixture: "
          f"{'yes' if not b1_short else b1_short})")
    if b1_short or launches["panel_factorize"] == 0 or launches["fused_active_set"] != 0:
        misses.append(f"exact: B1 launched fewer than levels x passes on {b1_short}, or B2 ran")
    warm_fixtures = sum(kw.get("x0") is not None for _, _, kw, _, _ in cases)
    if (launches["activation"], launches["phase1_warm"]) != (0, warm_fixtures):
        misses.append(f"exact: the hot start is one launch a fixture with x0 ({warm_fixtures}) "
                      f"and the activation none: {launches}")
    t_cpu = time.perf_counter()
    differ = []
    for name, prob, kw, gold, regularized in cases:
        cpu, card = solve(prob, params_of(regularized), device="cpu", **kw), results[name]
        if (cpu.status, cpu.n_iterations) != (card.status, card.n_iterations) \
                or not np.array_equal(cpu.ctr_type, card.ctr_type):
            differ.append(name)
    print(f"[golden (a)] the same solves on the CPU ({time.perf_counter() - t_cpu:.3f} s): "
          f"statuses, iterations and working sets differing on {differ or 'none'}")
    if differ:
        misses.append(f"exact: card and CPU differ on {differ}")

    # (b) B2 and (c) the tracker, float32, on the unregularized fixtures
    plain = [c for c in cases if not c[4]]
    params32 = ParametersLexLSI(**GOLDEN_F32)
    for key, tag, label, tracked in (
            ("golden_fused", "(b)", "solve_core_fused, B2, f32", False),
            ("golden_tracked", "(c)", "solve_core_cold_tracked, f32", True)):
        ok, worst = 0, 0.0
        t0 = zero()
        for name, prob, kw, gold, _ in plain:
            args, warm = _golden_batch(prob, kw, torch.float32, dev)
            struct = Structure.of(prob)
            if tracked:
                st, _ = solve_core_cold_tracked(*args, struct=struct, params=params32,
                                                x_guess_specified=warm, v0_specified=False)
            else:
                st = solve_core_fused(*args, None, struct=struct, params=params32,
                                      x_guess_specified=warm, v0_specified=False)
            x = st.x[0].double().cpu().numpy()
            dnorm = float(np.abs(_violation_norms(prob, x) - _gold_norms(prob, gold)).max())
            atol = 1e-3 * max(1.0, int(st.it[0]) / 16.0)
            worst = max(worst, dnorm / atol)
            good = bool(np.isfinite(x).all()) and dnorm <= atol and (
                int(gold["status"]) != 0 or int(st.status[0]) == 0)
            ok += good
            if not good:
                misses.append(f"{key} {name}: status {int(st.status[0])}, |dnorm| {dnorm:.2e} "
                              f"(bound {atol:.1e}), x finite {bool(np.isfinite(x).all())}")
        seconds, launches = read(key, t0)
        _route_line(f"{tag} {label}", ok, len(plain), seconds, launches,
                    [m for m in misses if m.startswith(key)])
        print(f"[golden {tag}] largest |dnorm| / bound {worst:.3f}")
        if launches["fused_active_set"] == 0:
            misses.append(f"{key}: B2 was not launched")
        warm_fixtures = sum(kw.get("x0") is not None for _, _, kw, _, _ in plain)
        if (launches["activation"], launches["phase1_warm"]) != (0, warm_fixtures):
            misses.append(f"{key}: the hot start is one launch a fixture with x0 "
                          f"({warm_fixtures}) and the activation none: {launches}")

    # B2 against its plain version, float64, from the same phase-1 state
    params64 = ParametersLexLSI()
    differ, xerr = [], 0.0
    t0 = time.perf_counter()
    for name, prob, kw, gold, _ in plain:
        args, warm = _golden_batch(prob, kw, torch.float64, dev)
        struct = Structure.of(prob)
        s = _initial_state(*args, struct, params64, warm, False)
        got = fused_active_set(*_state_args(args[0], s), **active_set_kwargs(struct, params64, dev))
        cpu = [a.cpu() for a in _state_args(args[0], s)]
        want = fused_active_set_ref(*cpu, **active_set_kwargs(struct, params64, "cpu"))
        same = all(torch.equal(getattr(got, f).cpu(), getattr(want, f))
                   for f in ("status", "it", "ctr_type", "n_fact"))
        err = float((got.x.cpu() - want.x).abs().max())
        xerr = max(xerr, err)
        if not same or err > 1e-8:
            differ.append(name)
    torch.cuda.synchronize()
    print(f"[golden (b)] B2 against its plain version (CPU), f64, {len(plain)} fixtures in "
          f"{time.perf_counter() - t0:.3f} s: statuses, iterations, working sets or x (to "
          f"1e-8) differing on {differ or 'none'}; max |x err| {xerr:.3e}")
    if differ:
        misses.append(f"B2 and its plain version differ on {differ}")

    # (d) trace and use_phase1_v0 at the bench shape, card against CPU
    prob, params, base, drifts, lb, ub = _bench_problem(torch.float64, dev)
    struct, Bt, m = Structure.of(prob), GOLDEN_TRACE_B, prob.n_ctr
    t0 = time.perf_counter()
    A0, A1 = ((base[:Bt] + drifts[k]).contiguous() for k in (0, 1))
    lbs, ubs = lb.expand(Bt, m).contiguous(), ub.expand(Bt, m).contiguous()
    trace_fields = ("trace_x", "trace_v", "trace_dx", "trace_dv", "trace_alpha")
    cold_x = None
    for label, opts in (("trace", dict(trace_enabled=True)),
                        ("use_phase1_v0 + trace", dict(trace_enabled=True, use_phase1_v0=True))):
        prm = dataclasses.replace(params, max_number_of_factorizations=GOLDEN_TRACE_BUDGET,
                                  **opts)
        guess = "use_phase1_v0" in opts
        init = list(batched_initial_arrays(prob, Bt, dev))
        if guess:
            init[3] = cold_x
        args = (A1 if guess else A0, lbs, ubs, *init, None)
        kw = dict(struct=struct, params=prm, x_guess_specified=guess, v0_specified=False)
        card = solve_core_batched(*args, **kw)
        cpu = solve_core_batched(*(a.cpu() if torch.is_tensor(a) else a for a in args), **kw)
        if not guess:
            cold_x = card.x
        ints = [f for f in ("status", "it", "n_fact", "ctr_type", "trace_op", "trace_row")
                if not torch.equal(getattr(card, f).cpu(), getattr(cpu, f))]
        errs = {f: float((getattr(card, f).cpu() - getattr(cpu, f)).abs().max())
                for f in ("x",) + trace_fields}
        print(f"[golden (d)] {label}, solve_core_batched f64 B={Bt}: iterations mean "
              f"{float(card.it.float().mean()):.2f} max {int(card.it.max())}, status "
              f"{torch.bincount(card.status + 1).tolist()} (-1,0,1,2); card against CPU: "
              f"fields differing {ints or 'none'}; max |err| "
              + ", ".join(f"{f} {e:.3e}" for f, e in errs.items()))
        if ints or max(errs.values()) > 1e-10 or card.trace_x.shape[1] == 0:
            misses.append(f"trace: card and CPU differ ({label}): {ints}, {errs}")
    print(f"[golden (d)] {time.perf_counter() - t0:.3f} s")
    print(f"[golden] phase wall {time.perf_counter() - t_phase:.1f} s")
    if misses:
        raise SystemExit("golden phase failed:\n  " + "\n  ".join(misses))


def _config1_problem(dtype, dev):
    """``bench_extra.py:84-95``, as the bench draws it
    (``bench_extra_torch.config1_problem``): one random equality hierarchy
    (seed 0, n=88, dims (33, 3, 2, 97), every level at full rank), then B
    copies of A and of b, each perturbed by 1e-3."""
    from bench_extra_torch import config1_problem

    return config1_problem(B, dtype, dev)[:2]


def run_equality(dev, report):
    """The equality layer on the card: ``solve_equality_batched`` and
    ``LexLSE``, each one l-QR through kernel B1 (once per level) and a
    solve.  (a) ``bench_extra.py``'s config 1 (n=88, dims (33, 3, 2, 97),
    B=384, tolerance 1e-7) in float32 and float64, against the same call on
    the CPU (B1's plain version): float64 permutations, ranks and pivot
    rows identical and x to 1e-10; float32 ranks identical on all but a
    tenth of the instances and x to 1e-3 where they agree.  Equality
    solves/s (B over the median of EQ_REPS calls by CUDA events, with min
    and max), B1's launches and own device time per call (events around
    its launches) against the call's, the host's time to issue one call,
    and the call's kernels and device time (torch.profiler).  (b) least
    norm at config 1's width, its first three levels (50 free variables),
    on EQ_LN_B instances in float64: ``least_norm=True`` and ``LexLSE``
    options 1, 2 and 3 (TIKHONOV, zero factors), card against CPU to 1e-9
    and the options against each other to 1e-8.  (c) the golden ``eq_00..05``
    through ``LexLSE`` in float64: option 0's per-level residual norms to
    1e-8 of the C++ gold's, options 1, 2 and the general norm with M = I
    leave them there, ranks as on the CPU."""
    from bench_extra_torch import EQ_DIMS, EQ_N
    from lexls_tpu_torch import (EqualityHierarchy, LexLSE, ParametersLexLSE,
                                 RegularizationType, solve_equality_batched)
    from lexls_tpu_torch.io import dat as io_dat
    from lexls_tpu_torch import tracing
    from lexls_tpu_torch.ops import factorize_fast_batched

    t_phase = time.perf_counter()
    params = ParametersLexLSE(tol_linear_dependence=EQ_TOL)
    p = len(EQ_DIMS)
    misses = []

    def solve_counted(key, fn):
        """``fn()`` with the launch counts zeroed just before and read just
        after, filed under ``key``."""
        out, launches = _counted(fn)
        for k in report:
            report[k].setdefault("launches_by_path", {})[key] = launches[k]
        return out, launches

    # (a) config 1, card against CPU, then timed
    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        A, b = _config1_problem(dtype, dev)
        call = lambda: solve_equality_batched(A, b, EQ_DIMS, params)  # noqa: E731
        x, launches = solve_counted(f"equality_{name}", call)
        print(f"[equality (a) {name}] solve_equality_batched, config 1, B={B}: launches "
              f"{launches} (B1 expected {p}: one a level)")
        if launches["panel_factorize"] != p or launches["fused_active_set"]:
            misses.append(f"(a) {name}: launches {launches}")
        f_card = factorize_fast_batched(A, b, EQ_DIMS, params)
        t0 = time.perf_counter()
        x_cpu = solve_equality_batched(A.cpu(), b.cpu(), EQ_DIMS, params)
        cpu_s = time.perf_counter() - t0
        f_cpu = factorize_fast_batched(A.cpu(), b.cpu(), EQ_DIMS, params)
        same_rank = (f_card.ranks.cpu() == f_cpu.ranks).all(1)
        same = same_rank & (f_card.perm.cpu() == f_cpu.perm).all(1) \
            & (f_card.rank_row.cpu() == f_cpu.rank_row).all(1)
        err = (x.cpu() - x_cpu).abs().amax(1)
        xerr = float(err[same_rank].max()) if bool(same_rank.any()) else float("inf")
        ranks = f_card.ranks[0].tolist()
        print(f"[equality (a) {name}] card against CPU ({cpu_s:.3f} s on the CPU): ranks "
              f"differing on {int((~same_rank).sum())}/{B}, pivot orders on "
              f"{int((~same).sum())}/{B}; max |x err| where the ranks agree {xerr:.3e}; "
              f"ranks of instance 0 {ranks}; x finite {bool(torch.isfinite(x).all())}, shape "
              f"{tuple(x.shape)}")
        good = bool(torch.isfinite(x).all()) and tuple(x.shape) == (B, EQ_N)
        if dtype == torch.float64:
            good = good and bool(same.all()) and xerr <= 1e-10
        else:
            good = good and int((~same_rank).sum()) <= B // 10 and xerr <= 1e-3
        if not good:
            misses.append(f"(a) {name}: card and CPU disagree")

        times = _cuda_times(call, EQ_REPS)
        med = statistics.median(times)
        tracing.reset()
        with tracing.recording(device_events=True):
            for _ in range(EQ_REPS):
                call()
            torch.cuda.synchronize()
        events = tracing.snapshot().device_events
        own = sum(s.elapsed_time(e) for n_, s, e in events if "panel" in n_) / EQ_REPS
        host = []
        for _ in range(EQ_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        rows, _ = _profile(call)
        dev_ms = sum(r[0] for r in rows) / 1e3
        h = statistics.median(host)
        print(f"[equality (a) {name}] {B / med * 1e3:.1f} equality solves/s (B over the median "
              f"call, {med:.4f} ms, of {EQ_REPS} by CUDA events; min {min(times):.4f}, max "
              f"{max(times):.4f} ms); B1 {len(events) / EQ_REPS:g} launches a call, its own "
              f"device time {own:.4f} ms a call ({100 * own / med:.1f}% of the call); the call's "
              f"device time {dev_ms:.4f} ms in {sum(r[1] for r in rows)} kernel launches "
              f"(torch.profiler); the host's time to issue one call {h:.4f} ms (median of "
              f"{EQ_REPS}, no synchronise): the {'host' if h > dev_ms else 'card'} sets the "
              f"pace; {_card()}")

    # (b) least norm at config 1's width: its first three levels
    A64, b64 = _config1_problem(torch.float64, dev)
    rows_ln = sum(EQ_DIMS[:EQ_LN_LEVELS])
    dims_ln = EQ_DIMS[:EQ_LN_LEVELS]
    A_ln, b_ln = A64[:EQ_LN_B, :rows_ln].contiguous(), b64[:EQ_LN_B, :rows_ln].contiguous()
    (x_ln, x0), launches = solve_counted("equality_least_norm", lambda: (
        solve_equality_batched(A_ln, b_ln, dims_ln, params, least_norm=True),
        solve_equality_batched(A_ln, b_ln, dims_ln, params)))
    x_ln_cpu = solve_equality_batched(A_ln.cpu(), b_ln.cpu(), dims_ln, params, least_norm=True)
    ln_err = float((x_ln.cpu() - x_ln_cpu).abs().max())
    moved = float((x_ln - x0).abs().max())
    tik = ParametersLexLSE(tol_linear_dependence=EQ_TOL,
                           regularization_type=RegularizationType.TIKHONOV)
    opt_card_cpu, opt_spread = 0.0, 0.0
    for i in range(EQ_LN_B):
        prob = EqualityHierarchy(A=A_ln[i].cpu().numpy(), b=b_ln[i].cpu().numpy(), dims=dims_ln)
        xs = {}
        for opt in (1, 2, 3):
            prm = tik if opt == 3 else params
            card = LexLSE(prob, prm, device=dev).solve(opt).x
            cpu = LexLSE(prob, prm, device="cpu").solve(opt).x
            opt_card_cpu = max(opt_card_cpu, float(np.abs(card - cpu).max()))
            xs[opt] = card
        opt_spread = max(opt_spread, float(np.abs(xs[1] - xs[2]).max()),
                         float(np.abs(xs[3] - xs[2]).max()),
                         float(np.abs(xs[2] - x_ln[i].cpu().numpy()).max()))
    print(f"[equality (b)] least norm, dims {dims_ln}, n={EQ_N}, {EQ_LN_B} instances, f64: "
          f"least_norm=True card against CPU {ln_err:.3e} (launches {launches}; it moves x by "
          f"{moved:.3e} from the basic solution); LexLSE options 1, 2, 3 card against CPU "
          f"{opt_card_cpu:.3e}, against each other and least_norm=True {opt_spread:.3e}")
    if ln_err > 1e-9 or opt_card_cpu > 1e-9 or opt_spread > 1e-8 or moved < 1e-6 \
            or launches["panel_factorize"] != 2 * EQ_LN_LEVELS:
        misses.append(f"(b) least norm: {ln_err:.3e}, {opt_card_cpu:.3e}, {opt_spread:.3e}, "
                      f"moved {moved:.3e}, launches {launches}")

    # (c) the golden equality corpora through LexLSE
    with open(os.path.join(GOLDEN, "index.json")) as fh:
        index = json.load(fh)
    cases = []
    for i in range(6):
        name = f"eq_{i:02d}"
        prob = io_dat.to_equality(io_dat.load_dat_python(os.path.join(GOLDEN,
                                                                      index[name]["dat"])))
        with open(os.path.join(GOLDEN, name + ".json")) as fh:
            cases.append((name, prob, np.asarray(json.load(fh)["v_norms"], np.float64)))

    def golden_card():
        out = []
        for _, prob, _ in cases:
            s_card, n = LexLSE(prob, device=dev), prob.n_var
            out.append([s_card.solve(0), s_card.solve(1), s_card.solve(2),
                        s_card.solve_general_norm(np.eye(n), np.zeros(n))])
        return out

    card_results, launches = solve_counted("equality_golden", golden_card)
    worst, ok = 0.0, 0
    for (name, prob, gold), results in zip(cases, card_results):
        cpu = LexLSE(prob, device="cpu").solve(0)
        errs = [float(np.abs(np.array([np.linalg.norm(r.v[prob.level_slice(k)])
                                       for k in range(prob.n_obj)]) - gold).max())
                for r in results]
        worst = max(worst, *errs)
        good = max(errs) <= 1e-8 and np.array_equal(results[0].ranks, cpu.ranks)
        ok += good
        if not good:
            misses.append(f"(c) {name}: |d v_k| {errs}, ranks {results[0].ranks} (CPU "
                          f"{cpu.ranks})")
    print(f"[equality (c)] golden eq_00..05 through LexLSE, f64: {ok}/6 (options 0, 1, 2 and "
          f"the general norm, largest |d ||v_k||| {worst:.3e}; ranks as on the CPU); launches "
          f"{launches}")
    if launches["panel_factorize"] < 4 * sum(sum(d > 0 for d in c[1].dims) for c in cases):
        misses.append(f"(c): B1 launched {launches['panel_factorize']} times")
    print(f"[equality] phase wall {time.perf_counter() - t_phase:.1f} s")
    if misses:
        raise SystemExit("equality phase failed:\n  " + "\n  ".join(misses))


# config 5 (BASELINE.md:38, __graft_entry__.py:137-140): independent
# hierarchies sharded across devices, the bench problem at SH_B copies,
# against the same calls at B; each mode's cold solves timed SH_REPS times,
# its warm sequences SH_T steps deep; the modes against each other in
# float64 on the first SH_B64 instances; SH_BUDGET factorizations bound the
# profiled calls of the exact tier (a whole cold solve is some 10^5
# launches, whose trace takes the profiler minutes to digest), and the
# difference of two such calls, at SH_BUDGET and twice that, gives the time
# of SH_BUDGET passes alone at each B of SH_PASS_BS.  Each kernel is held
# against its plain version on the last SH_TAIL instances of SH_B, which
# run in the last waves of blocks: B1 on the launches of one pass of the
# exact tier, B2 on a launch paused after SH_CAP iterations (its plain
# version took 888 ms for a warm step of at most 3 iterations at B=384)
SH_B, SH_REPS, SH_T, SH_B64, SH_BUDGET = 10240, 3, 3, 256, 4
SH_TAIL, SH_CAP, SH_PASS_BS = 128, 4, (B, 2560, 5120, 10240)
SH_MODES = ("xla", "fused", "tracked")


def run_sharded(dev, report):
    """Config 5 through the sharded solvers on a one-rank NCCL process
    group (a file store in a temporary directory; ``make_host_mesh(1, 1)``):
    the card's machine has one GPU, so the all-reduces run at world size 1.
    See :func:`sharded_checks`."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from lexls_tpu_torch import make_host_mesh

    t_phase = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(1, 1)
        print(f"[sharded] NCCL process group of {dist.get_world_size()} rank, mesh {mesh}")
        sharded_checks(dev, report, mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(f"[sharded] phase wall {time.perf_counter() - t_phase:.1f} s")


def _same_state(a, b):
    """Whether every tensor field of two solver states is identical."""
    import dataclasses

    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a) if torch.is_tensor(getattr(a, f.name)))


def _states_agree(label, got, want, dims):
    """Two float32 solver states of the same instances by check_fused's
    float32 rule (:func:`_compare_results`): statuses equal, at most a
    tenth of the instances in another final working set, x within 1e-3
    where the working sets agree.  And on every instance the per-level
    |v|, which the lexicographic optimum fixes whatever the working set,
    within a tenth of the median distance between neighbouring instances
    of ``want``: config 5's instances are copies of one hierarchy a 1e-3
    perturbation apart, so a block that solved its neighbour's instance
    would pass the rule alone.  Returns a miss, or None."""
    same = (got.ctr_type == want.ctr_type).all(1)
    ndiff, status_ok = int((~same).sum()), bool(torch.equal(got.status, want.status))
    xerr = float((got.x - want.x).abs().amax(1)[same].max())
    vn, wn = _level_norms(got.v, dims), _level_norms(want.v, dims)
    dv = float(((vn - wn).abs() / (1 + wn)).max())
    nbr = float(((wn[1:] - wn[:-1]).abs() / (1 + wn[:-1])).amax(1).median())
    print(f"{label} statuses equal {status_ok}; final working sets differing {ndiff}/{len(same)}; "
          f"max |x err| {xerr:.3e} where equal; per-level |v| max |diff| / (1 + |v|) {dv:.3e} "
          f"(neighbouring instances: median {nbr:.3e})")
    if status_ok and ndiff <= len(same) // 10 and xerr <= 1e-3 and dv <= nbr / 10:
        return None
    return (f"{label} statuses equal {status_ok}, {ndiff} working sets differ, |x err| "
            f"{xerr:.3e}, |v_k| {dv:.3e} (a tenth of the neighbours' {nbr / 10:.3e})")


def _r_dist(a, b):
    """Per instance of two B2 results: max |R_a - R_b| on b's [:rank, :rank]
    over max(1, max |R_b|), and whether the two share positions and ranks
    (only then are their R comparable)."""
    live = torch.arange(a.rpad.shape[-1], device=a.rpad.device) < b.ranks[..., None]
    live2 = live[..., :, None] & live[..., None, :]
    scale = torch.where(live2, b.rpad, 0.0).abs().amax((1, 2, 3)).clamp(min=1.0)
    err = torch.where(live2, a.rpad - b.rpad, 0.0).abs().amax((1, 2, 3)) / scale
    return err, (a.posf == b.posf).all(1) & (a.ranks == b.ranks).all(1)


def _launches_of(module, name, fn, keep, rows):
    """Run ``fn`` with the kernel wrapper ``module.name`` spied on; return
    the last ``keep`` of its launches as (positional inputs, outputs,
    keywords, instances launched), each tensor cut to the instances
    ``rows``.  The spy passes every call through, so the path runs as it
    would."""
    import collections

    wrapper, kept = getattr(module, name), collections.deque(maxlen=keep)

    def spy(*args, **kw):
        out = wrapper(*args, **kw)
        kept.append(([a[rows].clone() if torch.is_tensor(a) else a for a in args],
                     [o[rows].clone() for o in out], kw, args[0].shape[0]))
        return out

    setattr(module, name, spy)
    try:
        fn()
    finally:
        setattr(module, name, wrapper)
    return list(kept)


def _b2_against_plain(label, got, want, misses):
    """B2's result on copies of one hierarchy (config 5's instances, a 1e-3
    perturbation apart) against its plain version on the same instances:
    check_fused's float32 rule (:func:`_compare_results`) with every status
    and counter equal too, and, since neighbouring instances lie inside
    that rule's 1e-3, each instance's R far closer to the plain version of
    its own instance than instances are to each other: the largest error
    at most a tenth of the median distance between neighbouring instances
    of the plain version.  A block that solved another instance misses.
    Appends what failed to ``misses``."""
    from lexls_tpu_torch.ops import fused as fused_mod

    cut = lambda r, rows: fused_mod.ActiveSetResult(*(f[rows] for f in r))  # noqa: E731
    try:
        _compare_results(f"{label} against the plain version:", got, want, exact=False)
    except SystemExit as e:
        misses.append(str(e))
    if not _counters_equal(got, want):
        misses.append(f"{label}: statuses or counters differ from the plain version's")
    kerr, ksame = _r_dist(got, want)
    nerr, nsame = _r_dist(cut(want, slice(1, None)), cut(want, slice(None, -1)))
    kmax = float(kerr[ksame].max())
    nmed = float(nerr[nsame].median()) if bool(nsame.any()) else float("inf")
    print(f"{label} per instance R err {kmax:.3e} at most; neighbouring instances of the "
          f"plain version {nmed:.3e} (median of {int(nsame.sum())} comparable pairs)")
    if not kmax <= nmed / 10:
        misses.append(f"{label}: R err {kmax:.3e} over a tenth of the neighbours' {nmed:.3e}")


def _tail_checks(dev, cold, reg, struct, params, short, misses, label="sharded"):
    """B1 and B2 on the last SH_TAIL of the cold instances against their plain
    versions on the same rows of the same inputs, by check_panel's and
    check_fused's float32 rules: B1's launches of the last pass of the
    exact tier's call cut at SH_BUDGET factorizations, as that call made
    them at the full B; B2 launched at the full B on the cold phase-1 state, as
    ``solve_core_fused`` launches it, paused after SH_CAP iterations."""
    from lexls_tpu_torch import solve_batched
    from lexls_tpu_torch.lexlsi import active_set_kwargs
    from lexls_tpu_torch.ops import fused as fused_mod
    from lexls_tpu_torch.ops import fused_active_set, fused_active_set_ref, panel_factorize_ref
    from lexls_tpu_torch.ops import panel_lqr as panel_mod

    Bn = cold[0].shape[0]
    tail = slice(Bn - SH_TAIL, Bn)
    p = len(struct.lexlse_dims)
    launches = _launches_of(panel_mod, "panel_factorize", lambda: solve_batched(
        *cold, reg, struct=struct, params=short), p, tail)
    for k, (args, got, kw, _) in enumerate(launches):
        want = panel_factorize_ref(*args, **kw)
        ndiff, err = _panel_diff(got, want)
        print(f"[{label} B1 tail] launch {k + 1} of {p} of the last pass (fr={kw['fr']}, "
              f"B={Bn}): instances {Bn - SH_TAIL}..{Bn - 1} against the plain version: "
              f"pivot orders differing {ndiff}/{SH_TAIL}; max |err| where equal {err:.3e}")
        if ndiff > SH_TAIL // 10 or err > 1e-3:
            misses.append(f"B1 tail, launch {k + 1}: {ndiff} pivot orders differ, |err| {err:.3e}")
    if len(launches) != p:
        misses.append(f"B1 tail: {len(launches)} launches kept, want {p}")

    s = _phase1(*cold[:3], struct, params)
    args = _state_args(cold[0], s)
    kw = active_set_kwargs(struct, params, dev)
    got = fused_active_set(*args, iter_cap=SH_CAP, **kw)
    want = fused_active_set_ref(*(a[tail] for a in args), iter_cap=SH_CAP, **kw)
    torch.cuda.synchronize()
    _b2_against_plain(f"[{label} B2 tail] B={Bn} iter_cap={SH_CAP}, instances "
                      f"{Bn - SH_TAIL}..{Bn - 1}",
                      fused_mod.ActiveSetResult(*(f[tail] for f in got)), want, misses)


def _counted(fn):
    """``fn()`` with the kernels' launch counts zeroed just before and read
    just after: (its result, {kernel: launches})."""
    with _counting() as launches:
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    return out, launches


def _xla_passes(mesh, struct, params, cold, reg):
    """The exact tier's time per pass at each B of SH_PASS_BS, with phase 1
    and the first passes taken out: the difference of two sharded xla
    calls cut at SH_BUDGET and at 2 SH_BUDGET factorizations, over
    SH_BUDGET; host wall by CUDA events (median of SH_REPS each), device
    time by the profiler."""
    import dataclasses

    from lexls_tpu_torch import make_sharded_solver_2d

    fns = [make_sharded_solver_2d(mesh, struct, dataclasses.replace(
        params, max_number_of_factorizations=k * SH_BUDGET), mode="xla") for k in (1, 2)]
    for Bn in SH_PASS_BS:
        a = [t[:Bn] for t in cold] + [reg]
        wall = [_cuda_ms(lambda: f(*a), SH_REPS) for f in fns]
        dev_ms = [sum(r[0] for r in _profile(lambda: f(*a))[0]) / 1e3 for f in fns]
        w, d = (wall[1] - wall[0]) / SH_BUDGET, (dev_ms[1] - dev_ms[0]) / SH_BUDGET
        print(f"[sharded xla pass] B={Bn}: {w:.3f} ms of host wall a pass (calls cut at "
              f"{SH_BUDGET} / {2 * SH_BUDGET} factorizations: {wall[0]:.3f} / {wall[1]:.3f} ms), "
              f"{d:.3f} ms of device time a pass ({dev_ms[0]:.3f} / {dev_ms[1]:.3f} ms): busy "
              f"{100 * d / w:.1f}% of a pass")


def sharded_checks(dev, report, mesh):
    """For each mode, ``make_sharded_solver_2d`` on SH_B cold instances of
    the bench problem in float32: driven once with the launch counts zeroed
    just before and read just after (and the peak device memory of that
    call), its state identical (bitwise) to the mode's unsharded call,
    its metrics equal to the sums over that state, and the fused and the
    tracked state held against the exact tier's (:func:`_states_agree`);
    cold solves/s at SH_B and at B (CUDA events, median of SH_REPS; the
    driven call is the first of SH_B's); the device's busy share
    (torch.profiler; a whole call of the fused and the tracked mode, the
    exact tier's call cut at SH_BUDGET factorizations).  Then B1 and B2 on
    the last instances against their plain versions (:func:`_tail_checks`),
    the exact tier's time per pass at several B (:func:`_xla_passes`), and
    the metrics' reduction timed alone.  Then ``make_sharded_sequence_solver``
    in every mode at T=SH_T (the tracked mode with ``bench.py``'s knobs), and
    the three modes against each other in float64 on SH_B64 instances:
    statuses identical, per-level |v| within 1e-8."""
    import dataclasses

    import torch.distributed as dist

    from bench_torch import TRACKED
    from lexls_tpu_torch import (Structure, make_sharded_sequence_solver,
                                 make_sharded_solver_2d, solve_batched, solve_core_cold_tracked,
                                 solve_core_fused)
    from lexls_tpu_torch.parallel.batch import _mesh_groups, _reduce_metrics

    prob, params, base, drifts, lb, ub = _bench_problem(torch.float32, dev, SH_B)
    struct = Structure.of(prob)
    reg = torch.as_tensor(prob.regularization, device=dev)
    cold = _cold_inputs(struct, base, drifts, lb, ub)
    flags = dict(struct=struct, params=params)
    unsharded = {
        "xla": lambda *a: solve_batched(*a, **flags),
        "fused": lambda *a: solve_core_fused(*a, **flags, x_guess_specified=False,
                                             v0_specified=False),
        "tracked": lambda *a: solve_core_cold_tracked(*a[:8], **flags, reg=a[8])[0],
    }
    misses = []

    def args(Bn, inputs=cold):
        return [a[:Bn] for a in inputs] + [reg]

    short = dataclasses.replace(params, max_number_of_factorizations=SH_BUDGET)
    rates, states = {}, {}
    for mode in SH_MODES:
        fn = make_sharded_solver_2d(mesh, struct, params, mode=mode)
        ref = unsharded[mode](*args(SH_B))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        (st, metrics), launches = _counted(lambda: fn(*args(SH_B)))
        end.record()
        end.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        for k in report:
            report[k].setdefault("launches_by_path", {})[f"sharded_{mode}"] = launches[k]
        same = _same_state(st, ref)
        want = {"solved": int((ref.status == 0).sum()), "max_iterations": int(ref.it.max()),
                "sum_iterations": int(ref.it.sum())}
        got = {k: int(v) for k, v in metrics.items()}
        big = [start.elapsed_time(end)] + _cuda_times(lambda: fn(*args(SH_B)), SH_REPS - 1,
                                                      warmup=False)
        small = _cuda_times(lambda: fn(*args(B)), SH_REPS)
        ms_big, ms_small = statistics.median(big), statistics.median(small)
        rates[mode] = (SH_B / ms_big * 1e3, B / ms_small * 1e3)
        if mode != "xla":
            rows, wall_ms = _profile(lambda: fn(*args(SH_B)))
            what = "a whole call"
        else:
            fshort = make_sharded_solver_2d(mesh, struct, short, mode=mode)
            rows, wall_ms = _profile(lambda: fshort(*args(SH_B)))
            what = (f"not the timed call: one cut at {SH_BUDGET} factorizations, phase 1 and "
                    f"the first {SH_BUDGET - 1} passes")
        dev_ms = sum(r[0] for r in rows) / 1e3
        b1_ms = sum(r[0] for r in rows if "panel_factorize_kernel" in r[2]) / 1e3
        b2_ms = sum(r[0] for r in rows if "fused_kernel" in r[2]) / 1e3
        print(f"[sharded {mode}] config 5, B={SH_B} float32, cold: {rates[mode][0]:.1f} cold "
              f"solves/s ({ms_big:.3f} ms a call, median of {SH_REPS} by CUDA events; all "
              f"{[round(t, 3) for t in big]}) against {rates[mode][1]:.1f} at B={B} "
              f"({ms_small:.3f} ms; all {[round(t, 3) for t in small]}); solved "
              f"{want['solved']}/{SH_B}; iterations mean {float(ref.it.double().mean()):.2f} "
              f"max {want['max_iterations']}; launches {launches} a call; peak device memory "
              f"{peak:.1f} MiB (torch.cuda.max_memory_allocated, inputs, the unsharded "
              f"reference and the earlier modes' states included); device busy "
              f"{100 * dev_ms / wall_ms:.1f}% of the profiled "
              f"wall ({what}: {dev_ms:.3f} ms of device time in {sum(r[1] for r in rows)} "
              f"launches, of which B1 {b1_ms:.3f} ms and B2 {b2_ms:.3f} ms; {wall_ms:.3f} ms "
              f"profiled); state identical to the unsharded call: "
              f"{same}; metrics {got}")
        x_ok = tuple(st.x.shape) == (SH_B, N_VAR) and bool(torch.isfinite(st.x).all())
        if not same or got != want or not x_ok or launches[
                "panel_factorize" if mode == "xla" else "fused_active_set"] == 0:
            misses.append(f"{mode}: identical {same}, metrics {got} (want {want}), x finite "
                          f"and in shape {x_ok}, launches {launches}")
        states[mode] = st
        del ref
        if mode != "xla":
            miss = _states_agree(f"[sharded {mode}] B={SH_B} float32 against the xla state:", st,
                                 states["xla"], prob.dims)
            if miss:
                misses.append(miss)
    del states
    _tail_checks(dev, args(SH_B)[:8], reg, struct, params, short, misses)
    _xla_passes(mesh, struct, params, args(SH_B)[:8], reg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    _phase1(*cold[:3], struct, params)
    torch.cuda.synchronize()
    print(f"[sharded] phase 1 alone (the cold factorization through B1 and the basic solve) at "
          f"B={SH_B}: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, of "
          f"which {base_mib:.1f} MiB was allocated before it")
    groups = _mesh_groups(mesh)
    red_ms = _cuda_ms(lambda: _reduce_metrics(st.status, st.it, groups), 20)
    one = torch.zeros(2, dtype=torch.int64, device=dev)
    ar_ms = _cuda_ms(lambda: dist.all_reduce(one, group=groups[0]), 20)
    print(f"[sharded] the metrics' reduction over B={SH_B}: {red_ms:.4f} ms (the local sums and "
          f"two all-reduces per mesh dimension, {len(groups)} dimensions; median of 20 by CUDA "
          f"events); one NCCL all-reduce of two int64 at world size 1: {ar_ms:.4f} ms")
    print(f"[sharded] cold solves/s B={SH_B} / B={B}: "
          + "; ".join(f"{m} {a:.1f} / {b:.1f} ({a / b:.2f}x)" for m, (a, b) in rates.items()))

    # the warm sequences, sharded
    m = prob.n_ctr
    A_seq = (base[:, None] + drifts[None, :SH_T]).contiguous()
    lb_seq, ub_seq = lb.expand(SH_B, SH_T, m), ub.expand(SH_B, SH_T, m)
    for mode in SH_MODES:
        fn = make_sharded_sequence_solver(mesh, struct, params, mode=mode,
                                          **(TRACKED if mode == "tracked" else {}))
        t0 = time.perf_counter()
        (outs, metrics), launches = _counted(lambda: fn(A_seq, lb_seq, ub_seq, reg))
        wall = time.perf_counter() - t0
        for k in report:
            report[k]["launches_by_path"][f"sharded_seq_{mode}"] = launches[k]
        x, status, it = outs[0], outs[2], outs[3]
        got = {k: int(v) for k, v in metrics.items()}
        want = {"solved": int((status == 0).sum()), "max_iterations": int(it.max()),
                "sum_iterations": int(it.sum())}
        print(f"[sharded sequence {mode}] B={SH_B} T={SH_T} float32: {wall:.3f} s host wall; "
              f"solved per step {(status == 0).sum(0).tolist()} of {SH_B}; iterations per step, "
              f"mean {[round(float(c), 2) for c in it.double().mean(0)]}, max "
              f"{it.amax(0).tolist()}; launches {launches}; metrics {got}")
        if got != want or tuple(x.shape) != (SH_B, SH_T, N_VAR) \
                or not bool(torch.isfinite(x).all()) or sum(launches.values()) == 0:
            misses.append(f"sequence {mode}: metrics {got} (want {want}), launches {launches}")

    # float64: the three modes against each other
    prob64, params64, base64, drifts64, lb64, ub64 = _bench_problem(torch.float64, dev, SH_B64)
    inputs64 = _cold_inputs(struct, base64, drifts64, lb64, ub64)
    res = {mode: make_sharded_solver_2d(mesh, struct, params64, mode=mode)(
        *args(SH_B64, inputs64))[0] for mode in SH_MODES}
    norms = {mode: _level_norms(r.v, prob.dims) for mode, r in res.items()}
    for mode in ("fused", "tracked"):
        same = bool(torch.equal(res[mode].status, res["xla"].status))
        dv = float((norms[mode] - norms["xla"]).abs().max())
        print(f"[sharded f64] B={SH_B64}: {mode} against xla: statuses identical {same}; max "
              f"|d ||v_k||| {dv:.3e}; solved {int((res[mode].status == 0).sum())}/{SH_B64}")
        if not same or not dv <= 1e-8:
            misses.append(f"f64 {mode} against xla: statuses identical {same}, |d v_k| {dv:.3e}")
    if misses:
        raise SystemExit("sharded phase failed:\n  " + "\n  ".join(misses))


def _cold_inputs(struct, base, drifts, lb, ub):
    """The cold step of the bench sequence: A, lb, ub, the initial working
    set, x0 and v0 of every instance."""
    from lexls_tpu_torch.sequence import _device_initial_activation

    Bn, m, n = base.shape
    A = (base + drifts[0]).contiguous()
    lbs, ubs = lb.expand(Bn, m).contiguous(), ub.expand(Bn, m).contiguous()
    c, s, ns = _device_initial_activation(
        A, lbs, ubs, torch.zeros(Bn, m, dtype=torch.int32, device=A.device), struct)
    z = lambda *shape: torch.zeros(*shape, dtype=A.dtype, device=A.device)  # noqa: E731
    return [A, lbs, ubs, c, s, ns, z(Bn, n), z(Bn, m)]


# the slabs phase: the tracked path's knobs (bench.py's ns_iters and
# trip1_noext), its timing rounds, config 5's depth, how many of a slab's
# instances B2 is held against its plain version on, and float64's B and
# ns_iters (with two passes no float64 carry passes its 1e-9 certificate
# on the bench problem, so neither option would run)
SLAB_KW = dict(ns_iters=2, trip1_noext=True)
SLAB_REPS, SLAB_T_BIG, SLAB_TAIL, SLAB_B64, SLAB_NS64 = 5, 6, 128, 256, 3


def _round_up(v, q):
    return max(q, -(-int(v) // q) * q)


def _pyramid(alive, Bn, q):
    """Slab sizes from counts of instances alive after trips 1 and 2 (of
    B instances), scaled to ``Bn`` and rounded up to multiples of ``q``:
    strictly decreasing and below ``Bn``."""
    sizes = []
    for a in alive:
        z = _round_up(a * Bn / B, q)
        if z < (sizes[-1] if sizes else Bn):
            sizes.append(z)
    return tuple(sizes)


def _slab_of(stats, Bn, q):
    """A handover slab that the unresolved instances of every warm step of
    a run without it fit (``stats``: a (trips, handed over) tuple per warm
    step), rounded up to a multiple of ``q``; half the batch if they do not
    fit below ``Bn``, and then the steps with more overflow to full
    width."""
    z = _round_up(max(n for _, n in stats), q)
    return z if z < Bn else Bn // 2


def _slab_branches(stats, S):
    """(warm steps that took the slab branch, that overflowed to full
    width) of a run with ``handover_slab=S``."""
    handed = [n for _, n in stats]
    return sum(0 < n <= S for n in handed), sum(n > S for n in handed)


def _outs_agree(label, got, want, dims, exact=False):
    """Two runs of the same sequence or steps, (x, v, status, ..., ctr_type)
    with instances then steps leading, by :func:`_states_agree` (its
    neighbour bound included) with each step's instances side by side, so
    that neighbours are neighbouring instances of one step; in float64
    (``exact``) also per-level |v| to 1e-8.  Returns a miss, or None."""
    import types

    def steps(o):
        f = lambda t: t.transpose(0, 1).reshape(-1, *t.shape[2:])  # noqa: E731
        return types.SimpleNamespace(x=f(o[0]), v=f(o[1]), status=f(o[2]), ctr_type=f(o[-1]))

    g, w = steps(got), steps(want)
    miss = _states_agree(label, g, w, dims)
    if exact:
        dv = float((_level_norms(g.v, dims) - _level_norms(w.v, dims)).abs().max())
        print(f"{label} per-level |v| max |diff| {dv:.3e}")
        if not dv <= 1e-8:
            miss = miss or f"{label} |v_k| {dv:.3e} over 1e-8"
    return miss


def slab_fall_profile(dev):
    """(a) ``tools/trk_stats.py`` on the card: the bench sequence (B, float32,
    T=T_MAX) on the tracked path with ``loop_cap=0`` and ``debug_fall``
    (its defaults: ``ns_iters=2``, extension on the first trip): per warm
    step the iteration histogram, the falls by trip and reason, and the
    instances alive after trips 1, 2 and 3.  Returns those three counts
    of every warm step."""
    from lexls_tpu_torch import Structure, solve_core_cold_tracked, solve_core_tracked
    from lexls_tpu_torch.sequence import _device_initial_activation

    prob, params, base, drifts, lb, ub = _bench_problem(torch.float32, dev, B)
    struct = Structure.of(prob)
    cold = _cold_inputs(struct, base, drifts, lb, ub)
    st, car = solve_core_cold_tracked(*cold, struct=struct, params=params, ns_iters=2)
    lbs, ubs, v0 = cold[1], cold[2], cold[7]
    print("[slabs fall profile] step | iterations (1, 2, 3, 4, 5+) | mean | max | falls | "
          "{fall_trip: n} | {fall_why: n} | alive after trips 1, 2, 3")
    per_step = []
    for t in range(1, T_MAX):
        A = (base + drifts[t]).contiguous()
        c, s, ns = _device_initial_activation(A, lbs, ubs, st.ctr_type, struct)
        st, car, (fall, fall_trip, fall_why) = solve_core_tracked(
            A, lbs, ubs, c, s, ns, st.x, v0, carried=car, struct=struct, params=params,
            ns_iters=2, loop_cap=0, debug_fall=True)
        it = st.it
        hist = [int((it == k).sum()) for k in (1, 2, 3, 4)] + [int((it >= 5).sum())]
        trips = {int(k): int(n) for k, n in zip(*torch.unique(fall_trip[fall],
                                                              return_counts=True))}
        why = {int(k): int(n) for k, n in zip(*torch.unique(fall_why[fall], return_counts=True))}
        alive = [int(((~fall) & (it > k)).sum() + (fall & (fall_trip // 10 > k)).sum())
                 for k in (1, 2, 3)]
        per_step.append(alive)
        print(f"  {t:2d} | {hist} | {float(it.float().mean()):.3f} | {int(it.max())} | "
              f"{int(fall.sum())} | {trips} | {why} | {alive}")
        if not bool((st.status == 0).all()):
            raise SystemExit(f"slabs fall profile, step {t}: not every solve is PROBLEM_SOLVED")
    most = [max(col) for col in zip(*per_step)]
    print(f"[slabs fall profile] most alive after trips 1, 2, 3: {most} of {B}; median "
          f"{[statistics.median(col) for col in zip(*per_step)]}")
    return per_step


def slab_bench(dev, report, alive):
    """(b) The tracked sequence at the bench shape (B, float32, T=T_MAX)
    with ``loop_cap=0`` without and with a pyramid sized from (a), and with
    ``loop_cap=1`` without and with a handover slab that every warm step's
    unresolved instances fit: each driven with the launch counts zeroed
    just before and read just after, held against its run without the
    option, warm solves/s by the slope in interleaved rounds; then the
    same runs in float64 at SLAB_B64 with SLAB_NS64 passes.  Each dtype
    misses when the pyramid ran no slab trip or no warm step took the
    slab branch."""
    from lexls_tpu_torch import Structure, solve_sequence_batched_fused

    lo, hi = TS
    misses = []
    for dtype, Bn in ((torch.float32, B), (torch.float64, SLAB_B64)):
        prob, params, base, drifts, lb, ub = _bench_problem(dtype, dev, Bn)
        struct = Structure.of(prob)
        m = prob.n_ctr
        A_seq = (base[:, None] + drifts[None]).contiguous()
        lb_seq, ub_seq = lb.expand(Bn, T_MAX, m), ub.expand(Bn, T_MAX, m)

        knobs = dict(SLAB_KW, ns_iters=SLAB_NS64) if dtype == torch.float64 else SLAB_KW

        def run(T, stats=None, **kw):
            return solve_sequence_batched_fused(
                A_seq[:, :T], lb_seq[:, :T], ub_seq[:, :T], None, struct=struct, params=params,
                tracked=True, stats=stats, **knobs, **kw)

        shrink = _pyramid(alive, Bn, 8)
        opts = {"loop_cap=0": dict(loop_cap=0),
                f"loop_cap=0, shrink={shrink}": dict(loop_cap=0, shrink=shrink),
                "loop_cap=1": dict(loop_cap=1)}
        names = list(opts)
        out, stats, launches = {}, {}, {}
        for name in names + [None]:
            if name is None:  # the slab, once loop_cap=1 has shown the stragglers
                S = _slab_of(stats["loop_cap=1"], Bn, 32)
                name = f"loop_cap=1, handover_slab={S}"
                opts[name] = dict(loop_cap=1, handover_slab=S)
            stats[name] = []
            out[name], launches[name] = _counted(lambda: run(T_MAX, stats[name], **opts[name]))
            del stats[name][0]  # the cold step's
            trips = [t for t, _ in stats[name]]
            handed = [n for _, n in stats[name]]
            line = (f"[slabs B={Bn} {str(dtype)[6:]}] {name}: launches {launches[name]} "
                    f"(T={T_MAX}); "
                    f"trips per warm step {trips}; handed to B2 {handed}")
            if "handover_slab" in name:
                slab, over = _slab_branches(stats[name], S)
                line += f"; warm steps through the slab {slab}, overflowed to full width {over}"
                if slab == 0:
                    misses.append(f"B={Bn} {name}: no warm step took the slab branch")
                if dtype == torch.float32:
                    report["fused_active_set"]["launches_by_path"]["slab_384"] = \
                        launches[name]["fused_active_set"]
            if "shrink" in name and max(trips) < 2:
                misses.append(f"B={Bn} {name}: no warm step ran a slab trip")
            print(line)
            if not bool((out[name][2] == 0).all()):
                misses.append(f"B={Bn} {name}: not every solve is PROBLEM_SOLVED")
        names = list(opts)
        for name, ref in ((names[1], names[0]), (names[3], names[2])):
            miss = _outs_agree(f"[slabs B={Bn} {str(dtype)[6:]}] {name} against {ref}:",
                               out[name], out[ref], prob.dims, exact=dtype == torch.float64)
            if miss:
                misses.append(miss)
        if dtype == torch.float64:
            miss = _outs_agree(f"[slabs B={Bn} float64] {names[3]} against {names[0]}:",
                               out[names[3]], out[names[0]], prob.dims, exact=True)
            if miss:
                misses.append(miss)
            continue
        (_, cold_launches) = _counted(lambda: run(1))
        keys = [(name, T) for name in names for T in (lo, hi)]
        times = _sequence_times(lambda key: run(key[1], **opts[key[0]]), keys, SLAB_REPS)
        for name in names:
            steps, rates = _warm_rate({T: times[(name, T)] for T in (lo, hi)}, lo, hi)
            per_step = {k: (n - cold_launches[k]) / (T_MAX - 1)
                        for k, n in launches[name].items()}
            print(f"[slabs B={B} float32] {name}: warm solves/s over {SLAB_REPS} rounds "
                  f"{_spread(rates)}; ms per warm step {_spread(steps)}; kernel launches per "
                  f"warm step {per_step}")
    if misses:
        raise SystemExit("slabs phase (b) failed:\n  " + "\n  ".join(misses))


def slab_config5(dev, report, most, typical):
    """(c) Config 5's B=SH_B, float32: the cold tracked solve once, then
    SLAB_T_BIG - 1 warm steps through ``solve_core_tracked`` with
    ``loop_cap=0`` without and with two pyramids scaled from (a), one that
    the most alive instances fit and one sized to the median step, whose
    stragglers beyond the slab go to B2, and with
    ``loop_cap=1`` without and with a slab: each warm step timed by CUDA
    events, trips a step, peak memory, the device's busy share over warm
    step 1 run again under the profiler, and the states held against the
    run without the option; a pyramid that ran no slab trip misses.  (d)
    B2 at slab width: warm step 1 with the slab run once more with B2's
    wrapper and the tracker's handover spied on, its first SLAB_TAIL
    instances against the plain version (:func:`_b2_against_plain`), and
    the state and carried factors of every instance outside the slab (the
    unresolved first in stable order, then resolved ones to fill it)
    identical to the tracker's own before the handover; that launch timed
    against the same step's launch at full width (``loop_cap=1`` without
    the slab)."""
    from lexls_tpu_torch import Structure, solve_core_cold_tracked, solve_core_tracked
    from lexls_tpu_torch import tracker as trk
    from lexls_tpu_torch.ops import fused as fused_mod
    from lexls_tpu_torch.ops import fused_active_set, fused_active_set_ref
    from lexls_tpu_torch.sequence import _device_initial_activation

    prob, params, base, drifts, lb, ub = _bench_problem(torch.float32, dev, SH_B)
    struct = Structure.of(prob)
    cold = _cold_inputs(struct, base, drifts, lb, ub)
    lbs, ubs, v0 = cold[1], cold[2], cold[7]
    st0, car0 = solve_core_cold_tracked(*cold, struct=struct, params=params, ns_iters=2)
    torch.cuda.synchronize()
    big, small = _pyramid(most, SH_B, 128), _pyramid(typical, SH_B, 128)
    opts = {"loop_cap=0": dict(loop_cap=0),
            f"loop_cap=0, shrink={big}": dict(loop_cap=0, shrink=big),
            f"loop_cap=0, shrink={small} (median-sized)": dict(loop_cap=0, shrink=small),
            "loop_cap=1": dict(loop_cap=1)}
    misses, out, step1 = [], {}, {}

    def warm_inputs(t, st):
        A = (base + drifts[t]).contiguous()
        c, s, ns = _device_initial_activation(A, lbs, ubs, st.ctr_type, struct)
        return (A, lbs, ubs, c, s, ns, st.x, v0)

    def warm(args, car, stats=None, **kw):
        return solve_core_tracked(*args, carried=car, struct=struct, params=params,
                                  stats=stats, **SLAB_KW, **kw)

    names = list(opts)
    for name in names + [None]:
        if name is None:
            S = _slab_of(stats, SH_B, 512)
            name = f"loop_cap=1, handover_slab={S}"
            opts[name] = dict(loop_cap=1, handover_slab=S)
        st, car, stats, ms, steps = st0, car0, [], [], []
        launches = dict.fromkeys(KERNELS, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mib = torch.cuda.memory_allocated() / 2**20
        for t in range(1, SLAB_T_BIG):
            args = warm_inputs(t, st)
            if t == 1:
                step1[name] = (args, car)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            (st, car), counts = _counted(lambda: warm(args, car, stats, **opts[name]))
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            launches = {k: launches[k] + counts[k] for k in counts}
            steps.append((st.x, st.v, st.status, st.ctr_type))
            if not bool((st.status == 0).all()):
                misses.append(f"B={SH_B} {name}, step {t}: not every solve is PROBLEM_SOLVED")
        peak = torch.cuda.max_memory_allocated() / 2**20
        out[name] = tuple(torch.stack(f, 1) for f in zip(*steps))
        rows, wall_ms = _profile(lambda: warm(*step1[name], **opts[name]))
        dev_ms = sum(r[0] for r in rows) / 1e3
        line = (f"[slabs B={SH_B} float32] {name}: warm steps {[round(v, 3) for v in ms]} ms "
                f"(CUDA events); trips per step {[t for t, _ in stats]}; handed to B2 "
                f"{[n for _, n in stats]}; launches {launches} over {SLAB_T_BIG - 1} warm "
                f"steps; peak device memory {peak:.1f} MiB, of which {base_mib:.1f} MiB was "
                f"allocated before the run (inputs, the cold state, earlier runs' states); "
                f"device busy "
                f"{100 * dev_ms / wall_ms:.1f}% of warm step 1 run again under the profiler "
                f"({dev_ms:.3f} ms of device time in {sum(r[1] for r in rows)} launches, "
                f"{wall_ms:.3f} ms profiled)")
        if "handover_slab" in name:
            slab, over = _slab_branches(stats, S)
            line += f"; warm steps through the slab {slab}, overflowed {over}"
            report["fused_active_set"]["launches_by_path"]["slab_10240"] = \
                launches["fused_active_set"]
            if slab == 0 or launches["fused_active_set"] == 0:
                misses.append(f"B={SH_B}: the slab branch was not taken")
        if "shrink" in name and max(t for t, _ in stats) < 2:
            misses.append(f"B={SH_B} {name}: no warm step ran a slab trip")
        print(line)
    names = list(opts)
    for name, ref in ((names[1], names[0]), (names[2], names[0]), (names[4], names[3])):
        miss = _outs_agree(f"[slabs B={SH_B} float32] {name} against {ref}:", out[name],
                           out[ref], prob.dims)
        if miss:
            misses.append(miss)

    # (d): B2 at slab width against its plain version, and the scatter
    name = names[4]
    handover, seen = trk._handover, []

    def handover_spy(A, s, carried_t, **kw):
        out = handover(A, s, carried_t, **kw)
        seen.append((s, carried_t, kw["handover_slab"], out))
        return out

    trk._handover = handover_spy
    try:
        kept = _launches_of(fused_mod, "fused_active_set",
                            lambda: warm(*step1[name], **opts[name]), 1, slice(None))
    finally:
        trk._handover = handover
    # the same warm step's B2 launch at full width (loop_cap=1 without the slab)
    kept_full = _launches_of(fused_mod, "fused_active_set",
                             lambda: warm(*step1[names[3]], **opts[names[3]]), 1, slice(None))
    if not kept or not kept_full or len(seen) != 1:
        raise SystemExit(f"slabs (d): warm step 1 launched B2 {len(kept)} times with the slab, "
                         f"{len(kept_full)} without; {len(seen)} handovers")
    args_s, got, kw, width = kept[0]
    args_f = kept_full[0][0]
    ms = [_cuda_ms(lambda a=a: fused_active_set(*a, **kw), 5)
          for a in (args_s, args_f, args_f, args_s)]
    head = [a[:SLAB_TAIL] if torch.is_tensor(a) else a for a in args_s]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = fused_active_set_ref(*head, **kw)
    end.record()
    end.synchronize()
    print(f"[slabs B2 at slab width] B={SH_B}, {name}, warm step 1: B2 launched on {width} "
          f"instances; the call {ms[0]:.4f} / {ms[3]:.4f} ms at slab width against "
          f"{ms[1]:.4f} / {ms[2]:.4f} ms for the same step's launch on all {SH_B} (CUDA events, "
          f"median of 5, in turns); the plain version on the first {SLAB_TAIL} instances "
          f"{start.elapsed_time(end):.4f} ms")
    _b2_against_plain(f"[slabs B2 at slab width] instances 0..{SLAB_TAIL - 1} of the slab",
                      fused_mod.ActiveSetResult(*(o[:SLAB_TAIL] for o in got)), want, misses)
    s, carried_t, S, (final, carried) = seen[0]
    resolved = s.status != -1
    outside = torch.ones(SH_B, dtype=torch.bool, device=dev)
    outside[torch.argsort(resolved, stable=True)[:S]] = False
    same = all(torch.equal(a[outside], b[outside]) for a, b in
               [(getattr(final, f), getattr(s, f)) for f in type(s).__dataclass_fields__]
               + list(zip(carried, carried_t)))
    print(f"[slabs B2 at slab width] the {int(outside.sum())} instances outside the slab of "
          f"{S}: all resolved by the tracker {bool(resolved[outside].all())}; merged state and "
          f"carried factors identical to the tracker's own {same}")
    if width != S or S >= SH_B or not same or not bool(resolved[outside].all()):
        misses.append(f"slab handover: launched on {width} of {SH_B}, slab {S}, outside "
                      f"identical {same}, resolved {bool(resolved[outside].all())}")
    if misses:
        raise SystemExit("slabs phase (c)/(d) failed:\n  " + "\n  ".join(misses))


def run_slabs(dev, report):
    """The tracker's pyramid and slab handover on the card: (a) the fall
    profile at the bench shape, (b) the options at the bench shape, (c) at
    config 5's B=SH_B, (d) B2 at slab width against its plain version."""
    t_phase = time.perf_counter()
    report["fused_active_set"].setdefault("launches_by_path", {})
    per_step = slab_fall_profile(dev)
    most = [max(col) for col in zip(*per_step)][:2]
    typical = [statistics.median(col) for col in zip(*per_step)][:2]
    slab_bench(dev, report, most)
    slab_config5(dev, report, most, typical)
    print(f"[slabs] phase wall {time.perf_counter() - t_phase:.1f} s")


# config 2 (bench_extra.py:117-185), uncut: two-sided inequalities, n=88, dims
# (44, 44), a budget of 150 factorizations, cold, C2_B instances in float32
# (bench_extra.py's B on the card) and C2_B64 in float64; each mode timed over
# C2_REPS calls; the exact tier profiled on a call cut at SH_BUDGET
# factorizations (a whole call is tens of thousands of launches); B1 and B2
# held against their plain versions on the last SH_TAIL instances; x held to
# C2_TOL_X relative, float32's exact tier against float64's and the float32
# modes against float32's exact tier (read on an H100: 6.045e-03 and 3.532e-03)
C2_B, C2_B64, C2_REPS, C2_TOL_X = 1024, 256, 3, 1.5e-2
C2_MODES = ("exact", "fused", "tracked")


def _config2_solvers(prob, inp, params):
    """Config 2's cold solve in each mode, from ``bench_extra_torch``'s
    inputs: ``exact`` (``solve_batched``, kernel B1 in every pass), and
    ``fused`` (kernel B2) and ``tracked`` as the bench solves them
    (``bench_extra_torch.config2_solver``); each takes an optional stats
    list, and ``exact`` other parameters."""
    from bench_extra_torch import config2_solver
    from lexls_tpu_torch import Structure, solve_batched

    A = inp["A"]
    Bn, m, n = A.shape
    z = lambda *shape: torch.zeros(*shape, dtype=A.dtype, device=A.device)  # noqa: E731
    cold = [A, inp["lb"], inp["ub"], inp["ctr_type0"], inp["stamp0"], inp["next_stamp0"],
            z(Bn, n), z(Bn, m)]
    struct = Structure.of(prob)
    fused, tracked = (config2_solver(prob, params, inp, mode) for mode in ("fused", "tracked"))
    return cold, {
        "exact": lambda stats=None, params=params: solve_batched(*cold, inp["reg"], struct=struct,
                                                                 params=params),
        "fused": lambda stats=None: fused(A),
        "tracked": lambda stats=None: tracked(A, stats),
    }


def _rel_x_err(got, want):
    """max |x_got - x_want| / (1 + |x_want|) over the instances whose final
    working sets agree (x is unique there)."""
    same = (got.ctr_type == want.ctr_type).all(1)
    err = ((got.x.double() - want.x.double()).abs() / (1 + want.x.double().abs())).amax(1)
    return float(err[same].max())


def _states_agree_by_x(label, got, want, tol_x):
    """:func:`_states_agree` for a hierarchy whose every level is feasible
    (config 2: float64's per-level |v| is about 1e-11 on every instance, so
    the float32 |v| is roundoff and cannot tell instances apart): statuses
    equal, at most a tenth of the instances in another final working set,
    and where the working sets agree x within ``tol_x`` relative (|dx| /
    (1 + |x|)) and within a tenth of the median relative distance between
    the x of neighbouring instances of ``want`` (the neighbour bound on x
    instead of |v|, so that a block that solved its neighbour's instance
    misses).  Returns a miss, or None."""
    same = (got.ctr_type == want.ctr_type).all(1)
    ndiff, status_ok = int((~same).sum()), bool(torch.equal(got.status, want.status))
    xerr = _rel_x_err(got, want)
    w = want.x.double()
    nbr = float(((w[1:] - w[:-1]).abs() / (1 + w[:-1].abs())).amax(1).median())
    print(f"{label} statuses equal {status_ok}; final working sets differing {ndiff}/{len(same)}; "
          f"max |x err| / (1 + |x|) {xerr:.3e} where equal (bound {tol_x:.3e}; neighbouring "
          f"instances: median {nbr:.3e})")
    if status_ok and ndiff <= len(same) // 10 and xerr <= min(tol_x, nbr / 10):
        return None
    return (f"{label} statuses equal {status_ok}, {ndiff} working sets differ, |x err| / (1 + |x|) "
            f"{xerr:.3e} (bound {tol_x:.3e}, a tenth of the neighbours' {nbr / 10:.3e})")


def run_config2(dev, report):
    """Config 2 on the card, the problem of
    ``bench_extra_torch.config2_problem`` (so that this phase and the bench
    measure one problem): C2_B cold solves in float32 through the exact
    tier, the fused tier (B2, with B1 p times in phase 1) and the tracker
    (B2 for one capped iteration, trips, then B2 on what the trips left),
    each driven once with the launch counts zeroed just before and read
    just after and the peak device memory of that call; every status and
    every NaN x counted; the float32 exact tier held against the float64
    exact tier on the same instances, and fused and tracked against the
    float32 exact tier (:func:`_states_agree_by_x`, its neighbour bound
    included, x to the fixed C2_TOL_X relative); cold solves/s
    (median of C2_REPS calls by CUDA events); B2's own device time in the
    fused call (events around its launch); launches and the device's busy
    share (torch.profiler; the exact tier's call cut at SH_BUDGET
    factorizations); B2's bound.  Then B1 and B2 on the last SH_TAIL
    instances against their plain versions (:func:`_tail_checks`), and in
    float64 on the first C2_B64 the fused tier against the exact tier: statuses,
    iterations, working sets and counters identical, x and v to 1e-8."""
    import dataclasses

    from bench_extra_torch import config2_problem
    from lexls_tpu_torch import Structure
    from lexls_tpu_torch import tracing
    from lexls_tpu_torch.ops import fused as fused_mod

    t_phase = time.perf_counter()
    prob, params, inp = config2_problem(C2_B, torch.float32, dev)
    struct = Structure.of(prob)
    p, n = len(struct.lexlse_dims), prob.n_var
    cold, fns = _config2_solvers(prob, inp, params)
    short = dataclasses.replace(params, max_number_of_factorizations=SH_BUDGET)
    misses, states, calls = [], {}, {}
    for mode in C2_MODES:
        fn, stats = fns[mode], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mib = torch.cuda.memory_allocated() / 2**20
        t0 = time.perf_counter()
        st, launches = _counted(lambda: fn(stats))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        for k in report:
            report[k].setdefault("launches_by_path", {})[f"config2_{mode}"] = launches[k]
        counts = torch.bincount(st.status + 1, minlength=4).tolist()
        nan_x = int((~torch.isfinite(st.x)).any(1).sum())
        times = _cuda_times(fn, C2_REPS, warmup=False)
        ms = calls[mode] = statistics.median(times)
        rows, wall_ms = _profile(lambda: fn(params=short) if mode == "exact" else fn())
        dev_ms = sum(r[0] for r in rows) / 1e3
        b1_ms = sum(r[0] for r in rows if "panel_factorize_kernel" in r[2]) / 1e3
        b2_ms = sum(r[0] for r in rows if "fused_kernel" in r[2]) / 1e3
        what = f"a call cut at {SH_BUDGET} factorizations" if mode == "exact" else "a whole call"
        trips = f"; tracker trips {stats[0][0]}, instances handed to B2 {stats[0][1]}/{C2_B}" \
            if stats else ""
        print(f"[config2 {mode}] B={C2_B} n={n} dims={prob.dims} float32, cold: "
              f"{C2_B / ms * 1e3:.1f} cold solves/s ({ms:.3f} ms a call, median of {C2_REPS} by "
              f"CUDA events; all {[round(t, 3) for t in times]}); first call {wall:.3f} s host "
              f"wall; status counts {counts} (-1,0,1,2); NaN x {nan_x}; iterations mean "
              f"{float(st.it.double().mean()):.2f} max {int(st.it.max())}; launches {launches} a "
              f"call{trips}; peak device memory {peak:.1f} MiB ({base_mib:.1f} held before); "
              f"device busy {100 * dev_ms / wall_ms:.1f}% of the profiled wall ({what}: "
              f"{dev_ms:.3f} ms of device time in {sum(r[1] for r in rows)} launches, B1 "
              f"{b1_ms:.3f} ms, B2 {b2_ms:.3f} ms; {wall_ms:.3f} ms profiled)")
        want = {"exact": (launches["panel_factorize"] > p, launches["fused_active_set"] == 0),
                "fused": (launches["panel_factorize"] == p, launches["fused_active_set"] == 1),
                "tracked": (launches["panel_factorize"] == p,
                            launches["fused_active_set"] >= 1)}[mode]
        if not all(want) or tuple(st.x.shape) != (C2_B, n) or nan_x:
            misses.append(f"{mode}: launches {launches}, x of shape {tuple(st.x.shape)}, NaN x "
                          f"{nan_x}")
        states[mode] = st
    # float64's exact tier on the same instances: float32's own error
    _, params64, inp64 = config2_problem(C2_B, torch.float64, dev)
    _, fns64 = _config2_solvers(prob, inp64, params64)
    exact64 = fns64["exact"]()
    print(f"[config2] float64's exact tier: per-level |v| at most "
          f"{float(_level_norms(exact64.v, prob.dims).max()):.3e} (every level is feasible)")
    # the reference itself at the fixed limit, then the modes against it
    for label, got, want in (("exact", states["exact"], exact64),
                             ("fused", states["fused"], states["exact"]),
                             ("tracked", states["tracked"], states["exact"])):
        against = "float64's exact tier" if want is exact64 else "float32's exact tier"
        miss = _states_agree_by_x(f"[config2 {label}] B={C2_B} float32 against {against}:",
                                  got, want, C2_TOL_X)
        if miss:
            misses.append(miss)
    print("[config2] cold solves/s: " + "; ".join(f"{k} {C2_B / v * 1e3:.1f}"
                                                  for k, v in calls.items()) + f"; {_card()}")

    # B2's own device time and its bound in the fused call
    tracing.reset()
    with tracing.recording(device_events=True):
        for _ in range(C2_REPS):
            torch.cuda.synchronize()  # an idle card: the events bracket the kernel alone
            fns["fused"]()
        torch.cuda.synchronize()
    events = tracing.snapshot().device_events
    own = [s.elapsed_time(e) for name, s, e in events if "fused" in name]
    print(f"[config2 fused] B2's own device time {statistics.median(own):.4f} ms a call (median of "
          f"{len(own)} launches, events around the launch; all {[round(t, 4) for t in own]}); "
          f"B1's {sum(s.elapsed_time(e) for name, s, e in events if 'panel' in name) / C2_REPS:.4f}"
          f" ms a call in phase 1")
    (args, outs, kw, _), = _launches_of(fused_mod, "fused_active_set", fns["fused"], 1,
                                        slice(None))
    res = fused_mod.ActiveSetResult(*outs)
    bound_ms, bound_by = _print_bound("[config2 fused] B2", args, kw, res, struct, n=n)
    report["fused_active_set"]["config2"] = dict(ms=calls["fused"], own_ms=statistics.median(own),
                                                 bound_ms=bound_ms, bound_by=bound_by)

    # the kernels against their plain versions on the last instances
    _tail_checks(dev, cold, inp["reg"], struct, params, short, misses, label="config2")

    # float64: the fused tier against the exact tier on the first C2_B64 instances
    _, fns64 = _config2_solvers(prob, {k: v if k == "reg" else v[:C2_B64]
                                       for k, v in inp64.items()}, params64)
    exact, fused = fns64["exact"](), fns64["fused"]()
    ints = ("status", "it", "ctr_type", "stamp", "next_stamp", "n_act", "n_deact", "n_fact")
    bad = [f for f in ints if not torch.equal(getattr(exact, f), getattr(fused, f))]
    errs = {f: float((getattr(exact, f) - getattr(fused, f)).abs().max()) for f in ("x", "v")}
    print(f"[config2 f64] B={C2_B64}: fused against the exact tier: fields differing "
          f"{bad or 'none'}; max |err| x {errs['x']:.3e}, v {errs['v']:.3e}; status counts "
          f"{torch.bincount(exact.status + 1, minlength=4).tolist()} (-1,0,1,2); iterations mean "
          f"{float(exact.it.double().mean()):.2f} max {int(exact.it.max())}")
    if bad or max(errs.values()) > 1e-8:
        misses.append(f"f64: fields differing {bad}, |err| {errs}")
    print(f"[config2] phase wall {time.perf_counter() - t_phase:.1f} s")
    if misses:
        raise SystemExit("config2 phase failed:\n  " + "\n  ".join(misses))


C2C_REPS, C2C_N = 3, 3  # chains per mode; solves per chain, the largest N of the bench's slope
B2_F64_TOL_X = 1e-9  # B2 against its plain version on one instance in float64 (4.161e-13 read)
# where found instances are saved: under the checkout's build/, which git ignores
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "config2_chain")


def _log_pairs(r, b):
    """Instance ``b``'s working-set log of a B2 result as (objective, row,
    type, value) per entry."""
    L = int(r.log_len[b])
    return list(zip(r.log_obj[b, :L].tolist(), r.log_ctr[b, :L].tolist(),
                    r.log_type[b, :L].tolist(), r.log_value[b, :L].tolist()))


def _level_pivots(r):
    """Per level of a B2 result's factor export: (rank, smallest accepted
    pivot norm squared)."""
    out = []
    for k in range(r.ranks.shape[1]):
        rk = int(r.ranks[0, k])
        d = torch.diagonal(r.rpad[0, k]).double()[:rk] ** 2
        out.append((rk, float(d.min()) if rk else None))
    return out


def _level0_b1(dev, A, lb, ub, ct, tol, d):
    """B1 and its plain version on level 0 of the masked problem at working
    set ``ct`` (B=1): each one's rank and the plain version's last pivot
    column, and where B1 stopped short the largest live column norm squared
    it left and the columns whose live norm squared is under ``tol`` (the
    only ones whose choice stops the level).  ``d`` is level 0's row
    count."""
    from lexls_tpu_torch import CtrType
    from lexls_tpu_torch.ops import panel_factorize, panel_factorize_ref

    n = A.shape[-1]
    act = (ct != int(CtrType.INACTIVE)).to(A.dtype)
    rhs = torch.where(ct == int(CtrType.ACTIVE_LB), lb, ub)
    blk = torch.cat([A * act[:, None], (rhs * act)[:, None]], 1)[None, :d].contiguous()
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None].contiguous()
    args = (blk, pos, pos.clone(), torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros(1, n, dtype=torch.int32, device=dev))
    got, want = panel_factorize(*args, fr=0, tol=tol), panel_factorize_ref(*args, fr=0, tol=tol)
    torch.cuda.synchronize()
    rk, rw = int(got[3][0]), int(want[3][0])
    left = got[0][0, rk:, :n].double().pow(2).sum(0)
    rem = torch.nonzero(got[1][0] >= rk).flatten().tolist() if rk < d else []
    under = {c: f"{float(left[c]):.3e}" for c in rem if float(left[c]) < tol}
    print(f"[config2_chain B1 at B=1] level 0 ({d} active rows) at that working set: rank B1 {rk} / "
          f"plain {rw}; the plain version's last pivot column {int(want[2][0, rw - 1])}; B1 "
          f"stopped with largest live column norm squared "
          f"{max((float(left[c]) for c in rem), default=float('nan')):.3e} left, and these "
          f"columns under the tolerance {tol:.0e}: {under}")


def _b2_one(dev, prob, params, A, lb, ub):
    """B2 and its plain version on the card on one instance (B=1), cold from
    phase 1 as ``solve_core_fused`` starts it, with the working-set log on:
    prints both statuses and iterations and the first log entry (one per
    iteration that changed the working set) at which they differ, with
    both entries' values, so that a tie can be told from a decision.  Where
    they part, B2 again paused at that iteration (each level's rank and
    smallest pivot there), and B1 against its plain version on level 0 at
    the working set both had then.  Then both in float64, where B2 must
    give its plain version's status and log, and x to B2_F64_TOL_X:
    returns the misses."""
    import dataclasses

    from lexls_tpu_torch import Structure
    from lexls_tpu_torch.lexlsi import active_set_kwargs
    from lexls_tpu_torch.ops import fused_active_set, fused_active_set_ref

    struct = Structure.of(prob)
    logged = dataclasses.replace(params, log_working_set_enabled=True)
    misses = []
    for dtype in (A.dtype, torch.float64):
        Ad, lbd, ubd = A.to(dtype), lb.to(dtype), ub.to(dtype)
        s = _phase1(Ad[None], lbd[None], ubd[None], struct, logged)
        args, kw = _state_args(Ad[None], s), active_set_kwargs(struct, logged, dev)
        got, want = fused_active_set(*args, **kw), fused_active_set_ref(*args, **kw)
        torch.cuda.synchronize()
        gl, wl = _log_pairs(got, 0), _log_pairs(want, 0)
        first = next((k for k, (g, w) in enumerate(zip(gl, wl)) if g[:3] != w[:3]),
                     None if len(gl) == len(wl) else min(len(gl), len(wl)))
        where = "none: the logs are equal" if first is None else (
            f"entry {first}: B2 {gl[first] if first < len(gl) else 'no entry'}, plain "
            f"{wl[first] if first < len(wl) else 'no entry'} (objective, row, type, value)")
        name = str(dtype).replace("torch.", "")
        print(f"[config2_chain B2 at B=1 {name}] status B2 {int(got.status[0])} / plain "
              f"{int(want.status[0])} (-1 is a spent budget), iterations {int(got.it[0])} / "
              f"{int(want.it[0])}, log entries {len(gl)} / {len(wl)}; first differing "
              f"working-set change: {where}; max |x B2 - x plain| "
              f"{float((got.x - want.x).abs().max()):.3e}")
        if dtype == torch.float64:
            xerr = float((got.x - want.x).abs().max())
            if first is not None or not torch.equal(got.status, want.status) \
                    or not xerr <= B2_F64_TOL_X:
                misses.append(f"B2 at B=1 float64 left its plain version: status "
                              f"{int(got.status[0])} / {int(want.status[0])}, first differing "
                              f"log entry {first}, max |x err| {xerr:.3e} (bound "
                              f"{B2_F64_TOL_X:.0e})")
        if first is None:
            continue
        g = fused_active_set(*args, iter_cap=first + 1, **kw)
        print(f"[config2_chain B2 at B=1 {name}] B2 paused after {first + 1} iterations: (rank, "
              f"smallest pivot norm squared) per level {_level_pivots(g)}")
        # the working set both had then: phase 1's with the logged changes applied
        ct = s.ctr_type[0].clone()
        for _, row, typ, _ in wl[:first]:
            ct[row] = typ
        _level0_b1(dev, Ad, lbd, ubd, ct, params.tol_linear_dependence, prob.dims[0])
    return misses


def run_config2_chain(dev, report):
    """The chain of ``bench_extra_torch.bench_inequality_cold`` replayed on
    the card: config 2 (B=C2_B, float32, cold) through
    ``bench_extra_torch.config2_solver`` and ``cold_chain``, the functions
    the bench times, C2C_REPS times in the tracked and in the fused mode,
    each a chain of C2C_N solves (every A the one before moved by 1e-9
    times the NaN-free sum of its x, so the inputs depend on the card's own
    float32 answers), with the launch counts zeroed just before each chain
    and read just after.  Each instance that ends in another status than
    PROBLEM_SOLVED is printed (mode, chain, solve, index, status,
    iterations; the first UNSOLVED_AT of a solve, as the bench's record
    names them) and saved with its A, bounds and x under
    ``build/config2_chain/``; the first is then solved again at B=1
    by B2 and by its plain version on the card (:func:`_b2_one`).  Prints
    whether the chains of one mode are bitwise equal.
    Fails if a chain does not launch both kernels or gives x of another
    shape or a NaN x, or if B2 leaves its plain version in float64."""
    from bench_extra_torch import UNSOLVED_AT, cold_chain, config2_problem, config2_solver
    from lexls_tpu_torch.lexlsi import full_fp32

    t_phase = time.perf_counter()
    full_fp32()
    prob, params, inp = config2_problem(C2_B, torch.float32, dev)
    p, n = len(prob.dims), prob.n_var
    found, misses, total = [], [], 0
    for mode in ("tracked", "fused"):
        solve = config2_solver(prob, params, inp, mode)
        first = None
        for rep in range(C2C_REPS):
            t0 = time.perf_counter()
            (_, steps), launches = _counted(lambda: cold_chain(solve, inp["A"], C2C_N))
            wall = time.perf_counter() - t0
            if rep == 0:
                first = steps
                for k in report:
                    report[k].setdefault("launches_by_path", {})[f"config2_chain_{mode}"] = \
                        launches[k]
                if launches["panel_factorize"] < p * C2C_N or launches["fused_active_set"] < C2C_N:
                    misses.append(f"{mode}: launches {launches} for {C2C_N} solves")
            else:
                same = all(torch.equal(a.status, b.status) and torch.equal(a.x, b.x)
                           for (_, a), (_, b) in zip(first, steps))
                print(f"[config2_chain {mode}] chain {rep} bitwise equal to chain 0 (statuses "
                      f"and x of every solve): {same}")
            unsolved = []
            for k, (A, st) in enumerate(steps):
                bad = torch.nonzero(st.status != 0).flatten().tolist()
                unsolved.append(len(bad))
                if tuple(st.x.shape) != (C2_B, n) or not bool(torch.isfinite(st.x).all()):
                    misses.append(f"{mode} chain {rep} solve {k}: x of shape "
                                  f"{tuple(st.x.shape)} or not finite")
                for i in bad[:UNSOLVED_AT]:
                    print(f"[config2_chain] unsolved: mode {mode}, chain {rep}, solve {k}, index "
                          f"{i}: status {int(st.status[i])}, iterations {int(st.it[i])}, "
                          f"factorizations {int(st.n_fact[i])}")
                    found.append((mode, rep, k, i, A[i], st))
            total += sum(unsolved)
            print(f"[config2_chain {mode}] chain {rep}: {C2C_N} solves at B={C2_B} float32, "
                  f"{wall:.3f} s host wall; unsolved per solve {unsolved}; launches {launches}; "
                  f"iterations per solve {[int(st.it.sum()) for _, st in steps]}")
    print(f"[config2_chain] {2 * C2C_REPS} chains of {C2C_N} solves ({2 * C2C_REPS * C2C_N * C2_B} "
          f"cold solves): {total} not PROBLEM_SOLVED; {_card()}")
    if not found:
        print(f"[config2_chain] no instance ended unsolved in the {2 * C2C_REPS} chains "
              f"(tracked and fused, {C2C_REPS} each, N={C2C_N}, B={C2_B}, float32)")
    seen = set()
    os.makedirs(OUT, exist_ok=True)
    for mode, rep, k, i, A, st in found:
        if (mode, k, i) in seen:  # the same instance of a repeated chain
            continue
        seen.add((mode, k, i))
        path = os.path.join(OUT, f"{mode}_solve{k}_index{i}.npz")
        np.savez(path, A=A.cpu().numpy(), lb=inp["lb"][i].cpu().numpy(),
                 ub=inp["ub"][i].cpu().numpy(), x=st.x[i].cpu().numpy(),
                 ctr_type=st.ctr_type[i].cpu().numpy(), status=int(st.status[i]),
                 it=int(st.it[i]), n_fact=int(st.n_fact[i]), dims=np.asarray(prob.dims),
                 n_var=n, mode=mode, solve=k, index=i)
        print(f"[config2_chain] saved {path}")
    if found:
        _, _, _, i, A, _ = found[0]
        misses += _b2_one(dev, prob, params, A, inp["lb"][i], inp["ub"][i])
    print(f"[config2_chain] phase wall {time.perf_counter() - t_phase:.1f} s")
    if misses:
        raise SystemExit("config2_chain phase failed:\n  " + "\n  ".join(misses))


INST_B, INST_T = 384, 3  # the installed package's fused warm sequence: the bench shape, T=3
INST_TOL_X = 1e-5
# run by a fresh interpreter outside the checkout, with the installed
# package on its path: the fused sequence on the inputs that the parent
# saved, with the kernels' launch counts zeroed just before and read just after
_INSTALLED_RUN = r"""
import json, os, sys, time
import torch
import lexls_tpu_torch as lt
from lexls_tpu_torch import tracing
from lexls_tpu_torch.ops import _build

tmp = sys.argv[1]
d = torch.load(os.path.join(tmp, "inputs.pt"))
t0 = time.perf_counter()
info = _build.build()
build_s = time.perf_counter() - t0
dev = torch.device("cuda", 0)
A, lb, ub, reg = (d[k].to(dev) for k in ("A", "lb", "ub", "reg"))
struct = lt.Structure(dims=tuple(d["dims"]), n_var=int(d["n_var"]))
params = lt.ParametersLexLSI(**d["params"])
with tracing.recording():
    torch.cuda.synchronize()
    x, v, status = lt.solve_sequence_batched_fused(A, lb, ub, reg, struct=struct,
                                                   params=params)[:3]
    torch.cuda.synchronize()
counters = tracing.snapshot().counters
torch.save({"x": x.cpu(), "status": status.cpu()}, os.path.join(tmp, "out.pt"))
print(json.dumps(dict(
    file=lt.__file__, csrc=str(_build.CSRC), library=str(info.path), nvcc_s=info.seconds, build_s=build_s,
    launches={k: sum(v for name, v in counters.items() if name.startswith(f"launches.lexls_{k}_"))
              for k in ("panel_factorize", "fused_active_set", "activation", "phase1_warm")},
    jax_package=sorted(m for m in sys.modules if m.split(".")[0] == "lexls_tpu"))))
"""


def _tree(path):
    """{relative path: (size, mtime in ns)} of every file under ``path``."""
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            st = os.stat(os.path.join(dirpath, f))
            out[os.path.relpath(os.path.join(dirpath, f), path)] = (st.st_size, st.st_mtime_ns)
    return out


def install_port(root, tmp, target):
    """Install the package as a user would: the wheel built by ``pip
    wheel`` from a copy of the tree ``root`` (``pyproject.toml``,
    ``README.md``, both packages; building in place would write into the
    checkout) under ``tmp``, then ``pip install --target target``, pip
    never looking at an index.  Raises naming pip or setuptools where one
    does not import.  Returns the wheel's path."""
    import glob
    import importlib
    import shutil

    for module in ("setuptools", "pip"):
        importlib.import_module(module)
    src = os.path.join(tmp, "src")
    os.makedirs(src)
    for f in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(root, f), src)
    for d in ("lexls_tpu", "lexls_tpu_torch"):
        shutil.copytree(os.path.join(root, d), os.path.join(src, d),
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    pip = [sys.executable, "-m", "pip", "--disable-pip-version-check", "--no-cache-dir"]
    env = dict(os.environ, PIP_NO_INDEX="1")
    subprocess.run(pip + ["wheel", "--no-deps", "--no-build-isolation", "--no-index", "-w",
                          os.path.join(tmp, "dist"), src], cwd=tmp, env=env, check=True,
                   capture_output=True, timeout=300)
    wheel, = glob.glob(os.path.join(tmp, "dist", "*.whl"))
    subprocess.run(pip + ["install", "--no-deps", "--no-index", "--target", target, wheel],
                   cwd=tmp, env=env, check=True, capture_output=True, timeout=300)
    return wheel


def run_installed(dev, report):
    """The port installed, not run from the checkout: installed into a
    temporary directory (:func:`install_port`), then imported by a fresh
    interpreter whose working directory is outside the checkout, whose path
    holds the install and not the checkout, and whose ``XDG_CACHE_HOME`` is a
    fresh temporary directory; there it builds the kernels from the
    installed sources and runs one fused warm sequence of the bench shape
    (B=INST_B, T=INST_T, float32) on the card, with its launches counted.
    Holds: the package and its sources come from the install, the library
    was built into that cache under the name of the checkout's sources,
    the checkout's build directory was not touched, nothing of
    ``lexls_tpu`` was imported, every solve is PROBLEM_SOLVED and x is the
    checkout's same call's to INST_TOL_X relative.  Prints the build's
    seconds beside the card's name and power limit."""
    import dataclasses
    import shutil
    import tempfile

    from lexls_tpu_torch import Structure, solve_sequence_batched_fused
    from lexls_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    prob, params, base, drifts, lb, ub = _bench_problem(torch.float32, dev, INST_B)
    m = prob.n_ctr
    A = (base[:, None] + drifts[None, :INST_T]).contiguous()
    lbs, ubs = (b.expand(INST_B, INST_T, m).contiguous() for b in (lb, ub))
    reg = torch.as_tensor(prob.regularization, device=dev).to(torch.float32)
    kw = {f.name: getattr(params, f.name) for f in dataclasses.fields(params)
          if getattr(params, f.name) != f.default}
    want = solve_sequence_batched_fused(A, lbs, ubs, reg, struct=Structure.of(prob),
                                        params=params)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_installed_")
    try:
        target, cache = os.path.join(tmp, "site"), os.path.join(tmp, "cache")
        wheel = install_port(root, tmp, target)
        torch.save(dict(A=A.cpu(), lb=lbs.cpu(), ub=ubs.cpu(), reg=reg.cpu(),
                        dims=list(prob.dims), n_var=prob.n_var, params=kw),
                   os.path.join(tmp, "inputs.pt"))
        before = _tree(_build.BUILD_DIR)
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XDG_CACHE_HOME")}
        env.update(PYTHONPATH=target, XDG_CACHE_HOME=cache, PYTHONNOUSERSITE="1")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _INSTALLED_RUN, tmp], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f"installed phase: the installed package failed ({proc.returncode})"
                             f":\n{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        out = torch.load(os.path.join(tmp, "out.pt"))
        touched = _tree(_build.BUILD_DIR) != before
        lib = os.path.join(cache, "lexls_tpu_torch", _build.build().path.name)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    x, status = out["x"], out["status"]
    wx = want[0].cpu()
    err = float(((x.double() - wx.double()).abs() / (1 + wx.double().abs())).max())
    solved = int((status == 0).sum())
    print(f"[installed] pip install --target of the wheel {os.path.basename(wheel)}; a fresh interpreter outside the checkout imported "
          f"{os.path.relpath(got['file'], tmp)}, sources {os.path.relpath(got['csrc'], tmp)}, "
          f"built {os.path.relpath(got['library'], tmp)} in {got['nvcc_s']:.2f} s of nvcc "
          f"({got['build_s']:.2f} s the call; {_card()}); subprocess {wall:.1f} s; launches "
          f"{got['launches']}; modules of lexls_tpu imported {got['jax_package']}; checkout's "
          f"build directory touched {touched}")
    print(f"[installed] fused warm sequence B={INST_B} T={INST_T} float32: solved "
          f"{solved}/{status.numel()}; max |x - x of the checkout| / (1 + |x|) {err:.3e} "
          f"(bound {INST_TOL_X:.0e}); bitwise equal {torch.equal(x, wx)}")
    for k in report:
        report[k].setdefault("launches_by_path", {})["installed"] = got["launches"][k]
    misses = [what for what, bad in (
        ("the package was not imported from the install",
         not got["file"].startswith(os.path.join(tmp, "site", "lexls_tpu_torch"))),
        ("the sources are not the installed ones",
         got["csrc"] != os.path.join(tmp, "site", "lexls_tpu_torch", "csrc")),
        ("the library was not built into the fresh cache under the sources' name",
         got["library"] != lib or got["nvcc_s"] <= 0),
        ("the checkout's build directory was touched", touched),
        ("a module of lexls_tpu was imported", got["jax_package"]),
        ("a kernel of the path was not launched", min(got["launches"].values()) == 0),
        ("not every solve is PROBLEM_SOLVED", solved != status.numel()
         or not bool((want[2] == 0).all())),
        (f"x off the checkout's by {err:.3e}", not err <= INST_TOL_X)) if bad]
    print(f"[installed] phase wall {time.perf_counter() - t_phase:.1f} s")
    if misses:
        raise SystemExit("installed phase failed:\n  " + "\n  ".join(misses))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from lexls_tpu_torch.ops import _build
    except ModuleNotFoundError as e:
        print(f"chip_smoke: {e}: run it from the root of a checkout, beside the package "
              "lexls_tpu_torch", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    try:
        import triton  # noqa: F401
        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    smi = _card()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
          f"triton {has_triton}")
    print(smi)

    info = _build.build()
    print(f"[build] nvcc -gencode arch=compute_90a,code=sm_90a from "
          f"lexls_tpu_torch/csrc: {info.seconds:.2f} s -> {info.path.name}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    report = {
        "panel_factorize": dict(name="panel_factorize", route="cuda",
                                source="lexls_tpu_torch/csrc/panel_lqr.cu",
                                replaces="lexls_tpu/ops/pallas_lqr.py:238", library_ms=None),
        "fused_active_set": dict(name="fused_active_set", route="cuda",
                                 source="lexls_tpu_torch/csrc/fused.cu",
                                 replaces="lexls_tpu/ops/fused.py:966", library_ms=None),
        "activation": dict(name="activation", route="cuda", source="lexls_tpu_torch/csrc/phase1.cu",
                           replaces=None, library_ms=None),
        "phase1_warm": dict(name="phase1_warm", route="cuda",
                            source="lexls_tpu_torch/csrc/phase1.cu", replaces=None,
                            library_ms=None),
    }
    phases = {
        "layouts": print_layouts,
        "panel": lambda: check_panel(dev, report),
        "fused": lambda: check_fused(dev, report),
        "phase1": lambda: check_phase1(dev, report),
        "simple_bounds": lambda: check_simple_bounds(dev),
        "tracked_simple_bounds": lambda: check_tracked_simple_bounds(dev),
        "exact_tier": lambda: check_exact_tier(dev),
        "cycling_fixture": lambda: check_cycling_fixture(dev),
        "test01_cycling": lambda: measure_test01_cycling(dev),
        "main_paths": lambda: run_main_paths(dev, report),
        "new_paths": lambda: run_new_paths(dev, report),
        "regularized": lambda: run_regularized(dev, report),
        "golden": lambda: run_golden(dev, report),
        "equality": lambda: run_equality(dev, report),
        "sharded": lambda: run_sharded(dev, report),
        "slabs": lambda: run_slabs(dev, report),
        "config2": lambda: run_config2(dev, report),
        "config2_chain": lambda: run_config2_chain(dev, report),
        "installed": lambda: run_installed(dev, report),
    }
    # with phase names as arguments, only those run and no result is printed
    # (for work on one kernel); with none, as the check runs it, all do
    only = sys.argv[1:]
    for phase in only or phases:
        phases[phase]()
    if only:
        return 0

    print(json.dumps({"kernels": list(report.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
