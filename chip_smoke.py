#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``lexls_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases:
  1. the toolchain: torch/CUDA versions, device, triton, power limit;
  2. build the CUDA kernels from ``lexls_tpu_torch/csrc`` with nvcc;
  3. kernel B1 (panel factorization) against its plain version at the
     bench level shape, plus a rank-deficient block, in float64 and float32;
  4. kernel B2 (whole active-set solve) against its plain version on the
     bench problem, cold and warm, in float64 and float32;
  5. the main path: ``solve_sequence_batched_fused`` at the bench shape
     (n=100, 4 levels of 30 rows, B=384, T=14, float32, ``bench.py``'s
     tolerances), with launch counts, correctness checks, and warm solves/s
     as the slope between T=2 and T=14 (median and spread over 11 rounds)
     next to the same figure with the warm steps through B2's plain
     version;
  6. a ``torch.profiler`` trace of one T=14 sequence: device time per
     kernel and B2's share of it.

Prints one JSON line with the per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device or any phase fails.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_VAR, DIMS, B, T_MAX = 100, (30, 30, 30, 30), 384, 14
TS = (2, 14)
REPS = 11  # timing rounds of the main path, as bench.py's repetitions


def _cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
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
    return statistics.median(times)


def _bench_problem(dtype, dev):
    """The workload of ``bench.py:133-166``: one random 4x30 hierarchy over
    100 variables, B perturbed copies, and a drift stream shared by all."""
    from lexls_tpu_torch.oracle import random_inequality_hierarchy
    from lexls_tpu_torch.types import ParametersLexLSI

    params = ParametersLexLSI(max_number_of_factorizations=250, tol_linear_dependence=1e-7,
                              tol_wrong_sign_lambda=1e-4, tol_correct_sign_lambda=1e-6,
                              tol_feasibility=1e-5)
    rng = np.random.default_rng(0)
    prob = random_inequality_hierarchy(rng, N_VAR, list(DIMS), equality_fraction=0.1,
                                       tight_fraction=0.3)
    drifts = 1e-3 * np.cumsum(
        np.random.default_rng(1).standard_normal((T_MAX,) + prob.A.shape), axis=0)
    base = np.stack([prob.A + 1e-3 * rng.standard_normal(prob.A.shape) for _ in range(B)])
    t = lambda a: torch.as_tensor(a, device=dev).to(dtype)  # noqa: E731
    return prob, params, t(base), t(drifts), t(prob.lb), t(prob.ub)


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
        same = (got[1] == want[1]).all(1) & (got[2] == want[2]).all(1) \
            & (got[3] == want[3]) & (got[4] == want[4]).all(1)
        err = max(float((got[0] - want[0]).abs().amax(dim=(1, 2))[same].max()),
                  float((got[5] - want[5]).abs().amax(1)[same].max()))
        ndiff = int((~same).sum())
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
        if dtype == torch.float32:  # the main path's dtype
            report["panel_factorize"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_fused(dev, report):
    """B2 against fused_active_set_ref on the bench problem, cold (step 0)
    and warm (step 1 from the kernel's step-0 result)."""
    from lexls_tpu_torch.lexlsi import Structure, active_set_kwargs
    from lexls_tpu_torch.ops import fused_active_set, fused_active_set_ref

    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        prob, params, base, drifts, lb, ub = _bench_problem(dtype, dev)
        struct = Structure.of(prob)
        kw = active_set_kwargs(struct, params, dev)
        lbs, ubs = lb.expand(B, -1).contiguous(), ub.expand(B, -1).contiguous()
        prev = None
        for step in (0, 1):
            A = (base + drifts[step]).contiguous()
            s = _phase1(A, lbs, ubs, struct, params, *(prev or (None, None)))
            args = (A, s.lb, s.ub, s.ctr_type, s.stamp, s.next_stamp, s.x, s.v, s.Ax, s.n_fact)
            got = fused_active_set(*args, **kw)
            want = fused_active_set_ref(*args, **kw)
            torch.cuda.synchronize()
            same_ws = (got.ctr_type == want.ctr_type).all(1)
            xerr = float((got.x - want.x).abs().amax(1)[same_ws].max())
            label = f"[B2 {name} {'cold' if step == 0 else 'warm'}]"
            print(f"{label} status(kernel) {torch.bincount(got.status + 1).tolist()} "
                  f"(-1,0,1,2 counts); iterations max {int(got.it.max())} mean "
                  f"{float(got.it.float().mean()):.3f}; working sets differing: "
                  f"{int((~same_ws).sum())}/{B}; max |x err| where equal: {xerr:.3e}")
            if dtype == torch.float64:
                ok = bool((got.status == want.status).all() and (got.it == want.it).all()
                          and same_ws.all() and (got.stamp == want.stamp).all()) and xerr <= 1e-8
            else:
                ok = bool((got.status == 0).all() and (want.status == 0).all()) and xerr <= 1e-3
            if not ok:
                raise SystemExit(f"{label} disagrees with its plain version")
            if step == 0:
                ms = _cuda_ms(lambda: fused_active_set(*args, **kw), 3)
                print(f"{label} kernel {ms:.4f} ms per call (B={B})")
            else:
                ms = _cuda_ms(lambda: fused_active_set(*args, **kw), 10)
                plain_ms = _cuda_ms(lambda: fused_active_set_ref(*args, **kw), 2)
                print(f"{label} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call (B={B})")
                if dtype == torch.float32:  # the main path's dtype
                    report["fused_active_set"].update(max_abs_err=xerr, ms=ms,
                                                      plain_ms=plain_ms)
            prev = (got.x, got.ctr_type)


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


def profile_sequence(run):
    """Device time per kernel over one T=T_MAX sequence (torch.profiler)
    and the share of it that B2 takes; busy share against the profiled
    host wall.  Prints 'not measured' when the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(T_MAX)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side rows only: a host op (aten::...) also carries the device
    # time of the kernels it launched, which would count them twice
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    total = sum(r[0] for r in rows) / 1e3
    if total == 0:
        print("[profile] the profiler shows no device time: device shares not measured")
        return
    b2 = sum(r[0] for r in rows if "fused_kernel" in r[2]) / 1e3  # csrc/fused.cu
    print(f"[profile] T={T_MAX} sequence, profiled host wall {wall_ms:.3f} ms; device time "
          f"{total:.3f} ms ({100 * total / wall_ms:.1f}% of the profiled wall); B2 "
          f"{b2:.3f} ms ({100 * b2 / total:.1f}% of device time); everything else "
          f"{total - b2:.3f} ms")
    for us, count, key in rows[:8]:
        print(f"  {us / 1e3:10.3f} ms  {count:6d} calls  {key[:90]}")


def run_main_path(dev, report):
    """The slice's main path at the bench shape, with launch counts."""
    from lexls_tpu_torch import Structure, solve_sequence_batched_fused
    from lexls_tpu_torch.ops import fused_active_set, panel_factorize

    prob, params, base, drifts, lb, ub = _bench_problem(torch.float32, dev)
    struct = Structure.of(prob)
    m = prob.n_ctr
    A_seq = base[:, None] + drifts[None]  # (B, T, m, n)
    lb_seq = lb.expand(B, T_MAX, m).contiguous()
    ub_seq = ub.expand(B, T_MAX, m).contiguous()
    reg = torch.as_tensor(prob.regularization, device=dev)

    def run(T):
        return solve_sequence_batched_fused(A_seq[:, :T], lb_seq[:, :T], ub_seq[:, :T], reg,
                                            struct=struct, params=params)

    panel_factorize.launches = fused_active_set.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, v, status, it, n_fact, ct = run(T_MAX)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"panel_factorize": panel_factorize.launches,
                "fused_active_set": fused_active_set.launches}
    print(f"[main path] B={B} T={T_MAX} float32: {wall:.3f} s host wall (first run); "
          f"launches {launches}; status counts {torch.bincount(status.flatten() + 1).tolist()} "
          f"(-1,0,1,2); warm iterations mean {float(it[:, 1:].float().mean()):.4f} max "
          f"{int(it[:, 1:].max())}; cold iterations mean {float(it[:, 0].float().mean()):.4f}")
    for k, c in launches.items():
        report[k]["launches"] = c
        if c == 0:
            raise SystemExit(f"main path did not launch {k}")
    if x.shape != (B, T_MAX, N_VAR) or not bool(torch.isfinite(x).all()) \
            or not bool(torch.isfinite(v).all()):
        raise SystemExit("main path: x/v not finite or of the wrong shape")
    if not bool((status == 0).all()):
        raise SystemExit("main path: not every solve is PROBLEM_SOLVED")

    # reference: the same sequence with the warm steps through the plain B2
    px, pstatus, pct = _plain_sequence(A_seq, lb_seq, ub_seq, struct, params)
    same = (pct == ct).all(2)
    xerr = float((px - x).abs().amax(2)[same].max())
    print(f"[main path] against plain warm steps: working sets differing "
          f"{int((~same).sum())}/{B * T_MAX}; max |x err| where equal {xerr:.3e}; "
          f"plain statuses solved {int((pstatus == 0).sum())}/{B * T_MAX}")
    if xerr > 1e-3 or not bool((pstatus == 0).all()):
        raise SystemExit("main path disagrees with its plain reference")

    lo, hi = TS
    times = _sequence_times(run, (1, lo, hi), REPS)
    steps, rates = _warm_rate(times, lo, hi)
    for T in (1, lo, hi):
        print(f"[main path] kernels, T={T} ms: {_spread(times[T])}")
    print(f"[main path] kernels, ms per warm step: {_spread(steps)}")
    print(f"[main path] kernels, warm solves/s over {REPS} rounds: {_spread(rates)}")
    times_p = _sequence_times(
        lambda T: _plain_sequence(A_seq[:, :T], lb_seq[:, :T], ub_seq[:, :T], struct, params),
        TS, 2)
    steps_p, rates_p = _warm_rate(times_p, lo, hi)
    print(f"[main path] plain B2 in warm steps, T={lo} ms: {_spread(times_p[lo])}; "
          f"T={hi} ms: {_spread(times_p[hi])}")
    print(f"[main path] plain B2 in warm steps, warm solves/s over 2 rounds: {_spread(rates_p)}")
    profile_sequence(run)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU",
              file=sys.stderr)
        return 2
    from lexls_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    try:
        import triton  # noqa: F401
        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
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
                                replaces="lexls_tpu/ops/pallas_lqr.py:238"),
        "fused_active_set": dict(name="fused_active_set", route="cuda",
                                 source="lexls_tpu_torch/csrc/fused.cu",
                                 replaces="lexls_tpu/ops/fused.py:966"),
    }
    check_panel(dev, report)
    check_fused(dev, report)
    run_main_path(dev, report)

    print(json.dumps({"kernels": list(report.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
