"""One run of one cell: set-up, the measured window, the traced readings
(``--trace 1``), the check against the reference, one JSON line.

Exit codes: 0 a result was printed; 2 the cell or the checkout is
incomplete; 3 no card, or fewer cards than the cell asks for; 4 a module
of JAX or of the JAX package was loaded; 5 a process the run started is
still running.  Only exit 0 prints a result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

from . import spec

REPO = spec.LEXBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lexls_tpu")


def boot_clock_since_start() -> float:
    """Seconds since this process started (``/proc``; 10 ms resolution)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(names=None) -> list:
    """The top-level names among ``names`` (default: ``sys.modules``) that
    are JAX's or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def live_children() -> list:
    """The command lines of this process's children that have not ended."""
    pids = []
    for task in Path("/proc/self/task").iterdir():
        pids += (task / "children").read_text().split()
    lines = []
    for pid in pids:
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_text().replace("\0", " ")
            lines.append(f"{pid}: {cmd}")
        except OSError:  # ended since
            pass
    return lines


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda", dtype=None,
             fault=None, clock=None) -> dict:
    """Set up, measure, read and check one run; return the result object
    (and, under ``_extra``, what a control or a test reads)."""
    import torch

    from . import check
    from . import trace as tr
    from .entries import ENTRIES

    clock = clock or time.perf_counter
    nvcc_s, t_lib = 0.0, time.perf_counter()
    before = clock()
    if torch.device(device).type == "cuda":
        from lexls_tpu_torch.ops import _build

        torch.cuda.init()
        nvcc_s = _build.build().seconds
        _build.library()
        torch.cuda.reset_peak_memory_stats()
    parts = {"process_start_to_harness": before, "cuda_and_library": time.perf_counter() - t_lib}
    entry = ENTRIES[cell.traffic["entry"]](cell, seed, device, dtype=dtype, fault=fault)
    entry.setup()
    parts.update(entry.setup_parts)
    prof = None
    if trace:
        warm, active = int(cell.traffic["trace_warmup_steps"]), int(cell.traffic["trace_steps"])
        prof = tr.Profiler(warm, active)
        prof.start()
    setup_s = clock()
    t0 = time.perf_counter()
    while True:
        profiled = prof is not None and prof.profiled()
        entry.step(traced=profiled and prof.traced(), profiled=profiled)
        if prof is not None:
            prof.step()
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    chrome = prof.stop() if prof is not None else None
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    attempted, failed = entry.outcome()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    if tf32 != bool(cell.config["tf32"]):
        raise RuntimeError(f"the port ran with TF32 products {'on' if tf32 else 'off'}; the "
                           f"configuration {cell.config['name']} states tf32={cell.config['tf32']}")
    entry.counters_after()
    e2e = entry.end_to_end(window_s)
    e2e["setup_s"] = setup_s
    samples = entry.sample()
    entry.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    readings = check.compare(samples, cell.config)
    limits = cell.traffic["check"]["limits"]
    compared = {"resid_gap": (readings["resid_gap"], limits["resid_gap"]),
                "failed": (failed, limits["failed"])}
    correct = all(v <= lim for v, lim in compared.values())
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed}
    if trace:
        t = tr.read(chrome, entry.dtype_name) if chrome else tr.Trace(dtype=entry.dtype_name)
        t.spans, t.counters = entry.spans, entry.counters
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(cell.root, m["name"])(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        busy = t.busy_us / 1e6
        result["_trace"] = {"busy_s": busy, "window_s": t.window_us / 1e6,
                            "breakdown": tr.breakdown(t), "steps": t.steps}
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["_extra"] = {"compared": compared, "readings": readings, "samples": samples,
                        "nvcc_s": nvcc_s, "peak": peak, "window_s": window_s,
                        "steps": len(entry.steps), "latency": entry.latency, "e2e": e2e,
                        "counters": entry.counters, "setup_parts": parts,
                        "issue": entry.spans.get("issue", [])}
    return result


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    bench_json = REPO / "BENCHMARK.json"
    try:
        cell = spec.load_cell(args.workload, bench_json)
    except (spec.SpecError, KeyError) as err:
        log(f"lexbench: {err}")
        return 2
    try:
        import lexls_tpu_torch
        import torch
    except ImportError as err:
        log(f"lexbench: the port does not import here ({err}): run from a checkout of the repo")
        return 2
    if REPO not in Path(lexls_tpu_torch.__file__).resolve().parents:
        log(f"lexbench: the port was imported from {lexls_tpu_torch.__file__}, not from the "
            f"checkout at {REPO}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"lexbench: cell {cell.name} needs {cell.chips} CUDA device(s), this machine has {n}")
        return 3
    torch.set_num_threads(1)
    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       clock=boot_clock_since_start)
    except Exception:
        import traceback

        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"lexbench: modules of JAX or of the JAX package were loaded: {bad}")
        return 4
    left = live_children()
    if left:
        log(f"lexbench: processes this run started are still running: {left}")
        return 5
    extra, tinfo = res.pop("_extra"), res.pop("_trace", None)
    card = power_limit()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(extra["peak"])}
    if tinfo is not None:
        device.update(busy_s=tinfo["busy_s"], window_s=tinfo["window_s"])
        res["breakdown"] = tinfo["breakdown"]
    res["device"] = device
    lat = extra["latency"]
    fifths = [lat[i * len(lat) // 5:(i + 1) * len(lat) // 5] for i in range(5)]
    log("lexbench: steps per second in each fifth of the window: "
        + ", ".join(f"{len(f) / sum(f):.3f}" for f in fifths if f))
    log(f"lexbench: cell {cell.name} seed {args.seed} trace {args.trace}: card {card}; "
        f"nvcc {extra['nvcc_s']:.3f} s; window {extra['window_s']:.6f} s, {extra['steps']} "
        f"steps, {res['attempted']} solves, {res['failed']} failed; step latency over "
        f"{len(lat)} steps: median {1e3 * sorted(lat)[len(lat) // 2]:.6f} ms")
    log(f"lexbench: end to end {json.dumps(extra['e2e'])}")
    log(f"lexbench: set-up parts, s {json.dumps(extra['setup_parts'])}")
    issue = sorted(extra["issue"])
    if issue:
        log(f"lexbench: host issue spans over {len(issue)} untraced steps: median "
            f"{1e3 * issue[len(issue) // 2]:.6f} ms, mean {1e3 * sum(issue) / len(issue):.6f} ms, "
            f"max {1e3 * issue[-1]:.6f} ms")
    log(f"lexbench: counters {json.dumps(extra['counters'])}")
    if tinfo is not None:
        log(f"lexbench: traced {tinfo['steps']} steps, busy {tinfo['busy_s']:.6f} s of "
            f"{tinfo['window_s']:.6f} s; breakdown {json.dumps(tinfo['breakdown'])}")
    r = extra["readings"]
    log(f"lexbench: reference checked {r['checked']} answers ({r['reference_unsolved']} "
        f"left unsolved by the reference); gaps {[f'{g:.6e}' for g in r['gaps']]}")
    check = {}
    for name, (value, limit) in extra["compared"].items():
        value = value if math.isfinite(value) else str(value)
        check[name] = {"value": value, "limit": limit}
        log(f"check {name} {value} limit {limit}")
    res["check"] = check
    print(json.dumps(res), flush=True)
    return 0
