"""The traced run: ``torch.profiler`` over a few steps of the window, its
chrome trace read back into device intervals, launches and host activity.

Kernels are attributed to the benchmark's ``lexbench.*`` annotation that
was open on the host when their launch was issued (by the launch's
correlation id), so the harness's own launches (forming a step's input)
are told from the program's.  The traced window runs from the first traced
step's start to the last one's end; a device operation (kernel, copy or
memset) makes the device busy, and the union of their intervals inside the
window is ``busy``.  Idle time is named by what the host was doing in the
middle of each gap: the innermost ``lexbench.*`` annotation and the
innermost host operator open there.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIX = "cuda_"  # the CUDA runtime and its lower API: launches carry a correlation id


@dataclass
class Trace:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    dtype: str
    kernels: List[Tuple[str, float, float, str]] = field(default_factory=list)
    # (name, start us, end us, annotation open at launch), inside the window
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)      # us, the profiler's clock
    steps: int = 0                                 # steps inside the traced window
    busy_us: float = 0.0
    idle_by_host: Dict[str, float] = field(default_factory=dict)  # us
    spans: Dict[str, List[float]] = field(default_factory=dict)   # s, profiler off
    counters: Dict[str, float] = field(default_factory=dict)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernels_named(self, part: str):
        return [k for k in self.kernels if part in k[0]]

    def program_kernels(self):
        return [k for k in self.kernels if k[3] == "lexbench.program"]


class Profiler:
    """``torch.profiler`` with a schedule: ``warmup`` steps with the
    profiler on, then ``active`` steps recorded; ``step()`` after every step
    of the window.  The trace goes to a temporary file in ``TMPDIR``."""

    def __init__(self, warmup: int, active: int):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.warmup, self.active = warmup, active
        fd, self.path = tempfile.mkstemp(prefix="lexbench-trace-", suffix=".json")
        os.close(fd)
        self.done = False

        def ready(prof):
            prof.export_chrome_trace(self.path)
            self.done = True

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=warmup, active=active, repeat=1),
                            on_trace_ready=ready)
        self.n = 0

    def start(self):
        self.prof.__enter__()

    def profiled(self) -> bool:
        """Whether the next step runs with the profiler on."""
        return self.n < self.warmup + self.active

    def traced(self) -> bool:
        """Whether the next step is recorded."""
        return self.warmup <= self.n < self.warmup + self.active

    def step(self):
        self.n += 1
        if self.n <= self.warmup + self.active:
            self.prof.step()

    def stop(self) -> Optional[dict]:
        self.prof.__exit__(None, None, None)
        try:
            if not self.done:
                return None
            with open(self.path) as fh:
                return json.load(fh)
        finally:
            os.unlink(self.path)


def _union(intervals, lo, hi):
    """Total length of the union of (start, end) intervals clipped to [lo, hi],
    and the gaps between them inside [lo, hi]."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
        busy += e - max(s, cur)
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def _innermost(intervals, points):
    """For each point, the name of the innermost interval of ``intervals``
    (name, start, end; properly nested, as one thread's are) that holds it."""
    ivs = sorted(intervals, key=lambda iv: (iv[1], -iv[2]))
    order = sorted(range(len(points)), key=lambda i: points[i])
    out: List[Optional[str]] = [None] * len(points)
    stack, j = [], 0
    for i in order:
        p = points[i]
        while j < len(ivs) and ivs[j][1] <= p:
            while stack and stack[-1][2] < ivs[j][1]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def read(chrome: dict, dtype: str) -> Trace:
    """A :class:`Trace` from a chrome trace of the recorded steps."""
    events = chrome["traceEvents"] if isinstance(chrome, dict) else chrome
    launch_ts, ops, steps, annots, cpu_ops = {}, [], [], [], []
    kernels_raw = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append((e["name"], ts, ts + dur))
            if cat == "kernel":
                kernels_raw.append((e["name"], ts, ts + dur, args.get("correlation")))
        elif cat.startswith(LAUNCH_PREFIX) and "correlation" in args:
            launch_ts[args["correlation"]] = ts
        elif cat == "user_annotation" and e["name"].startswith("lexbench."):
            annots.append((e["name"], ts, ts + dur, e.get("tid")))
            if e["name"] == "lexbench.step":
                steps.append((ts, ts + dur))
        elif cat == "cpu_op":
            cpu_ops.append((e["name"], ts, ts + dur, e.get("tid")))
    t = Trace(dtype=dtype)
    if not steps:
        return t
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    t.window, t.steps = (lo, hi), len(steps)
    tid = annots[0][3]
    annots = [a[:3] for a in annots if a[3] == tid]
    cpu_ops = [c[:3] for c in cpu_ops if c[3] == tid]
    launches = [launch_ts.get(corr, s) for _, s, _, corr in kernels_raw]
    labels = _innermost(annots, launches)
    t.kernels = [(n, s, e, lab or "") for (n, s, e, _), lab in zip(kernels_raw, labels)
                 if lo <= s < hi]
    t.device_ops = [op for op in ops if lo <= op[1] < hi]
    t.busy_us, gaps = _union([(s, e) for _, s, e in t.device_ops], lo, hi)
    mids = [(a + b) / 2 for a, b in gaps]
    where = _innermost(annots, mids)
    what = _innermost(cpu_ops, mids)
    idle = defaultdict(float)
    for (a, b), w, op in zip(gaps, where, what):
        idle[f"{w or 'outside lexbench'} / {op or 'no host operator'}"] += b - a
    t.idle_by_host = dict(idle)
    return t


def breakdown(t: Trace) -> dict:
    """The ten device operations that took most time and the ten host
    activities under which the device sat idle longest, in seconds."""
    by_op = defaultdict(float)
    for name, s, e in t.device_ops:
        by_op[name] += e - s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(t.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], v / 1e6] for n, v in top],
            "idle_gaps": [[n[:160], v / 1e6] for n, v in gaps]}


def idle_pct(t: Trace) -> Optional[float]:
    """The share of the traced window in which no device operation ran."""
    if t.steps == 0 or t.window_us <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)

