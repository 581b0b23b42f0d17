"""The port's entry points as a cell drives them, one class per ``entry``
of a traffic file.  Each builds its inputs and state in ``setup``, then
solves one closed-loop step per ``step`` call (it returns once the answer
is on the host or synchronized), and afterwards hands over the end-to-end
numbers, the counters its per-layer readers take, and a sample of its
answers for the check.

A step keeps references to the answers it produced (no copy, no launch):
a sample drawn from the seed for the check, and the last few steps'
until they are tallied (status and finiteness) in one pass.
Spans are host times (``time.perf_counter``) that the benchmark takes
around its calls into the port, kept only for steps that ran with the
profiler off; ``lexbench.*`` annotations mark the same calls in a trace.
A step is ``traced`` when the profiler records it.
"""

from __future__ import annotations

import contextlib
import math
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import traffic as tr
from . import work

FLUSH = 64          # window steps whose answers are tallied in one pass


def _annotate(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Entry:
    """What every entry shares: the cell, the seed, the device, the records."""

    def __init__(self, cell, seed: int, device, dtype: Optional[str] = None, fault=None):
        from lexls_tpu_torch import ParametersLexLSI

        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.dtype_name = dtype or cell.config["dtype"]
        self.dtype = tr.DTYPES[self.dtype_name]
        self.traffic = cell.traffic
        self.params = ParametersLexLSI(**cell.config["params"])
        self.k = int(cell.traffic["check"]["sample"])  # answers the check samples
        self.fault = fault            # a test's stand-in for a broken timed path
        self.t = 0                    # the ring position of the last step (set-up sets it)
        self.steps: List[int] = []    # ring positions of the window's steps
        self.latency: List[float] = []
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}
        self.setup_parts: Dict[str, float] = {}  # s, for the log
        self._mark = time.perf_counter()

    def part(self, name: str):
        """Close the set-up phase ``name`` (after a synchronize)."""
        self.sync()
        now = time.perf_counter()
        self.setup_parts[name] = now - self._mark
        self._mark = now

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def batch(self) -> int:
        return int(self.traffic["batch"])

    def warm_up(self):
        """``warmup_steps`` steps as the window runs them, then their
        records are dropped."""
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step(traced=False, profiled=False)
        self._reset_records()
        self.part("warm_up")

    def span(self, name: str, seconds: float, profiled: bool):
        if not profiled:
            self.spans.setdefault(name, []).append(seconds)

    def counters_after(self):
        """Counters that need the whole window (default: none)."""

    def _reset_records(self):
        raise NotImplementedError

    def _reset_sample(self):
        self.slots: List[tuple] = []  # (step in the window, instance, that step's answers)
        self.rng = random.Random(self.seed)
        self._w = math.exp(math.log(self.rng.random()) / self.k)
        self._next = self.k + self._skip()

    def _skip(self) -> int:
        return int(math.log(self.rng.random()) / math.log(1.0 - self._w))

    def _sample(self, x):
        """Let the answers ``x`` of the latest step (``batch`` of them) enter
        a uniform sample of ``k`` of all the window's answers, drawn from the
        seed: reservoir sampling by skips (Li's algorithm L), keeping a
        reference to the step's answers, no copy."""
        i, B = len(self.steps) - 1, self.batch()
        first = i * B                      # index of this step's first answer
        while len(self.slots) < min(self.k, first + B):  # the window's first k answers
            self.slots.append((i, len(self.slots) - first, x))
        while self._next < first + B:
            self.slots[self.rng.randrange(self.k)] = (i, self._next - first, x)
            self._w *= math.exp(math.log(self.rng.random()) / self.k)
            self._next += self._skip() + 1


class _Fused(Entry):
    """The whole-solve tier's entries: inputs and state on the device."""

    def _prepare(self):
        import lexls_tpu_torch as lt
        from lexls_tpu_torch.sequence import _device_initial_activation

        self._act = _device_initial_activation
        self._solve = lt.solve_core_fused
        self.inp = tr.make_inputs(self.cell.config, self.traffic, self.seed, self.dtype,
                                  self.device)
        raw = self.inp.raw
        self.struct = lt.Structure(dims=raw.dims, n_var=raw.A.shape[1],
                                   simple_bounds=raw.var_idx is not None,
                                   var_idx=None if raw.var_idx is None
                                   else tuple(int(i) for i in raw.var_idx))
        B, m, n = self.inp.base.shape
        self.lbs = self.inp.lb.expand(B, m).contiguous()  # B2 takes bounds per instance
        self.ubs = self.inp.ub.expand(B, m).contiguous()
        self.v0 = torch.zeros(B, m, dtype=self.dtype, device=self.device)
        self.x0 = torch.zeros(B, n, dtype=self.dtype, device=self.device)
        self.ct0 = torch.zeros(B, m, dtype=torch.int32, device=self.device)
        self.reg = torch.zeros(len(raw.dims), dtype=self.dtype, device=self.device)
        self._reset_records()
        self.part("inputs")

    def _reset_records(self):
        """Forget what the set-up's steps recorded."""
        self.steps, self.latency, self.spans = [], [], {}
        self.pending: List[tuple] = []
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        self.tally = {"bad": zero.clone(), "iters": zero.clone(), "solves": 0}
        self._reset_sample()

    def _keep(self, st):
        """Record a window's step: its answers enter the sample, and every
        ``FLUSH`` steps the pending statuses and answers are tallied on the
        device in one pass, so that the answers kept stay bounded."""
        self._sample(st.x)
        self.pending.append((st.status, st.x, st.it))
        if len(self.pending) >= FLUSH:
            self._flush()

    def _flush(self):
        if not self.pending:
            return
        status, x, it = (torch.stack(p) for p in zip(*self.pending))
        self.tally["bad"] += ((status != 0) | ~torch.isfinite(x).all(-1)).sum()
        self.tally["iters"] += it.sum(dtype=torch.int64)
        self.tally["solves"] += status.numel()
        self.pending = []

    def _call(self, A, ctr_type, x, warm: bool, factors: bool = False):
        c, s, ns = self._act(A, self.lbs, self.ubs, ctr_type, self.struct)
        return self._solve(A, self.lbs, self.ubs, c, s, ns, x, self.v0, self.reg,
                           struct=self.struct, params=self.params, x_guess_specified=warm,
                           v0_specified=False, return_factors=factors)

    def outcome(self):
        """(attempted, failed) over the window: every solve, and those that
        ended in another status than ``PROBLEM_SOLVED`` or with a non-finite x."""
        self._flush()
        return self.tally["solves"], int(self.tally["bad"])

    def sample(self):
        """(A, lb, ub, x) of the sampled answers, in float64, A and the
        bounds as the program got them."""
        lb, ub = (a.double().cpu().numpy() for a in (self.inp.lb, self.inp.ub))
        return [(self.inp.instance(self.steps[i], b), lb, ub, x[b].double().cpu().numpy())
                for i, b, x in sorted(self.slots, key=lambda s: s[:2])]

    def free(self):
        self.__dict__.pop("state", None)


class WarmFused(_Fused):
    """Controllers stepping together through the whole-solve tier: per
    step phase 1's activation from the last working set
    (``sequence._device_initial_activation``), ``solve_core_fused``
    hot-started from the last x, then a synchronize.  The cold solve that
    gives the first state, and ``warmup_steps`` steps, are set-up."""

    def setup(self):
        self._prepare()
        self.t = self.inp.phase
        self.state = self._call(self.inp.A(self.t), self.ct0, self.x0, warm=False)
        self.part("initial_cold_solve")
        self.warm_up()

    def step(self, traced: bool, profiled: bool) -> None:
        self.t += 1
        with _annotate(profiled, "lexbench.step"):
            with _annotate(profiled, "lexbench.input"):
                A = self.inp.A(self.t)
            t0 = time.perf_counter()
            with _annotate(profiled, "lexbench.program"):
                st = self._call(A, self.state.ctr_type, self.state.x, warm=True)
                if self.fault is not None:
                    st = self.fault(self, st)
            t1 = time.perf_counter()
            with _annotate(profiled, "lexbench.sync"):
                self.sync()
            t2 = time.perf_counter()
        self.state = st
        self.steps.append(self.t)
        self.latency.append(t2 - t0)
        self.span("issue", t1 - t0, profiled)
        self._keep(st)

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"warm_solves_per_s": self.batch() * len(self.steps) / window_s,
                "warm_step_ms_p95": float(np.percentile(np.array(self.latency) * 1e3, 95))}


class ColdFused(_Fused):
    """A fleet's batch solved cold through ``solve_core_fused`` from the
    cold activation, one call at a time, synchronized, each call at the
    next drift of the ring.  ``warmup_steps`` calls are set-up."""

    def setup(self):
        self._prepare()
        self.t = self.inp.phase - 1
        self.warm_up()
        self.t = self.inp.phase - 1  # the window's first call is at the run's phase

    def step(self, traced: bool, profiled: bool) -> None:
        self.t += 1
        with _annotate(profiled, "lexbench.step"):
            with _annotate(profiled, "lexbench.input"):
                A = self.inp.A(self.t)
            t0 = time.perf_counter()
            with _annotate(profiled, "lexbench.program"):
                st, factors = self._call(A, self.ct0, self.x0, warm=False, factors=True)
                if self.fault is not None:
                    st = self.fault(self, st)
            t1 = time.perf_counter()
            with _annotate(profiled, "lexbench.sync"):
                self.sync()
            t2 = time.perf_counter()
        self.steps.append(self.t)
        self.latency.append(t2 - t0)
        self.span("issue", t1 - t0, profiled)
        self._keep(st)
        if traced:
            self._count_b2(A, st, factors)

    def _count_b2(self, A, st, factors):
        """Kernel B2's operations and bytes in one traced call: every input
        and output once, and the operations at each instance's final ranks."""
        B, m, n = A.shape
        ranks = factors[2]
        flops = work.active_set_flops(ranks.cpu().numpy(), st.it.cpu().numpy(),
                                      st.n_act.cpu().numpy(), self.struct.lexlse_dims, n, m)
        ins = (A, self.lbs, self.ubs, self.ct0, self.ct0, self.x0, self.v0, self.v0)
        outs = [getattr(st, f) for f in ("x", "v", "dx", "dv", "Ax", "Adx", "ctr_type", "stamp",
                                          "next_stamp", "it", "n_act", "n_deact", "n_fact",
                                          "status")] + list(factors)
        nbytes = float(sum(t.numel() * t.element_size() for t in (*ins, *outs)))
        self.counters["b2_flops"] = self.counters.get("b2_flops", 0.0) + flops
        self.counters["b2_bytes"] = self.counters.get("b2_bytes", 0.0) + nbytes

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"cold_solves_per_s": self.batch() * len(self.steps) / window_s}

    def counters_after(self):
        self._flush()
        self.counters["iters_sum"] = float(self.tally["iters"])
        self.counters["solves"] = float(self.tally["solves"])


ENTRIES = {"warm_fused": WarmFused, "cold_fused": ColdFused}
