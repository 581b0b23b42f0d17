"""Spans, counters and gauges inside the port, for whoever runs the library
and wants to see where a call spends its host time.

Tracing is on while a ``torch.profiler`` records, or inside
:func:`recording`.  Off, a span site costs one module-flag check and one
``torch.autograd._profiler_enabled()`` check, and records nothing.  On,
each span is kept in memory as a :class:`Span`, stamped with
``time.time_ns()``, the clock of the profiler's trace (an event's ``ts`` in
microseconds plus the trace's ``baseTimeNanoseconds``); while a profiler
records, the span is also a ``cpu_op`` event of its trace, so a
``torch.profiler`` timeline shows the port's spans beside the aten
operators and the kernels they launch.

The spans of a warm or cold step of the whole-solve tier:

``lexls.activation``
    phase 1's batched working-set activation
    (``sequence._device_initial_activation``, the launch of its kernel on
    the card), a root of its own;
``lexls.solve_core_fused``
    the whole call of ``lexlsi.solve_core_fused``, a root;
``lexls.phase1.warm`` / ``lexls.phase1.cold``
    phase 1 (``lexlsi._initial_state``) with and without an x guess; the
    warm one holds the hot start's launch, the cold one kernel B1's
    factorization and its launches;
``lexls.b2``
    kernel B2's wrapper as ``lexlsi._fused_tail`` calls it: argument
    checks, cached tables, the layout, the outputs, the launch;
``lexls.launch``
    the C entry of a kernel (B1, B2 and phase 1's two): ctypes argument
    arrays, the launch itself.

Counters and gauges: ``launches.<C entry>`` counts each kernel's launches;
for B2's last launch, the gauge ``b2.blocks_per_sm`` is the card's resident
blocks per SM, ``b2.waves`` the rounds of resident blocks its batch takes
over the card's SMs, and ``b2.smem_bytes`` the shared memory a block asks
for; ``tracing.dropped`` counts spans past :data:`CAP`.
Under ``recording(device_events=True)`` every launch is also bracketed by
CUDA events on the current stream, which :func:`snapshot` returns as
``(entry, start, end)``: the kernel's own device time, apart from its
wrapper's.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

CAP = 1_000_000  # spans kept; later ones are counted in ``tracing.dropped``


class Span(NamedTuple):
    """One span: ``parent`` is the ``id`` of the enclosing span of the same
    thread (None for a root) and ``root`` the ``id`` of the top-level span
    of the call, shared by every span under it."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    root: int
    id: int


class Snapshot(NamedTuple):
    """What :func:`snapshot` returns: spans in the order they ended."""

    spans: List[Span]
    counters: Dict[str, int]
    gauges: Dict[str, float]
    device_events: List[tuple]  # (C entry, start event, end event)


_profiler_enabled = torch.autograd._profiler_enabled
# a span's event in the profiler's trace: the fast C++ record function, where
# this torch has it (a ``cpu_op`` event), else the Python one
_emit = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)
_OFF = contextlib.nullcontext()

_on = 0            # depth of open ``recording()`` blocks
_device_on = 0     # of them, those that asked for device events
_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()
_spans: List[tuple] = []  # the fields of a Span
_counters: Dict[str, int] = {}
_gauges: Dict[str, float] = {}
_device_events: List[tuple] = []


def enabled() -> bool:
    """Whether tracing is on: inside :func:`recording`, or while a
    ``torch.profiler`` records."""
    return bool(_on) or _profiler_enabled()


@contextlib.contextmanager
def recording(device_events: bool = False):
    """Record spans, counters and gauges inside the block without a
    profiler (blocks nest); with ``device_events`` also bracket every kernel
    launch with CUDA events."""
    global _on, _device_on
    with _lock:
        _on += 1
        _device_on += bool(device_events)
    try:
        yield
    finally:
        with _lock:
            _on -= 1
            _device_on -= bool(device_events)


class _Span:
    __slots__ = ("name", "parent", "root", "id", "start", "event")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent, self.root = stack[-1] if stack else (None, self.id)
        stack.append((self.id, self.root))
        self.start = time.time_ns()
        self.event = _emit(self.name) if _profiler_enabled() else None
        if self.event is not None:
            self.event.__enter__()
        return self

    def __exit__(self, *exc):
        if self.event is not None:
            self.event.__exit__(*exc)
        end = time.time_ns()
        _local.stack.pop()
        if len(_spans) < CAP:  # a list append is atomic; a race overshoots by a few
            _spans.append((self.name, self.start, end, self.parent, self.root, self.id))
        else:
            with _lock:
                _counters["tracing.dropped"] = _counters.get("tracing.dropped", 0) + 1
        return False


def _stack() -> list:
    """This thread's open spans, innermost last, as (id, root)."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str):
    """A context manager that records the block as the span ``name`` when
    tracing is on, and does nothing (a shared null context) when it is off."""
    if not _on and not _profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` when tracing is on."""
    if _on or _profiler_enabled():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Set the gauge ``name`` when tracing is on."""
    if _on or _profiler_enabled():
        _gauges[name] = value


class _DeviceInterval:
    __slots__ = ("name", "start", "end")

    def __init__(self, name: str):
        self.name = name
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        with _lock:
            _device_events.append((self.name, self.start, self.end))
        return False


def device_interval(name: str):
    """Inside ``recording(device_events=True)``, bracket the block with CUDA
    events on the current stream, kept as ``(name, start, end)``; otherwise
    a null context."""
    return _DeviceInterval(name) if _device_on else _OFF


def snapshot() -> Snapshot:
    """A copy of everything recorded since the last :func:`reset`."""
    with _lock:
        spans = list(_spans)
        counters, gauges, events = dict(_counters), dict(_gauges), list(_device_events)
    return Snapshot([Span._make(s) for s in spans], counters, gauges, events)


def self_ns(name: str) -> int:
    """The summed self time of the spans ``name``, ns: each one's duration
    less that of its child spans."""
    spans = snapshot().spans
    children = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            children[s.parent] += s.end_ns - s.start_ns
    return sum(s.end_ns - s.start_ns - children[s.id] for s in spans if s.name == name)


def reset() -> None:
    """Forget every span, counter, gauge and device event recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _gauges.clear()
        _device_events.clear()
