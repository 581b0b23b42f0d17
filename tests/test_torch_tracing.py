"""The port's tracing (``lexls_tpu_torch/tracing.py``): nothing recorded
when off; the span tree of a warm and a cold ``solve_core_fused``; only a
profiler's active steps recorded; the profiler's ``lexls.*`` events inside
the in-memory spans on one clock; the cap.  On the card: the launch
counters, B2's blocks-per-SM gauge and the CUDA events around launches.

This file imports no JAX, so its CUDA tests also run on a machine with a
GPU and no JAX.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

import lexls_tpu_torch as lt
from lexls_tpu_torch import tracing
from lexls_tpu_torch.oracle import random_inequality_hierarchy
from lexls_tpu_torch.sequence import _device_initial_activation
from torch_parity import cuda_device  # noqa: F401

torch.set_num_threads(1)

SOLVE = "lexls.solve_core_fused"


def _stepper(device, dtype=torch.float64, B=4):
    """``step(state)``: phase 1's activation and ``solve_core_fused`` on a
    small hierarchy, cold when ``state`` is None, else warm from it."""
    rng = np.random.default_rng(3)
    prob = random_inequality_hierarchy(rng, 8, [3, 3, 3], equality_fraction=0.1,
                                       tight_fraction=0.4)
    struct = lt.Structure.of(prob)
    params = lt.ParametersLexLSI(max_number_of_factorizations=50)
    t = lambda a: torch.as_tensor(a, device=device).to(dtype)  # noqa: E731
    A = t(prob.A + 1e-3 * rng.standard_normal((B,) + prob.A.shape))
    lb, ub = t(np.tile(prob.lb, (B, 1))), t(np.tile(prob.ub, (B, 1)))
    x0, v0 = torch.zeros_like(A[:, 0]), torch.zeros_like(lb)
    ct0 = torch.zeros(lb.shape, dtype=torch.int32, device=device)

    def step(state=None):
        c, s, ns = _device_initial_activation(A, lb, ub, ct0 if state is None else state.ctr_type,
                                              struct)
        return lt.solve_core_fused(A, lb, ub, c, s, ns, x0 if state is None else state.x, v0,
                                   None, struct=struct, params=params,
                                   x_guess_specified=state is not None, v0_specified=False)

    return step


def _duration(s):
    return s.end_ns - s.start_ns


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    yield
    tracing.reset()


def test_nothing_is_recorded_when_off():
    step = _stepper("cpu")
    step(step())
    tracing.count("launches.x")
    tracing.gauge("b2.blocks_per_sm", 3)
    assert not tracing.enabled()
    null = tracing.span("lexls.b2")  # one shared null context, no span object
    assert tracing.span("lexls.activation") is null and tracing.device_interval("x") is null
    assert tracing.snapshot() == ([], {}, {}, [])


def test_a_cold_and_a_warm_step_give_the_span_tree():
    step = _stepper("cpu")
    with tracing.recording():
        state = step()
        step(state)
    spans = tracing.snapshot().spans
    by_id = {s.id: s for s in spans}
    roots = sorted((s for s in spans if s.parent is None), key=lambda s: s.start_ns)
    assert [r.name for r in roots] == ["lexls.activation", SOLVE] * 2
    for solve, phase1 in zip(roots[1::2], ("lexls.phase1.cold", "lexls.phase1.warm")):
        kids = sorted((s for s in spans if s.parent == solve.id), key=lambda s: s.start_ns)
        assert [k.name for k in kids] == [phase1, "lexls.b2"]  # no launch on the CPU
        assert all(k.root == solve.id == solve.root for k in kids)
        assert solve.start_ns <= kids[0].start_ns <= kids[0].end_ns <= kids[1].start_ns
        assert kids[1].end_ns <= solve.end_ns
    for s in spans:
        assert s.root == (s.id if s.parent is None else by_id[s.parent].root)
    solves = [r for r in roots if r.name == SOLVE]
    children = sum(_duration(s) for s in spans if s.parent in {r.id for r in solves})
    assert tracing.self_ns(SOLVE) == sum(map(_duration, solves)) - children > 0
    assert tracing.self_ns("lexls.b2") == sum(_duration(s) for s in spans if s.name == "lexls.b2")


def test_a_profiler_records_only_its_active_steps(tmp_path):
    step = _stepper("cpu")
    state = step()
    path = tmp_path / "trace.json"
    on = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=2, active=3, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(6):
            on.append(tracing.enabled())
            state = step(state)
            prof.step()
    assert on == [False, False, True, True, True, False]
    spans = tracing.snapshot().spans
    assert sum(s.name == SOLVE and s.parent is None for s in spans) == 3

    # each lexls.* event of the trace is a cpu_op inside its span, on one clock
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    events = [e for e in trace["traceEvents"] if str(e.get("name", "")).startswith("lexls.")]
    assert {e["cat"] for e in events} == {"cpu_op"}
    assert sorted(e["name"] for e in events) == sorted(s.name for s in spans)
    for name in {s.name for s in spans}:
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in events if e["name"] == name), key=lambda e: e["ts"])
        for s, e in zip(mine, theirs):
            start = e["ts"] * 1e3 + base
            end = start + e["dur"] * 1e3
            assert s.start_ns - 50_000 <= start <= end <= s.end_ns + 50_000, (name, s, e)


def test_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with tracing.recording():
        for _ in range(5):
            with tracing.span("lexls.b2"):
                pass
        tracing.count("launches.x", 2)
        tracing.gauge("b2.blocks_per_sm", 3)
    snap = tracing.snapshot()
    assert len(snap.spans) == 3
    assert snap.counters == {"tracing.dropped": 2, "launches.x": 2}
    assert snap.gauges == {"b2.blocks_per_sm": 3}
    tracing.reset()
    assert tracing.snapshot() == ([], {}, {}, [])


def test_recording_nests_and_ends_on_an_error():
    with pytest.raises(RuntimeError):
        with tracing.recording():
            with tracing.recording(device_events=True):
                assert tracing.enabled()
            assert tracing.enabled()
            with tracing.span("lexls.b2"):
                raise RuntimeError("inside a span")
    assert not tracing.enabled()
    (s,) = tracing.snapshot().spans
    assert s.name == "lexls.b2" and s.parent is None
    with tracing.recording():
        with tracing.span("lexls.solve_core_fused"):
            pass
    assert tracing.snapshot().spans[-1].parent is None  # the stack was left empty


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_launches_the_gauge_and_device_events_on_the_card(cuda_device, dtype):  # noqa: F811
    from lexls_tpu_torch.ops.fused import _blocks_per_sm, fused_layout

    step = _stepper(cuda_device, dtype)
    state = step()  # builds the kernels outside the recording
    torch.cuda.synchronize()
    tracing.reset()
    with tracing.recording(device_events=True):
        step()
        step(state)
        torch.cuda.synchronize()
    snap = tracing.snapshot()
    suffix = "f64" if dtype == torch.float64 else "f32"
    p = 3
    assert snap.counters == {f"launches.lexls_panel_factorize_{suffix}": p,
                             f"launches.lexls_fused_active_set_{suffix}": 2,
                             f"launches.lexls_activation_{suffix}": 2,
                             f"launches.lexls_phase1_warm_{suffix}": 1}
    lay = fused_layout(9, 8, p, 0, 3, dtype)
    assert snap.gauges == {"b2.blocks_per_sm": _blocks_per_sm(lay, dtype)} and \
        snap.gauges["b2.blocks_per_sm"] >= 1
    assert [e[0] for e in snap.device_events] == (
        [f"lexls_activation_{suffix}"] + [f"lexls_panel_factorize_{suffix}"] * p
        + [f"lexls_fused_active_set_{suffix}", f"lexls_activation_{suffix}",
           f"lexls_phase1_warm_{suffix}", f"lexls_fused_active_set_{suffix}"])
    assert all(s.elapsed_time(e) > 0 for _, s, e in snap.device_events)
    launches = [s for s in snap.spans if s.name == "lexls.launch"]
    by_id = {s.id: s for s in snap.spans}
    assert len(launches) == p + 5
    assert sorted(by_id[s.parent].name for s in launches) == (
        ["lexls.activation"] * 2 + ["lexls.b2"] * 2 + ["lexls.phase1.cold"] * p
        + ["lexls.phase1.warm"])
