"""The readers of the port's own spans and gauges on a tiny traced cell of
each entry, on the CPU: the host spans give positive numbers on the warm
entry, read over the profiler's recorded steps alone; what only a launch
on the card records is left out of the line."""

import pytest

from lexbench.harness.cli import run_cell


@pytest.mark.parametrize("entry", ["warm_fused", "cold_fused"])
def test_the_span_readers_on_a_tiny_traced_cell(tiny, entry):
    from lexls_tpu_torch import tracing

    cell = tiny(entry)
    tracing.reset()
    res = run_cell(cell, 2 ** 31 + 23, 2.0, True, device="cpu")
    roots = [s for s in tracing.snapshot().spans
             if s.name == "lexls.solve_core_fused" and s.parent is None]
    assert len(roots) == res["_trace"]["steps"] >= 1  # the recorded steps, no others
    names = [m["name"] for m in cell.per_layer]
    metrics = res["metrics"]
    if entry == "warm_fused":
        for name in ("phase1_host_ms.warm", "b2_wrapper_host_ms.warm"):
            assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms"
        assert "launch_host_ms.warm" in names and "launch_host_ms.warm" not in metrics
    else:  # no launch on the CPU, so no gauge
        assert "b2_blocks_per_sm.cold" in names and "b2_blocks_per_sm.cold" not in metrics
