"""Share of the traced window, %, in which no operation ran on the device
(the union of the trace's kernel, copy and memset intervals)."""

from lexbench.harness.trace import idle_pct as read  # noqa: F401
