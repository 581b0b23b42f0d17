"""Host time to issue one warm step, ms: from the step's first call into
the port (phase 1's activation) to the return of ``solve_core_fused``,
before the synchronize.  The mean over the window's steps that ran with
the profiler off (the benchmark's own span, host clock)."""


def read(t):
    spans = t.spans.get("issue")
    return 1e3 * sum(spans) / len(spans) if spans else None
