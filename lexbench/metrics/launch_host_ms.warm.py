"""Host time of B2's C entry per traced warm step, ms: the port's spans
``lexls.launch`` (ctypes arguments and the launch) whose parent is the span
``lexls.b2``, summed over the steps the profiler recorded
(``lexls_tpu_torch.tracing``, on while it records) and divided by the
``lexls.solve_core_fused`` calls among them.  None where nothing was
launched (the CPU) or the port records no spans."""


def read(t):
    try:
        from lexls_tpu_torch import tracing
    except ImportError:  # a port without spans
        return None
    spans = tracing.snapshot().spans
    steps = sum(s.name == "lexls.solve_core_fused" and s.parent is None for s in spans)
    b2 = {s.id for s in spans if s.name == "lexls.b2"}
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name == "lexls.launch" and s.parent in b2)
    return ns / 1e6 / steps if steps and ns else None
