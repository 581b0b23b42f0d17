"""Host time of kernel B2's wrapper per traced warm step, ms: the port's
span ``lexls.b2`` (argument checks, cached tables, the layout, the outputs,
the launch) less its child ``lexls.launch`` (the C entry), summed over the
steps the profiler recorded (``lexls_tpu_torch.tracing``, on while it
records) and divided by the ``lexls.solve_core_fused`` calls among them.
None where the port records no spans."""


def read(t):
    try:
        from lexls_tpu_torch import tracing
    except ImportError:  # a port without spans
        return None
    spans = tracing.snapshot().spans
    steps = sum(s.name == "lexls.solve_core_fused" and s.parent is None for s in spans)
    ns = tracing.self_ns("lexls.b2")
    return ns / 1e6 / steps if steps and ns else None
