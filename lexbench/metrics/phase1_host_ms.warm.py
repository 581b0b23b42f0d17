"""Host time of phase 1 per traced warm step, ms: the port's own spans
``lexls.activation`` (phase 1's working-set activation) and
``lexls.phase1.warm`` (``lexlsi._initial_state`` with an x guess), summed
over the steps the profiler recorded (``lexls_tpu_torch.tracing``, on while
it records) and divided by the ``lexls.solve_core_fused`` calls among
them.  None where the port records no spans."""

SPANS = ("lexls.activation", "lexls.phase1.warm")


def read(t):
    try:
        from lexls_tpu_torch import tracing
    except ImportError:  # a port without spans
        return None
    spans = tracing.snapshot().spans
    steps = sum(s.name == "lexls.solve_core_fused" and s.parent is None for s in spans)
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name in SPANS)
    return ns / 1e6 / steps if steps and ns else None
