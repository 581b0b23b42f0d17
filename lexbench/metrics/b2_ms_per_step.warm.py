"""Kernel B2's own device time per warm step, ms: the profiler's
``fused_kernel`` intervals over the traced steps."""

KERNEL = "fused_kernel"


def read(t):
    ks = t.kernels_named(KERNEL)
    if t.steps == 0 or not ks:
        return None
    return sum(e - s for _, s, e, _ in ks) / 1e3 / t.steps
