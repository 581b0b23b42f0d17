"""Resident blocks per SM of kernel B2 in the traced warm steps, as the
card reports them at the layout of its launch: the port's gauge
``b2.blocks_per_sm`` (``lexls_tpu_torch.tracing``, set at each launch while
the profiler records).  None where B2 was not launched (the CPU) or the
port has no such gauge."""


def read(t):
    try:
        from lexls_tpu_torch import tracing
    except ImportError:  # a port without gauges
        return None
    return tracing.snapshot().gauges.get("b2.blocks_per_sm")
