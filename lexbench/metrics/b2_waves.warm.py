"""Rounds of resident blocks that kernel B2's warm launches take, as the
port's gauge ``b2.waves`` (``lexls_tpu_torch.tracing``, set at each launch
while the profiler records) gives them: the batch over the card's SMs times
its resident blocks per SM, rounded up.  None where B2 was not launched
(the CPU) or the port has no such gauge."""


def read(t):
    try:
        from lexls_tpu_torch import tracing
    except ImportError:  # a port without gauges
        return None
    return tracing.snapshot().gauges.get("b2.waves")
