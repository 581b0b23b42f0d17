"""Kernel B2's share of its roofline in the traced cold calls, %: the least
time the card could take for the work those calls needed,
max(operations / peak rate of the dtype, bytes / 3.35 TB/s)
(``lexbench/harness/work.py``: operations at each instance's iterations
and final ranks, every input and output byte once), over B2's own device
time (the profiler's ``fused_kernel`` intervals)."""

from lexbench.harness import work

KERNEL = "fused_kernel"


def read(t):
    ks = t.kernels_named(KERNEL)
    flops, nbytes = t.counters.get("b2_flops"), t.counters.get("b2_bytes")
    if not ks or not flops:
        return None
    own_s = sum(e - s for _, s, e, _ in ks) / 1e6
    least_s, _ = work.bound_s(nbytes, flops, t.dtype)
    return 100.0 * least_s / own_s
