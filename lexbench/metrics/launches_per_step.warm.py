"""Kernels the port launches in one warm step (the profiler's kernels whose
launch the host issued inside the call into the port), over the traced
steps.  The harness's own launch that forms a step's A is not counted."""


def read(t):
    if t.steps == 0 or not t.kernels:
        return None
    return len(t.program_kernels()) / t.steps
