"""The benchmark's harness: cells found by name, traffic from data, the
port driven through its entry points, traces read, answers checked."""
