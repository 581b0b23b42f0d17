"""Mean active-set iterations per cold solve over the window's calls
(``LexLSIState.it`` of every instance of every call)."""


def read(t):
    n = t.counters.get("solves")
    return t.counters["iters_sum"] / n if n else None
