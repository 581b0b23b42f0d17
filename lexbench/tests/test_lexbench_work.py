"""The benchmark's frozen work counts are chip_smoke.py's, number for number."""

import numpy as np
import torch

from lexbench.harness import work


def test_the_counts_match_chip_smoke():
    import chip_smoke

    rng = np.random.default_rng(0)
    r = rng.integers(0, 30, 64).astype(np.float64)
    cols = rng.integers(30, 101, 64).astype(np.float64)
    assert np.array_equal(work.panel_flops(r, 30, cols), chip_smoke._panel_flops(r, 30, cols))
    dims, n, m, B = (30, 30, 30, 30), 100, 120, 16
    ranks = torch.as_tensor(rng.integers(0, 31, (B, 4)), dtype=torch.int32)
    its = torch.as_tensor(rng.integers(1, 200, B), dtype=torch.int32)
    n_act = torch.minimum(its, torch.as_tensor(rng.integers(0, 120, B), dtype=torch.int32))

    class Res:
        pass

    res = Res()
    res.ranks, res.it, res.n_act = ranks, its, n_act
    want = chip_smoke._active_set_flops(res, dims, n, m)
    got = work.active_set_flops(ranks.numpy(), its.numpy(), n_act.numpy(), dims, n, m)
    assert got == want
    for nbytes, flops in ((1e9, 1e9), (1e3, 1e12)):
        ms, by = chip_smoke._bound(nbytes, flops)
        s, by2 = work.bound_s(nbytes, flops, "float32")
        assert abs(s * 1e3 - ms) <= 1e-12 * ms and by == by2
