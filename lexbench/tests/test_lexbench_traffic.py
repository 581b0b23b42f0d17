"""The drift ring is a closed loop of one step size, the same for a seed,
and the hierarchy generator is the port's, number for number."""

import numpy as np
import pytest
import torch

from conftest import tiny_config, tiny_traffic

from lexbench.harness import traffic


def inputs(seed, simple_bounds=False, length=64, batch=3):
    cfg = tiny_config("float64", simple_bounds)
    tr = tiny_traffic("warm_fused", batch, 1e-3)
    tr["ring"]["length"] = length
    return traffic.make_inputs(cfg, tr, seed, torch.float64, "cpu")


def test_the_ring_closes_on_itself_with_steps_of_one_size():
    ring = inputs(2 ** 31 + 5).ring.numpy()
    L = ring.shape[0]
    assert np.all(ring[0] == 0.0)
    steps = np.stack([ring[(t + 1) % L] - ring[t] for t in range(L)])
    wrap = np.linalg.norm(steps[-1]) / np.sqrt(steps[-1].size)
    rms = np.linalg.norm(steps) / np.sqrt(steps.size)
    assert 0.8e-3 < rms < 1.2e-3 and 0.5e-3 < wrap < 1.5e-3
    assert abs(steps.sum(axis=0)).max() < 1e-12  # the loop closes


def test_the_seed_picks_the_phase_of_one_cycle():
    """The cycle is the traffic's; ``--seed`` picks where a run starts in it."""
    a, b = inputs(123), inputs(123)
    assert torch.equal(a.base, b.base) and torch.equal(a.ring, b.ring) and a.phase == b.phase
    phases = {inputs(s).phase for s in range(2 ** 31, 2 ** 31 + 8)}
    assert len(phases) >= 6 and all(0 <= p < 64 for p in phases)
    c = inputs(124)
    assert torch.equal(a.ring, c.ring) and torch.equal(a.base, c.base)


def test_bound_rows_stay_unit_rows():
    inp = inputs(9, simple_bounds=True)
    d0 = len(inp.raw.var_idx)
    for t in (0, 5, 63):
        A = inp.A(t)
        assert torch.equal(A[:, :d0], torch.as_tensor(inp.raw.A[:d0]).expand(3, -1, -1))


@pytest.mark.parametrize("simple_bounds", [False, True])
def test_the_generator_is_the_ports(simple_bounds):
    from lexls_tpu_torch.oracle import random_inequality_hierarchy

    dims = [6, 4, 5] if simple_bounds else [5, 4, 5]
    ours = traffic.random_inequality_hierarchy(np.random.default_rng(3), 9, dims, 0.1, 0.3,
                                               simple_bounds)
    theirs = random_inequality_hierarchy(np.random.default_rng(3), 9, dims,
                                         equality_fraction=0.1, tight_fraction=0.3,
                                         simple_bounds=simple_bounds)
    for key in ("A", "lb", "ub"):
        assert np.array_equal(getattr(ours, key), getattr(theirs, key))
    if simple_bounds:
        assert np.array_equal(ours.var_idx, theirs.var_idx)



def test_the_sample_is_uniform_over_all_answers_and_drawn_from_the_seed():
    """The reservoir keeps k distinct answers; each of the window's answers
    is kept about equally often over seeds, and a seed repeats its draw."""
    import collections

    from lexbench.harness.entries import Entry

    def draw(seed, steps=4, batch=5, k=3):
        e = Entry.__new__(Entry)
        e.seed, e.k, e.traffic, e.steps = seed, k, {"batch": batch}, []
        e._reset_sample()
        for i in range(steps):
            e.steps.append(i)
            e._sample(torch.zeros(batch, 2))
        return sorted((i, b) for i, b, _ in e.slots)

    counts = collections.Counter()
    for seed in range(3000):
        got = draw(seed)
        assert len(set(got)) == 3
        counts.update(got)
    assert len(counts) == 20 and min(counts.values()) > 380 and max(counts.values()) < 520
    assert draw(2 ** 31 + 9) == draw(2 ** 31 + 9)
    assert draw(1, steps=1, batch=2) == [(0, 0), (0, 1)]
