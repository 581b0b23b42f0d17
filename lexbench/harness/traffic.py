"""The one generator of the benchmark's traffic, driven by data.

A configuration fixes one hierarchy (its ``hierarchy`` block: the
generator's seed and fractions; a deployment is one robot's task).  From
the traffic's ``ring.seed`` come, on the device and in two large draws,
the batch's perturbed copies of it and the drift ring:

* ``base[b] = A + perturbation * N(0, 1)`` on the general rows (the unit
  rows of a simple-bounds level stay unit rows);
* the ring: L drifts that a robot repeating its task cycle sees, a random
  walk of ``step * N(0, 1)`` increments pulled back to its start (a
  bridge), so that ``ring[L - 1] -> ring[0]`` is one more step of the same
  size and the work per step does not depend on how far a run gets.

Step ``t`` of a cell solves ``base + ring[t mod L]``.  ``--seed`` picks the
phase of the cycle at which a run starts (and the answers the check
samples): every seed meets the same instances in another order, so the
work of a window does not depend on the seed beyond its partial lap.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .generate import RawHierarchy, random_inequality_hierarchy

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def hierarchy(config: dict) -> RawHierarchy:
    """The configuration's hierarchy, drawn as its ``hierarchy`` block says."""
    h = config["hierarchy"]
    return random_inequality_hierarchy(np.random.default_rng(h["seed"]), config["n_var"],
                                       config["dims"], h["equality_fraction"],
                                       h["tight_fraction"], config["simple_bounds"])


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


class Inputs(NamedTuple):
    raw: RawHierarchy
    base: torch.Tensor  # (B, m, n), the cell's dtype
    ring: torch.Tensor  # (L, m, n)
    lb: torch.Tensor    # (m,)
    ub: torch.Tensor
    phase: int          # the ring position of a run's first solve

    def A(self, t: int) -> torch.Tensor:
        """Step t's batch, (B, m, n)."""
        return (self.base + self.ring[t % self.ring.shape[0]]).contiguous()

    def instance(self, t: int, b: int) -> np.ndarray:
        """Instance b of step t as the program got it, in float64."""
        return (self.base[b] + self.ring[t % self.ring.shape[0]]).double().cpu().numpy()


def make_inputs(config: dict, traffic: dict, seed: int, dtype: torch.dtype, device) -> Inputs:
    raw = hierarchy(config)
    m, n = raw.A.shape
    B, ring = int(traffic["batch"]), traffic["ring"]
    L = int(ring["length"])
    g = generator(ring["seed"], device)
    f64 = dict(dtype=torch.float64, device=device)
    general = torch.ones(m, 1, **f64)
    if raw.var_idx is not None:
        general[:len(raw.var_idx)] = 0.0
    A = torch.as_tensor(raw.A, **f64)
    base = A + config["perturbation"] * general * torch.randn(B, m, n, generator=g, **f64)
    inc = ring["step"] * general * torch.randn(L, m, n, generator=g, **f64)
    walk = torch.cumsum(inc, 0) - inc                      # walk[t] = sum of inc[:t]
    total = walk[-1] + inc[-1]
    frac = torch.arange(L, **f64)[:, None, None] / L
    drift = walk - frac * total                            # the bridge: drift[0] = 0
    lb, ub = (torch.as_tensor(a, **f64).to(dtype) for a in (raw.lb, raw.ub))
    phase = int(np.random.default_rng([int(seed) % (2 ** 63), 2]).integers(L))
    return Inputs(raw=raw, base=base.to(dtype), ring=drift.to(dtype), lb=lb, ub=ub, phase=phase)

