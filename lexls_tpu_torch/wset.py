"""Working-set log replay (reference ``tests/implementation/wset/*.m``).

Counterpart of ``lexls_tpu/wset.py``: rebuild the working set as it stood
after any entry of a solve's working-set log, and solve the equality
subproblem with a working set pinned (``wset_get.m`` / ``wset_solve.m``),
the reference's way to inspect an active-set trajectory.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .lexlsi import (
    Structure,
    _factorize_masked,
    _masked_general,
    _reg_factors,
    full_fp32,
    host_device,
    host_tensor,
    initial_activation,
)
from .types import CtrType, ParametersLexLSI


def replay_working_set(prob, working_set_log: List, upto: Optional[int] = None) -> np.ndarray:
    """The per-row activation types after the first ``upto`` log entries
    (all where None), from the state at data-set time (equalities
    active).  An entry of type INACTIVE is a removal, any other an
    addition."""
    struct = Structure.of(prob)
    ctr_type, _, _ = initial_activation(prob)
    entries = working_set_log if upto is None else working_set_log[:upto]
    for e in entries:
        ctr_type[struct.first_row[e.obj_index] + e.ctr_index] = e.ctr_type
    return ctr_type


def solve_with_working_set(prob, ctr_type: np.ndarray, params: Optional[ParametersLexLSI] = None,
                           dtype=torch.float64, device="cuda"):
    """Solve the equality subproblem with the working set ``ctr_type``
    pinned (``wset_solve.m``): each active row is an equality at its
    active bound, inactive rows drop out, active simple bounds fix their
    variables.  One factorization through kernel B1 on ``device`` (the
    card by default, ``device="cpu"`` the plain version).  Returns (x, v),
    NumPy, with v the signed violation of the active rows."""
    from . import lexlse

    full_fp32()
    params = params or ParametersLexLSI()
    dev = host_device(device)
    struct = Structure.of(prob)
    t = lambda a: host_tensor(a, dev, dtype)  # noqa: E731
    A = t(prob.A)[None]
    ct = host_tensor(ctr_type, dev)[None]
    Ag, bg, fixed_mask, fixed_val = _masked_general(A, t(prob.lb)[None], t(prob.ub)[None], ct,
                                                    struct)
    f = _factorize_masked(Ag, bg, fixed_mask, fixed_val, struct, params,
                          _reg_factors(prob.regularization, params, A))
    x = lexlse.solve(f)[0].cpu().numpy()
    rhs = np.where(ctr_type == int(CtrType.ACTIVE_LB), prob.lb, prob.ub)
    active = ctr_type != int(CtrType.INACTIVE)
    return x, np.where(active, prob.A @ x - rhs, 0.0)
