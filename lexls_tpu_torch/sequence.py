"""Warm-started sequences of related problems (the IK-sequence loop).

Step 0 of each sequence solves cold; step t > 0 starts from step t-1's
solution and final active set (the warm-start carry ``(x, ctr_type)``,
and with ``tracked=True`` the carried factorization as well).
Counterpart of ``lexls_tpu/sequence.py``: the JAX package's ``lax.scan``
over steps is a Python loop here, each step one batched whole solve,
through the whole-solve tier (kernel B2) or through the exact tier
(kernel B1 in every iteration).  Every entry point takes tensors, which keep
their device and dtype, or NumPy arrays, which go to ``device`` (the card
unless the caller passes ``device="cpu"``; without a card that raises).
:func:`make_sharded_sequence_solver` (defined beside the other sharded
solvers in :mod:`lexls_tpu_torch.parallel.batch`) runs them on each rank of
a ``torch.distributed`` device mesh.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import tracing
from .lexlsi import Structure, full_fp32, host_tensor, solve_core_batched, solve_core_fused
from .ops.phase1 import activation
from .parallel.batch import make_sharded_sequence_solver  # noqa: F401  (JAX's home of it)
from .types import ParametersLexLSI


def _device_initial_activation(A, lb, ub, guess_type, struct: Structure):
    """Batched initial (ctr_type, stamp, next_stamp) (``sequence.py:25-50``):
    equality rows (lb == ub, nonzero normal; simple-bounds rows always)
    auto-activate first in row order, then the LB/UB guess rows in row
    order.  :func:`lexls_tpu_torch.ops.phase1.activation`, one kernel
    launch on the card.  Traced as the span ``lexls.activation``
    (:mod:`lexls_tpu_torch.tracing`)."""
    with tracing.span("lexls.activation"):
        return activation(A, lb, ub, guess_type, struct.d0)


def _sequence_tensors(A_seq, lb_seq, ub_seq, reg, device):
    """The inputs of a sequence entry point as tensors
    (:func:`lexls_tpu_torch.lexlsi.host_tensor`): a NumPy ``A_seq`` goes to
    ``device`` in its own dtype, NumPy arrays beside it follow ``A_seq``'s
    device and dtype, and tensors stay as they are."""
    A_seq = host_tensor(A_seq, device)
    return (A_seq,) + tuple(host_tensor(a, A_seq.device, A_seq.dtype)
                            for a in (lb_seq, ub_seq, reg))


def _run_sequence(A_seq, lb_seq, ub_seq, struct: Structure, step):
    """The loop over the T steps of a batch of sequences: step 0 cold,
    every later step from the previous step's x and working set.
    ``step(t, A, lb, ub, ctr_type0, stamp0, next_stamp0, x, v0)`` solves
    one step and returns its state.  Returns the stacked per-step (x, v,
    status, iterations, factorizations, ctr_type)."""
    full_fp32()
    B, T, m, n = A_seq.shape
    x = torch.zeros(B, n, dtype=A_seq.dtype, device=A_seq.device)
    v0 = torch.zeros(B, m, dtype=A_seq.dtype, device=A_seq.device)
    ct = torch.zeros(B, m, dtype=torch.int32, device=A_seq.device)
    outs = []
    for t in range(T):
        A, lb, ub = (a[:, t].contiguous() for a in (A_seq, lb_seq, ub_seq))
        c, s, ns = _device_initial_activation(A, lb, ub, ct, struct)
        st = step(t, A, lb, ub, c, s, ns, x, v0)
        x, ct = st.x, st.ctr_type
        outs.append((st.x, st.v, st.status, st.it, st.n_fact, st.ctr_type))
    return tuple(torch.stack(field, 1) for field in zip(*outs))


def solve_sequence_batched_fused(A_seq, lb_seq, ub_seq, reg, struct: Structure,
                                 params: ParametersLexLSI, tracked: bool = False,
                                 ns_iters: int = 2, cert_tol: Optional[float] = None,
                                 loop_cap: int = 0, trip1_noext: bool = False,
                                 stats: Optional[list] = None, shrink: tuple = (),
                                 handover_slab: int = 0, device="cuda"):
    """Batched warm-started sequences through the whole-solve tier.

    ``A_seq`` is (B, T, m, n), ``lb_seq``/``ub_seq`` (B, T, m).  Returns
    (x (B, T, n), v (B, T, m), status (B, T), iterations (B, T),
    factorizations (B, T), ctr_type (B, T, m)), as the JAX package's
    ``solve_sequence_batched_fused``.

    ``tracked=True`` also carries the final factorization across steps
    (:mod:`lexls_tpu_torch.tracker`): the cold step bootstraps it with one
    capped kernel iteration, and every warm step runs tracker trips over
    the carried pivot order, falling back to kernel B2 per instance; x and
    v keep their parity, trajectories may differ where a carry is
    rejected.  ``ns_iters``, ``cert_tol`` (None: 1e-3 at float32, 1e-9 at
    float64), ``loop_cap``, ``trip1_noext``, ``shrink`` and
    ``handover_slab`` go to every warm step's
    :func:`lexls_tpu_torch.tracker.solve_core_tracked`.  ``stats``, when
    given, receives one ``(trips, instances handed to the kernel)`` tuple
    per tracked step.  Regularization raises on both paths: the kernel has
    none, and ``reg`` does not reach the tracker (``sequence.py:217-230``).
    NumPy inputs go to ``device`` (see :func:`_sequence_tensors`).
    """
    from . import tracker as trk

    A_seq, lb_seq, ub_seq, reg = _sequence_tensors(A_seq, lb_seq, ub_seq, reg, device)
    tkw = dict(struct=struct, params=params, ns_iters=ns_iters, cert_tol=cert_tol, stats=stats)
    carried = None

    def step(t, A, lb, ub, c, s, ns, x, v0):
        nonlocal carried
        if not tracked:
            return solve_core_fused(A, lb, ub, c, s, ns, x, v0, reg, struct=struct,
                                    params=params, x_guess_specified=t > 0, v0_specified=False)
        if t == 0:
            st, carried = trk.solve_core_cold_tracked(A, lb, ub, c, s, ns, x, v0, **tkw)
        else:
            st, carried = trk.solve_core_tracked(A, lb, ub, c, s, ns, x, v0, carried=carried,
                                                 loop_cap=loop_cap, trip1_noext=trip1_noext,
                                                 shrink=shrink, handover_slab=handover_slab,
                                                 **tkw)
        return st

    return _run_sequence(A_seq, lb_seq, ub_seq, struct, step)


def solve_sequence_batched_native(A_seq, lb_seq, ub_seq, reg, struct: Structure,
                                  params: ParametersLexLSI, device="cuda"):
    """Batched warm-started sequences through the natively batched exact
    tier (:func:`lexls_tpu_torch.solve_core_batched`, kernel B1 in every
    iteration; ``sequence.py:117-165``), every regularization type with
    the factors ``reg``.  ``A_seq`` is (B, T, m, n); same outputs as
    :func:`solve_sequence_batched_fused`.  NumPy inputs go to ``device``
    (see :func:`_sequence_tensors`)."""
    A_seq, lb_seq, ub_seq, reg = _sequence_tensors(A_seq, lb_seq, ub_seq, reg, device)

    def step(t, A, lb, ub, c, s, ns, x, v0):
        return solve_core_batched(A, lb, ub, c, s, ns, x, v0, reg, struct=struct, params=params,
                                  x_guess_specified=t > 0, v0_specified=False)

    return _run_sequence(A_seq, lb_seq, ub_seq, struct, step)


def solve_sequence_batched(A_seq, lb_seq, ub_seq, reg, struct: Structure,
                           params: ParametersLexLSI, device="cuda"):
    """Batched warm-started sequences (``sequence.py:104-113``): ``A_seq``
    is (B, T, m, n), each output (B, T, ...).  The JAX package's ``vmap``
    of :func:`solve_sequence`; every tensor of the port carries its batch
    axis, so here it is the exact tier over the batch,
    :func:`solve_sequence_batched_native`, every regularization type
    included."""
    return solve_sequence_batched_native(A_seq, lb_seq, ub_seq, reg, struct, params,
                                         device=device)


def solve_sequence(A_seq, lb_seq, ub_seq, reg, struct: Structure, params: ParametersLexLSI,
                   device="cuda"):
    """One sequence of hierarchies with warm starting (``sequence.py:54-100``).

    ``A_seq`` is (T, m, n), ``lb_seq``/``ub_seq`` (T, m).  Step 0 is a
    cold solve; step t > 0 starts from step t-1's solution and active set.
    Returns the stacked per-step (x (T, n), v (T, m), status (T,),
    iterations (T,), factorizations (T,), ctr_type (T, m)), without a batch
    axis: the exact tier on a batch of one, as
    :func:`lexls_tpu_torch.solve_core`.  NumPy inputs go to ``device``."""
    outs = solve_sequence_batched(A_seq[None], lb_seq[None], ub_seq[None], reg, struct, params,
                                  device=device)
    return tuple(o[0] for o in outs)

