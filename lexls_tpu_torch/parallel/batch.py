"""Batched and mesh-sharded solving: the cold batch entry's initial
arrays, ``solve_batched`` and the sharded solvers.

Counterpart of ``lexls_tpu/parallel/batch.py``.  Every tensor of the port
carries its batch axis, so ``solve_batched``, the JAX package's ``vmap``
of its single-instance solver, is the exact tier itself.  The sharded
solvers run over ``torch.distributed``: one process per device, each
solving its own shard of the batch with no communication, and only the
summary metrics (solved count, sum and max of the iterations) all-reduced
across ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..lexlsi import LexLSIState, Structure, host_tensor, initial_activation, \
    solve_core_batched, solve_core_fused
from ..tracker import solve_core_cold_tracked
from ..types import LexLSError, ParametersLexLSI

MODES = ("xla", "fused", "tracked")
# options of the JAX package's Pallas kernels (tiles, VMEM, compaction),
# which the port's CUDA kernels, one block per instance, do not have
TPU_ONLY = ("tile", "interpret", "vmem_limit_mb", "compact", "tile_b", "compact_rounds",
            "panel_unroll")
# the options each mode's solve takes: the tracker's, for "tracked"; the cold
# tracker of the sharded solvers has no loop_cap, trip1_noext, shrink or
# handover_slab (those are its warm steps', which only the sequences run), in
# the JAX package too
SOLVER_KNOBS = {"xla": (), "fused": (), "tracked": ("ns_iters", "cert_tol")}
SEQUENCE_KNOBS = {"xla": (), "fused": (),
                  "tracked": ("ns_iters", "cert_tol", "loop_cap", "trip1_noext", "shrink",
                              "handover_slab")}


def batched_initial_arrays(prob, batch: int, device):
    """Initial (ctr_type, stamp, next_stamp, x0, v0) of a cold start,
    broadcast to ``batch`` instances, as tensors on ``device`` (int32 and
    float64, as the NumPy arrays they come from).  The
    activation is the same for every instance (equality rows activate);
    a warm start replaces these with carried state."""
    ctr0, stamp0, next0 = initial_activation(prob)
    m, n = len(ctr0), int(prob.n_var)
    return (
        torch.as_tensor(ctr0, device=device).expand(batch, m).contiguous(),
        torch.as_tensor(stamp0, device=device).expand(batch, m).contiguous(),
        torch.full((batch,), int(next0), dtype=torch.int32, device=device),
        torch.zeros(batch, n, dtype=torch.float64, device=device),
        torch.zeros(batch, m, dtype=torch.float64, device=device),
    )


def solve_batched(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, reg,
                  struct: Structure, params: ParametersLexLSI,
                  x_guess_specified: bool = False, v0_specified: bool = False) -> LexLSIState:
    """The whole solver over a batch (``parallel/batch.py:42-61``): every
    array carries a leading batch axis except ``reg``, the per-level
    regularization factors shared by the batch.  Runs the exact tier,
    :func:`lexls_tpu_torch.solve_core_batched`, every regularization type
    included."""
    return solve_core_batched(A, lb, ub, ctr_type0, stamp0, next_stamp0, x0, v0, reg,
                              struct=struct, params=params, x_guess_specified=x_guess_specified,
                              v0_specified=v0_specified)


def _check_options(mode: str, kw: dict, knobs: dict) -> None:
    """Refuse, when a solver is built, an unknown mode (``ValueError``, as
    the JAX package) and any option that ``mode`` does not take
    (``LexLSError`` naming it), the TPU kernels' first."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (use 'xla', 'fused' or 'tracked')")
    tpu = sorted(set(kw) & set(TPU_ONLY))
    if tpu:
        raise LexLSError(f"options of the TPU kernels have no counterpart in the port: {tpu}")
    other = sorted(set(kw) - set(knobs[mode]))
    if other:
        raise LexLSError(f"mode {mode!r} takes no option {other} (it takes "
                         f"{list(knobs[mode]) or 'none'})")


def _local_solver(struct: Structure, params: ParametersLexLSI, x_guess_specified: bool,
                  v0_specified: bool, mode: str, kw: dict):
    """The solve of one rank's shard (``parallel/batch.py:64-100``):
    ``mode="xla"`` the exact tier (:func:`solve_batched`, kernel B1),
    ``"fused"`` the whole-solve tier (``solve_core_fused``, kernel B2),
    ``"tracked"`` the tracker's cold solve (``solve_core_cold_tracked``, with
    ``reg``), its state.  ``kw`` goes to the solve: for ``"tracked"`` the
    cold tracker's ``ns_iters`` and ``cert_tol`` (:data:`SOLVER_KNOBS`);
    any other option raises ``LexLSError``."""
    _check_options(mode, kw, SOLVER_KNOBS)
    flags = dict(struct=struct, params=params, x_guess_specified=x_guess_specified,
                 v0_specified=v0_specified)

    def run(A, lb, ub, c0, s0, n0, x0, v0, reg):
        if mode == "xla":
            return solve_batched(A, lb, ub, c0, s0, n0, x0, v0, reg, **flags, **kw)
        if mode == "fused":
            return solve_core_fused(A, lb, ub, c0, s0, n0, x0, v0, reg, **flags, **kw)
        return solve_core_cold_tracked(A, lb, ub, c0, s0, n0, x0, v0, reg=reg, **flags, **kw)[0]

    return run


def _rank_device(mesh) -> torch.device:
    """This rank's device: the current CUDA device (the caller sets one
    per rank) for a CUDA mesh, else the mesh's device type (the CPU under
    gloo)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _mesh_groups(mesh) -> list:
    """The process groups of the mesh's dimensions, the innermost first: the
    order in which the metrics are reduced, within a host before across
    hosts (``parallel/batch.py:160-163``)."""
    return [mesh.get_group(d) for d in reversed(range(mesh.ndim))]


def _reduce_metrics(status, it, groups) -> dict:
    """``solved`` and ``sum_iterations`` (all-reduce SUM) and
    ``max_iterations`` (all-reduce MAX) of this rank's solves, over each
    group in turn; int64 scalars on the state's device."""
    sums = torch.stack([(status == 0).sum(), it.sum()]).to(torch.int64)
    top = (it.amax() if it.numel() else torch.zeros((), device=it.device)).to(torch.int64)
    top = top.reshape(1)
    for g in groups:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=g)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
    return {"solved": sums[0], "max_iterations": top[0], "sum_iterations": sums[1]}


def _sharded(run, groups, dev):
    def fn(A, lb, ub, ctr0, stamp0, next0, x0, v0, reg):
        # NumPy input (host_tensor): A to this rank's device in its own dtype,
        # the other floats in A's, the working set as int32
        A = host_tensor(A, dev)
        lb, ub, x0, v0, reg = (host_tensor(a, A.device, A.dtype) for a in (lb, ub, x0, v0, reg))
        ctr0, stamp0, next0 = (host_tensor(a, A.device) for a in (ctr0, stamp0, next0))
        st = run(A, lb, ub, ctr0, stamp0, next0, x0, v0, reg)
        return st, _reduce_metrics(st.status, st.it, groups)

    return fn


def make_sharded_solver(mesh, struct: Structure, params: ParametersLexLSI, axis: str = "batch",
                        x_guess_specified: bool = False, v0_specified: bool = False,
                        mode: str = "xla", **kw):
    """A solver whose batch is split over dimension ``axis`` of ``mesh``, a
    ``torch.distributed.device_mesh.DeviceMesh`` (``parallel/batch.py:103-152``).

    Torch runs one process per device, so the returned ``fn(A, lb, ub,
    ctr0, stamp0, next0, x0, v0, reg) -> (state, metrics)`` takes **this
    rank's shard** of every per-instance array (``reg``, the per-level
    factors, whole) and returns this rank's state: the multi-process recipe
    of the JAX package's docstring (``make_array_from_process_local_data``),
    where its single-process ``fn`` takes and returns global arrays.  No x
    crosses ranks.  The shard is solved on this rank's device (the current
    CUDA device for a CUDA mesh, the CPU under gloo; NumPy arrays go there)
    by ``mode`` (see :func:`_local_solver`, ``kw`` its options), and
    ``metrics = {"solved", "max_iterations", "sum_iterations"}`` are
    all-reduced over the group of ``axis``: the only values that cross
    ranks."""
    run = _local_solver(struct, params, x_guess_specified, v0_specified, mode, kw)
    return _sharded(run, [mesh.get_group(axis)], _rank_device(mesh))


def make_host_mesh(n_hosts: int, chips_per_host: int, device_type: str = "cuda"):
    """A 2-D ``DeviceMesh`` with dimensions ``("dcn", "ici")`` over the
    ranks of the initialized default process group, host-major (rank = host
    x chips_per_host + chip), for multi-host batch sharding
    (``parallel/batch.py:155-200``).  Every rank calls it, after
    ``torch.distributed.init_process_group`` with ``n_hosts *
    chips_per_host`` ranks (and, for CUDA, ``torch.cuda.set_device`` of its
    card); raises ``LexLSError`` without such a group."""
    from torch.distributed.device_mesh import init_device_mesh

    n = n_hosts * chips_per_host
    if not (dist.is_available() and dist.is_initialized()):
        raise LexLSError(f"make_host_mesh needs an initialized process group of {n} ranks "
                         "(torch.distributed.init_process_group)")
    if dist.get_world_size() != n:
        raise LexLSError(f"make_host_mesh({n_hosts}, {chips_per_host}) needs {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, (n_hosts, chips_per_host),
                            mesh_dim_names=("dcn", "ici"))


def make_sharded_solver_2d(mesh, struct: Structure, params: ParametersLexLSI,
                           x_guess_specified: bool = False, v0_specified: bool = False,
                           mode: str = "xla", **kw):
    """Multi-host variant of :func:`make_sharded_solver`
    (``parallel/batch.py:203-240``): the batch is split over every mesh
    dimension (``("dcn", "ici")`` of :func:`make_host_mesh`), each rank
    passing its own shard, and the metrics are all-reduced over "ici"
    first, then over "dcn"."""
    run = _local_solver(struct, params, x_guess_specified, v0_specified, mode, kw)
    return _sharded(run, _mesh_groups(mesh), _rank_device(mesh))


def make_sharded_sequence_solver(mesh, struct: Structure, params: ParametersLexLSI,
                                 mode: str = "xla", **kw):
    """Warm-started sequences sharded over a ``torch.distributed`` device
    mesh (``sequence.py:270-324``): BASELINE config 4 (an IK sequence)
    composed with config 5 (many independent hierarchies across devices).

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` (for
    instance :func:`make_host_mesh`), and the sequence batch is split over
    every one of its dimensions.  Torch runs one process per device, so the
    returned ``fn(A_seq, lb_seq, ub_seq, reg) -> (outs, metrics)`` takes
    **this rank's shard** of the (B, T, m, n) batch, where the JAX
    package's takes the global array, and returns this rank's outputs: the
    6-tuple of :func:`lexls_tpu_torch.sequence.solve_sequence_batched`.
    ``mode="xla"`` runs ``solve_sequence_batched`` (the exact tier),
    ``"fused"`` and ``"tracked"`` ``solve_sequence_batched_fused``
    (``tracked=`` the mode; ``kw`` the tracker's ``ns_iters``,
    ``cert_tol``, ``loop_cap``, ``trip1_noext``, ``shrink`` and
    ``handover_slab``, :data:`SEQUENCE_KNOBS`;
    any other option raises ``LexLSError``).  NumPy
    inputs go to the rank's device.  Only ``metrics = {"solved",
    "max_iterations", "sum_iterations"}``, over every step of every
    sequence, cross ranks: all-reduced over each mesh dimension in turn, the
    innermost first."""
    _check_options(mode, kw, SEQUENCE_KNOBS)
    groups, dev = _mesh_groups(mesh), _rank_device(mesh)

    def fn(A_seq, lb_seq, ub_seq, reg):
        from ..sequence import solve_sequence_batched, solve_sequence_batched_fused

        A_seq = host_tensor(A_seq, dev)
        if mode == "xla":
            outs = solve_sequence_batched(A_seq, lb_seq, ub_seq, reg, struct, params)
        else:
            outs = solve_sequence_batched_fused(A_seq, lb_seq, ub_seq, reg, struct, params,
                                                tracked=mode == "tracked", **kw)
        return outs, _reduce_metrics(outs[2], outs[3], groups)

    return fn
