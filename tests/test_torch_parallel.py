"""The port's sequence entry points and mesh-sharded solvers against the JAX
package's, in float64 on the CPU.

``solve_sequence`` and ``solve_sequence_batched`` against the JAX
package's (``tests/test_parallel.py``'s shapes); the four sequence entry points
on NumPy inputs.  The sharded solvers run in subprocesses over gloo, the
torch counterpart of ``tests/test_distributed.py``: a worker script per
rank (torch, NumPy and ``lexls_tpu_torch`` only), a file store for the
rendezvous (no TCP port to race for), inputs and outputs through ``.npz``
files.  One start-up of two ranks covers ``make_sharded_solver`` and
``make_sharded_sequence_solver`` in every mode, one of four ranks
``make_host_mesh`` and ``make_sharded_solver_2d`` in every mode.  Each
rank's shard, concatenated in rank order, equals the port's unsharded call
on the whole batch (statuses, iterations and working sets identical, x to
1e-12), whose ``fused`` and ``tracked`` tiers earlier files hold against
JAX; ``xla`` is also held against JAX's own sharded solvers on the
conftest's 8-device virtual mesh."""

import functools
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import lexls_tpu.lexlsi as jli
import lexls_tpu.parallel as jpar
import lexls_tpu.sequence as jseq
from lexls_tpu import types as JT
from lexls_tpu.oracle import generate as jgen

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert
from lexls_tpu_torch.parallel.batch import TPU_ONLY, _local_solver, _sharded

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("xla", "fused", "tracked")
# a start-up of the workers (torch's import, some 3 s) and their solves take
# seconds; a hung rendezvous or collective fails the test at this limit
# rather than holding the run until its own limit cuts it
WORKER_TIMEOUT_S = 300
STATE_FIELDS = ("x", "v", "status", "it", "n_fact", "ctr_type")

_WORKER = r'''
"""One rank of a gloo run of lexls_tpu_torch's sharded solvers.

    python worker.py RANK WORLD DIR JOB

reads DIR/inputs.npz, solves this rank's shard of each batch and writes
DIR/out_RANK.npz.  JOB "flat": a 1-D mesh ("batch",) of WORLD ranks,
make_sharded_solver and make_sharded_sequence_solver in every mode, and
make_host_mesh(2, 2) refused; JOB "2d": make_host_mesh(2, 2, "cpu") and
make_sharded_solver_2d in every mode."""
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import lexls_tpu_torch as lt
from lexls_tpu_torch import convert

rank, world, d, job = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank, world_size=world)
inp = np.load(f"{d}/inputs.npz")
params = lt.ParametersLexLSI()
out = {}


def shard(a):
    b = a.shape[0] // world
    return a[rank * b:(rank + 1) * b]


def struct(p):
    return lt.Structure.of(convert.hierarchy_from_numpy(
        inp[p + "A"], inp[p + "lb"], inp[p + "ub"], inp[p + "dims"]))


def keep(prefix, outs, metrics):
    for k, a in zip(("x", "v", "status", "it", "n_fact", "ctr_type"), outs):
        out[prefix + k] = a.numpy()
    for k, a in metrics.items():
        out[prefix + k] = int(a)


args = [shard(inp["s_" + k]) for k in ("As", "lbs", "ubs", "c0", "s0", "n0", "x0", "v0")]
args.append(inp["s_reg"])
if job == "flat":
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("batch",))
    for mode in ("xla", "fused", "tracked"):
        st, metrics = lt.make_sharded_solver(mesh, struct("s_"), params, mode=mode)(*args)
        keep(mode + "_", (st.x, st.v, st.status, st.it, st.n_fact, st.ctr_type), metrics)
        fn = lt.make_sharded_sequence_solver(mesh, struct("q_"), params, mode=mode)
        keep("seq_" + mode + "_", *fn(*[shard(inp["q_" + k]) for k in ("As", "lbs", "ubs")],
                                      inp["q_reg"]))
    try:
        lt.make_host_mesh(2, 2, "cpu")
    except lt.LexLSError as e:
        out["host_mesh_refused"] = str(e)
else:
    mesh = lt.make_host_mesh(2, world // 2, "cpu")
    out["mesh"] = mesh.mesh.numpy()
    out["coordinate"] = np.array(mesh.get_coordinate())
    for mode in ("xla", "fused", "tracked"):
        st, metrics = lt.make_sharded_solver_2d(mesh, struct("s_"), params, mode=mode)(*args)
        keep(mode + "_", (st.x, st.v, st.status, st.it, st.n_fact, st.ctr_type), metrics)
np.savez(f"{d}/out_{rank}.npz", **out)
dist.barrier()  # no rank tears its connections down while another still uses them
dist.destroy_process_group()
'''


def _batch(seed, B, n=6, dims=(4, 3)):
    """``test_parallel.py::_batch_of_problems``: one hierarchy, B copies of A
    perturbed by 1e-2."""
    rng = np.random.default_rng(seed)
    base = jgen.random_inequality_hierarchy(rng, n, list(dims))
    As = np.stack([base.A + 1e-2 * rng.standard_normal(base.A.shape) for _ in range(B)])
    lbs = np.broadcast_to(base.lb, (B,) + base.lb.shape).copy()
    ubs = np.broadcast_to(base.ub, (B,) + base.ub.shape).copy()
    return base, As, lbs, ubs


def _sequences(seed, B, T, n, dims, scale, step_scale, **kw):
    """B sequences of T steps of one hierarchy, step t's A perturbed by
    ``scale + step_scale * t`` times a normal draw (``test_parallel.py``)."""
    rng = np.random.default_rng(seed)
    base = jgen.random_inequality_hierarchy(rng, n, list(dims), **kw)
    As = np.stack([np.stack([base.A + (scale + step_scale * t) * rng.standard_normal(
        base.A.shape) for t in range(T)]) for _ in range(B)])
    m = base.n_ctr
    return base, As, np.broadcast_to(base.lb, (B, T, m)).copy(), \
        np.broadcast_to(base.ub, (B, T, m)).copy()


def _single_sequence():
    """``test_sequence_matches_host_warm_start``'s: n=6, dims [4, 3], T=5, seed 2."""
    rng = np.random.default_rng(2)
    base = jgen.random_inequality_hierarchy(rng, 6, [4, 3])
    As = np.stack([base.A + 2e-3 * t * rng.standard_normal(base.A.shape) for t in range(5)])
    return base, As, np.broadcast_to(base.lb, (5, base.n_ctr)).copy(), \
        np.broadcast_to(base.ub, (5, base.n_ctr)).copy()


def _small_batch():
    """``test_sequence_batched_shapes``'s: B=3, T=4, n=5, dims [3, 2], seed 3."""
    return _sequences(3, 3, 4, 5, (3, 2), 1e-3, 0.0)


def _seq_sharded():
    """``test_sharded_sequence_matches_single``'s: n=8, dims [4, 3], B=16, T=3,
    seed 9."""
    return _sequences(9, 16, 3, 8, (4, 3), 2e-3, 2e-3, equality_fraction=0.2,
                      tight_fraction=0.4)


def _assert_outs(got, want, atol, what):
    for name, g, w in zip(STATE_FIELDS, got, want):
        g, w = np.asarray(g), np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


# --- the sequence entry points ---------------------------------------------


def test_solve_sequence_matches_jax():
    base, As, lbs, ubs = _single_sequence()
    params = JT.ParametersLexLSI()
    want = jseq.solve_sequence(jnp.asarray(As), jnp.asarray(lbs), jnp.asarray(ubs),
                               jnp.asarray(base.regularization), struct=jli.Structure.of(base),
                               params=params)
    got = lt.solve_sequence(*convert.to_torch((As, lbs, ubs, base.regularization), "cpu"),
                            lt.Structure.of(base), convert.params_from(params))
    assert got[0].shape == (5, 6) and got[5].shape == (5, base.n_ctr)
    assert int(got[3][1:].max()) <= int(got[3][0])
    _assert_outs(got, want, 1e-9, "solve_sequence")


def test_solve_sequence_batched_matches_jax():
    base, As, lbs, ubs = _small_batch()
    params = JT.ParametersLexLSI()
    want = jseq.solve_sequence_batched(
        jnp.asarray(As), jnp.asarray(lbs), jnp.asarray(ubs), jnp.asarray(base.regularization),
        struct=jli.Structure.of(base), params=params)
    got = lt.solve_sequence_batched(*convert.to_torch((As, lbs, ubs, base.regularization), "cpu"),
                                    lt.Structure.of(base), convert.params_from(params))
    assert got[0].shape == (3, 4, 5)
    assert bool((got[2] == 0).all())
    _assert_outs(got, want, 1e-9, "solve_sequence_batched")


ENTRY_POINTS = ("solve_sequence", "solve_sequence_batched", "solve_sequence_batched_native",
           "solve_sequence_batched_fused")


def _entry_inputs(entry):
    base, As, lbs, ubs = _small_batch()
    if entry == "solve_sequence":
        As, lbs, ubs = As[0], lbs[0], ubs[0]
    return base, (As, lbs, ubs, base.regularization)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_numpy_inputs_match_tensors(entry):
    """NumPy arrays with ``device="cpu"`` give what tensors on the CPU give;
    the outputs stay on the CPU in float64."""
    base, arrays = _entry_inputs(entry)
    fn, struct, params = getattr(lt, entry), lt.Structure.of(base), lt.ParametersLexLSI()
    got = fn(*arrays, struct, params, device="cpu")
    want = fn(*convert.to_torch(arrays, "cpu"), struct, params)
    assert got[0].device.type == "cpu" and got[0].dtype == torch.float64
    for name, g, w in zip(STATE_FIELDS, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_numpy_beside_a_tensor_follows_it(entry):
    """NumPy bounds and factors beside a float32 tensor A take its device
    and dtype (float64 NumPy is cast, never kept): the result is that of
    float32 tensors throughout."""
    base, arrays = _entry_inputs(entry)
    fn, struct, params = getattr(lt, entry), lt.Structure.of(base), lt.ParametersLexLSI()
    A32 = torch.as_tensor(arrays[0], dtype=torch.float32)
    got = fn(A32, *arrays[1:], struct, params)
    want = fn(*(torch.as_tensor(a, dtype=torch.float32) for a in arrays), struct, params)
    assert got[0].dtype == torch.float32
    for name, g, w in zip(STATE_FIELDS, got, want):
        assert torch.equal(g, w), name


def test_sharded_fn_takes_numpy_by_the_same_rule():
    """The sharded solvers' ``fn`` converts a shard as the sequence drivers
    do (``lexlsi.host_tensor``): beside a float32 tensor A, NumPy floats in
    float32 and the working set in int32, on A's device."""
    seen = {}

    def run(*args):
        seen.update(zip(("A", "lb", "ub", "c0", "s0", "n0", "x0", "v0", "reg"), args))
        return SimpleNamespace(status=torch.zeros(2, dtype=torch.int32),
                               it=torch.ones(2, dtype=torch.int32))

    A = torch.zeros(2, 3, 4, dtype=torch.float32)
    f64, i64 = np.zeros((2, 3)), np.zeros((2, 3), np.int64)
    _, metrics = _sharded(run, [], torch.device("cpu"))(
        A, f64, f64, i64, i64, np.zeros(2, np.int64), np.zeros((2, 4)), f64, np.zeros(2))
    assert seen["A"] is A
    for k in ("lb", "ub", "x0", "v0", "reg"):
        assert seen[k].dtype == torch.float32, k
    for k in ("c0", "s0", "n0"):
        assert seen[k].dtype == torch.int32, k
    assert {k: int(v) for k, v in metrics.items()} == {"solved": 2, "max_iterations": 1,
                                                         "sum_iterations": 2}


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_numpy_inputs_need_a_card_by_default(entry):
    """NumPy arrays go to the card unless the caller passes a device;
    without one they raise, never falling back to the CPU."""
    base, arrays = _entry_inputs(entry)
    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
            pytest.raises(lt.LexLSError, match="no CUDA device"):
        getattr(lt, entry)(*arrays, lt.Structure.of(base), lt.ParametersLexLSI())


# --- the sharded solvers over gloo ----------------------------------------


def _run_ranks(directory, world, job, inputs):
    """Start ``world`` worker processes of ``job`` on ``inputs``; return
    each rank's outputs.  Fails the test if the workers take longer than
    WORKER_TIMEOUT_S in all (killing them) or a rank exits non-zero."""
    np.savez(directory / "inputs.npz", **inputs)
    script = directory / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(directory),
                               job], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              cwd=REPO) for r in range(world)]
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the {world} gloo workers of {job!r} did not finish in {WORKER_TIMEOUT_S} s")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {job!r} exited {p.returncode}:\n{logs[r]}"
    return [dict(np.load(directory / f"out_{r}.npz")) for r in range(world)]


def _solver_inputs(prefix, base, As, lbs, ubs):
    c0, s0, n0, x0, v0 = (t.numpy() for t in lt.batched_initial_arrays(
        convert.hierarchy_from_numpy(base.A, base.lb, base.ub, base.dims), As.shape[0], "cpu"))
    return {prefix + k: a for k, a in dict(
        A=base.A, lb=base.lb, ub=base.ub, dims=np.asarray(base.dims), As=As, lbs=lbs, ubs=ubs,
        c0=c0, s0=s0, n0=n0, x0=x0, v0=v0, reg=base.regularization).items()}


FLAT_B = 16  # test_sharded_fused_matches_vmap's B, n=6, dims (4, 3); seed 4
HOST_B = 8   # test_host_mesh_2d_matches_vmap's batch, seed 5


@pytest.fixture(scope="module")
def flat_run(tmp_path_factory):
    """Two gloo ranks: make_sharded_solver and make_sharded_sequence_solver in
    every mode."""
    inputs = _solver_inputs("s_", *_batch(4, FLAT_B))
    base, As, lbs, ubs = _seq_sharded()
    inputs.update(_solver_inputs("q_", base, As, lbs, ubs))
    return _run_ranks(tmp_path_factory.mktemp("flat"), 2, "flat", inputs)


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    """Four gloo ranks: make_host_mesh(2, 2) and make_sharded_solver_2d in
    every mode."""
    return _run_ranks(tmp_path_factory.mktemp("host"), 4, "2d",
                      _solver_inputs("s_", *_batch(5, HOST_B)))


def _gathered(outs, prefix):
    """Every rank's shard of each state field, concatenated in rank order,
    and rank 0's metrics (each rank checks its own against the others')."""
    for o in outs[1:]:
        for k in ("solved", "max_iterations", "sum_iterations"):
            assert int(o[prefix + k]) == int(outs[0][prefix + k]), (prefix, k)
    fields = tuple(np.concatenate([o[prefix + f] for o in outs]) for f in STATE_FIELDS)
    return fields, {k: int(outs[0][prefix + k])
                    for k in ("solved", "max_iterations", "sum_iterations")}


@functools.lru_cache(maxsize=None)
def _unsharded(seed, B, mode):
    """The port's unsharded call of ``mode`` on the whole batch (NumPy)."""
    base, As, lbs, ubs = _batch(seed, B)
    struct = lt.Structure.of(base)
    args = convert.to_torch((As, lbs, ubs), "cpu") + tuple(lt.batched_initial_arrays(
        convert.hierarchy_from_numpy(base.A, base.lb, base.ub, base.dims), B, "cpu")) \
        + (torch.as_tensor(base.regularization),)
    st = _local_solver(struct, lt.ParametersLexLSI(), False, False, mode, {})(*args)
    return tuple(getattr(st, f).numpy() for f in STATE_FIELDS)


def _assert_metrics(metrics, status, it):
    assert metrics == {"solved": int((status == 0).sum()), "max_iterations": int(it.max()),
                       "sum_iterations": int(it.sum())}


def _jax_sharded(seed, B, two_d):
    """JAX's make_sharded_solver on the conftest's 8-device mesh, or
    make_sharded_solver_2d on make_host_mesh(2, 4): (x, metrics)."""
    base, As, lbs, ubs = _batch(seed, B)
    c0, s0, n0, x0, v0 = jpar.batched_initial_arrays(base, B)
    mesh = jpar.make_host_mesh(2, 4) if two_d else Mesh(np.array(jax.devices()[:8]), ("batch",))
    build = jpar.make_sharded_solver_2d if two_d else jpar.make_sharded_solver
    st, metrics = build(mesh, jli.Structure.of(base), JT.ParametersLexLSI())(
        jnp.asarray(As), jnp.asarray(lbs), jnp.asarray(ubs), c0, s0, n0, x0, v0,
        jnp.asarray(base.regularization))
    return np.asarray(st.x), {k: int(v) for k, v in metrics.items()}


@pytest.mark.parametrize("mode", MODES)
def test_sharded_solver_matches_unsharded(flat_run, mode):
    got, metrics = _gathered(flat_run, mode + "_")
    want = _unsharded(4, FLAT_B, mode)
    _assert_outs(got, want, 1e-12, f"make_sharded_solver {mode}")
    _assert_metrics(metrics, want[2], want[3])


def test_sharded_solver_xla_matches_jax(flat_run):
    got, metrics = _gathered(flat_run, "xla_")
    x, jmetrics = _jax_sharded(4, FLAT_B, two_d=False)
    assert metrics == jmetrics
    np.testing.assert_allclose(got[0], x, atol=1e-9, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_sequence_matches_jax(flat_run, mode):
    """``test_sharded_sequence_matches_single``'s checks against JAX's
    ``solve_sequence_batched``: statuses identical, v (the pivot-set
    invariant) to 1e-6, solved equal; the metrics over every step."""
    outs, metrics = _gathered(flat_run, f"seq_{mode}_")
    want = _jax_sequence_sharded_reference()
    np.testing.assert_array_equal(outs[2], want[2])
    np.testing.assert_allclose(outs[1], want[1], atol=1e-6, rtol=0)
    assert outs[0].shape == want[0].shape == (16, 3, 8)
    assert metrics["solved"] == int((want[2] == 0).sum())
    _assert_metrics(metrics, outs[2], outs[3])


@functools.lru_cache(maxsize=None)
def _jax_sequence_sharded_reference():
    base, As, lbs, ubs = _seq_sharded()
    return tuple(np.asarray(a) for a in jseq.solve_sequence_batched(
        jnp.asarray(As), jnp.asarray(lbs), jnp.asarray(ubs), jnp.asarray(base.regularization),
        struct=jli.Structure.of(base), params=JT.ParametersLexLSI()))


def test_host_mesh_refuses_a_group_of_another_size(flat_run):
    for o in flat_run:
        assert "needs 4 ranks, the process group has 2" in str(o["host_mesh_refused"])


def test_host_mesh_is_host_major(host_run):
    for r, o in enumerate(host_run):
        np.testing.assert_array_equal(o["mesh"], [[0, 1], [2, 3]])
        np.testing.assert_array_equal(o["coordinate"], [r // 2, r % 2])


@pytest.mark.parametrize("mode", MODES)
def test_sharded_solver_2d_matches_unsharded(host_run, mode):
    got, metrics = _gathered(host_run, mode + "_")
    want = _unsharded(5, HOST_B, mode)
    _assert_outs(got, want, 1e-12, f"make_sharded_solver_2d {mode}")
    _assert_metrics(metrics, want[2], want[3])


def test_sharded_solver_2d_matches_jax(host_run):
    got, metrics = _gathered(host_run, "xla_")
    x, jmetrics = _jax_sharded(5, HOST_B, two_d=True)
    assert metrics == jmetrics
    np.testing.assert_allclose(got[0], x, atol=1e-9, rtol=0)


# --- what the factories refuse and forward ----------------------------------


FACTORIES = (lt.make_sharded_solver, lt.make_sharded_solver_2d, lt.make_sharded_sequence_solver)


@pytest.mark.parametrize("build", FACTORIES, ids=lambda b: b.__name__)
def test_unknown_mode_raises(build):
    with pytest.raises(ValueError, match="unknown mode 'pallas'"):
        build(None, None, lt.ParametersLexLSI(), mode="pallas")


@pytest.mark.parametrize("knob", TPU_ONLY)
def test_tpu_only_options_raise(knob):
    for build in FACTORIES:
        with pytest.raises(lt.LexLSError, match=knob):
            build(None, None, lt.ParametersLexLSI(), mode="fused", **{knob: 1})


def test_host_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(lt.LexLSError, match="initialized process group of 4 ranks"):
        lt.make_host_mesh(2, 2, "cpu")


def test_tracked_forwards_the_tracker_options():
    """``mode="tracked"`` passes ``ns_iters`` and ``cert_tol`` to the
    tracker's cold solve."""
    base, As, lbs, ubs = _batch(4, 4)
    struct, params = lt.Structure.of(base), lt.ParametersLexLSI()
    args = convert.to_torch((As, lbs, ubs), "cpu") + tuple(lt.batched_initial_arrays(
        convert.hierarchy_from_numpy(base.A, base.lb, base.ub, base.dims), 4, "cpu"))
    kw = dict(ns_iters=1, cert_tol=1e-6)
    got = _local_solver(struct, params, False, False, "tracked", kw)(*args, None)
    want, _ = lt.solve_core_cold_tracked(*args, struct=struct, params=params, **kw)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # the cold tracker has no loop_cap (a warm step's option): refused when
    # the solver is built, not at its first call
    with pytest.raises(lt.LexLSError, match="loop_cap"):
        _local_solver(struct, params, False, False, "tracked", {"loop_cap": 1})


@pytest.mark.parametrize("build, mode, knob", [
    (lt.make_sharded_solver, "xla", "ns_iters"),
    (lt.make_sharded_solver_2d, "fused", "cert_tol"),
    (lt.make_sharded_solver, "tracked", "trip1_noext"),
    (lt.make_sharded_sequence_solver, "xla", "ns_iters"),
    (lt.make_sharded_sequence_solver, "xla", "device"),
    (lt.make_sharded_sequence_solver, "fused", "loop_cap"),
], ids=lambda v: getattr(v, "__name__", v))
def test_options_a_mode_does_not_take_raise(build, mode, knob):
    """An option that the mode's solve does not take raises ``LexLSError``
    naming it when the solver is built, before the mesh is touched."""
    with pytest.raises(lt.LexLSError, match=f"mode '{mode}' takes no option \\['{knob}'\\]"):
        build(None, None, lt.ParametersLexLSI(), mode=mode, **{knob: 1})
