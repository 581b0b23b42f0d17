"""The check fails what it must.  Each fault breaks the timed path of a
tiny cell underneath a CPU run (no card) and ``correct`` comes out false;
the control (a step down in precision) reads above each cell's limit."""

import dataclasses
import json

import pytest
import torch

from conftest import REPO

from lexbench.harness import check, spec, traffic
from lexbench.harness.cli import run_cell


def unchanged(entry, out):
    """The step returns the state it started from."""
    if entry.traffic["entry"] == "cold_fused":
        return dataclasses.replace(out, x=entry.x0)
    return entry.state


def half_left_out(entry, out):
    """Half of the batch is not solved: those instances keep their input x."""
    x_in = entry.x0 if entry.traffic["entry"] == "cold_fused" else entry.state.x
    keep = (torch.arange(out.x.shape[0]) % 2 == 0)[:, None]
    return dataclasses.replace(out, x=torch.where(keep, out.x, x_in))


def altered(entry, out):
    """Every answer is altered where it is produced."""
    x = out.x.clone()
    x[:, 0] += 0.05
    return dataclasses.replace(out, x=x)


def one_unsolved(entry, out):
    """One instance of every step ends unsolved, its answer left as it is:
    only the window's ``failed`` count can see it."""
    status = out.status.clone()
    status[-1] = 2
    return dataclasses.replace(out, status=status)


FAULTS = [(e, f) for e in ("warm_fused", "cold_fused")
          for f in (unchanged, half_left_out, altered, one_unsolved)]


@pytest.mark.parametrize("entry", ["warm_fused", "cold_fused"])
def test_a_sound_run_is_correct(tiny, entry):
    res = run_cell(tiny(entry), 2 ** 31 + 17, 0.5, False, device="cpu")
    assert res["correct"] and res["failed"] == 0, res["_extra"]["readings"]
    assert res["_extra"]["compared"]["failed"] == (0, 0)


@pytest.mark.parametrize("entry,fault", FAULTS, ids=[f"{e}-{f.__name__}" for e, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, entry, fault):
    res = run_cell(tiny(entry), 2 ** 31 + 17, 0.5, False, device="cpu", fault=fault)
    assert not res["correct"], res["_extra"]["readings"]["gaps"]
    if fault is one_unsolved:
        assert res["failed"] == res["_extra"]["steps"] > 0
        assert res["_extra"]["compared"]["resid_gap"][0] <= 1e-3


def test_a_run_with_tf32_products_prints_no_result(tiny):
    """The configuration states TF32 off; a run in which the port left it on
    raises instead of printing a result."""
    def tf32_on(entry, out):
        torch.backends.cuda.matmul.allow_tf32 = True
        return out

    try:
        with pytest.raises(RuntimeError, match="TF32"):
            run_cell(tiny("warm_fused"), 2 ** 31 + 19, 0.3, False, device="cpu", fault=tf32_on)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_tf32_control_fails_the_float32_cells_limit():
    """The reference with TF32 products, on instances of ik100_f32 at its
    own size, reads above the limit of its cells."""
    bench = REPO / "BENCHMARK.json"
    cell = spec.load_cell("ik100_f32.warm_b384", bench)
    tr = dict(cell.traffic, batch=2)
    inp = traffic.make_inputs(cell.config, tr, 2 ** 31 + 5, torch.float32, "cpu")
    lb, ub = inp.lb.double().numpy(), inp.ub.double().numpy()
    problems = [(inp.instance(t, b), lb, ub) for t, b in ((3, 0), (700, 1))]
    refs = check.solve_all(problems, cell.config)
    ctl = check.solve_all(problems, cell.config, precision="tf32")
    gaps = [check.gap(A, lb, ub, cell.config["dims"], c[0], r[0])
            for (A, lb, ub), c, r in zip(problems, ctl, refs)]
    for name in ("ik100_f32.warm_b384", "ik100_f32.cold_b10240"):
        limit = json.loads((REPO / f"lexbench/workloads/{name}.json").read_text())
        assert min(gaps) > limit["check"]["limits"]["resid_gap"], gaps


def test_reference_workers_agree_and_leave_no_process():
    """The reference's worker processes give the serial answers, in order,
    and have all ended when ``solve_all`` returns."""
    from lexbench.harness.cli import live_children

    cell = spec.load_cell("ik100_f32.warm_b384", REPO / "BENCHMARK.json")
    inp = traffic.make_inputs(cell.config, dict(cell.traffic, batch=2), 2 ** 31 + 7,
                              torch.float32, "cpu")
    lb, ub = inp.lb.double().numpy(), inp.ub.double().numpy()
    problems = [(inp.instance(t, b), lb, ub) for t, b in ((5, 1), (400, 0), (9, 0))]
    serial = check.solve_all(problems, cell.config, workers=1)
    pooled = check.solve_all(problems, cell.config, workers=2)
    assert live_children() == []
    for (xs, ss, its), (xp, sp, itp) in zip(serial, pooled):
        assert (xs == xp).all() and (ss, its) == (sp, itp)
