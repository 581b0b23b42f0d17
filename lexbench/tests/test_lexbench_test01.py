"""The configuration ``test01_f64`` and its cell ``test01_f64.warm_b384``:
both load through ``spec``; the bound level's rows stay unit rows under
the perturbation and the drift ring at the full shape; a tiny copy of the
cell (its configuration with fewer variables and rows, its traffic with a
smaller batch and ring) is correct on the CPU, and reads not correct when
every answer is altered."""

import dataclasses

import pytest
import torch

from conftest import REPO
from test_lexbench_checks import altered

from lexbench.harness import spec, traffic
from lexbench.harness.cli import run_cell

CELL = "test01_f64.warm_b384"


@pytest.fixture
def cell():
    return spec.load_cell(CELL, REPO / "BENCHMARK.json")


def tiny(cell):
    config = dict(cell.config, n_var=16, dims=[12, 6, 2, 2, 18])
    tr = dict(cell.traffic, batch=3, ring=dict(cell.traffic["ring"], length=16),
              warmup_steps=1, trace_warmup_steps=1, trace_steps=2,
              check=dict(cell.traffic["check"], sample=8))
    return dataclasses.replace(cell, config=config, traffic=tr)


def test_the_configuration_and_cell_load(cell):
    cfg = cell.config
    assert cell.entry["config"] == cfg["name"] == "test01_f64" and cell.chips == 1
    assert (cfg["n_var"], cfg["dims"], cfg["simple_bounds"]) == (88, [74, 33, 3, 2, 97], True)
    assert (cfg["dtype"], cfg["tf32"], cfg["reduced"]) == ("float64", False, [])
    assert cell.traffic["entry"] == "warm_fused" and cell.traffic["batch"] == 384
    assert cell.traffic["check"]["limits"] == {"resid_gap": 1e-8, "failed": 0}
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"warm_solves_per_s", "warm_step_ms_p95", "setup_s", "b2_waves.warm",
            "b2_blocks_per_sm.warm", "b2_ms_per_step.warm"} <= names


def test_the_bound_rows_stay_unit_rows(cell):
    inp = traffic.make_inputs(cell.config, dict(cell.traffic, batch=2), 2 ** 33 + 1,
                              torch.float64, "cpu")
    d0 = len(inp.raw.var_idx)
    assert d0 == 74 and inp.base.shape == (2, 209, 88)
    unit = torch.zeros(d0, 88, dtype=torch.float64)
    unit[torch.arange(d0), torch.as_tensor(inp.raw.var_idx)] = 1.0
    for t in (0, 1, 511, 1023):
        A = inp.A(t)
        assert torch.equal(A[:, :d0], unit.expand(2, -1, -1))
        assert (A[:, d0:] != torch.as_tensor(inp.raw.A[d0:])).all()  # general rows move


def test_a_tiny_copy_of_the_cell_is_correct(cell):
    res = run_cell(tiny(cell), 2 ** 33 + 7, 0.5, False, device="cpu")
    assert res["correct"] and res["failed"] == 0, res["_extra"]["readings"]["gaps"]
    assert res["_extra"]["compared"]["resid_gap"][0] <= 1e-8


def test_altered_answers_are_not_correct(cell):
    res = run_cell(tiny(cell), 2 ** 33 + 7, 0.5, False, device="cpu", fault=altered)
    assert not res["correct"], res["_extra"]["readings"]["gaps"]
    assert res["failed"] == 0 and res["_extra"]["compared"]["resid_gap"][0] > 1e-8
