"""BENCHMARK.json and the files it names: every configuration, traffic and
reader loads; names and units keep to the allowed characters; a new
cell and a new per-layer metric are new files only."""

import hashlib
import json
import re

import pytest

from conftest import REPO

from lexbench.harness import spec

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
LEX = REPO / "lexbench"


def test_names_and_units_keep_to_the_allowed_characters():
    assert spec.check_names(BENCH) == []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert BENCH["command"] == ["python3", "lexbench/run.py"] and BENCH["paths"] == ["lexbench"]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_file_loads_and_is_named_by_the_rules():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in LEX.glob("workloads/*.json"):
        json.loads(w.read_text())
    for r in LEX.glob("metrics/*.py"):
        assert callable(spec.reader(LEX, r.stem))
    for f in LEX.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(f.relative_to(REPO))), f


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_and_reports_enough(cell):
    c = spec.load_cell(cell, REPO / "BENCHMARK.json")
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert c.chips == 1
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(spec.reader(c.root, m["name"]))
    for key in ("entry", "batch", "ring", "loop", "warmup_steps", "trace_steps", "check"):
        assert key in c.traffic


def test_a_new_cell_and_metric_are_new_files_only(tiny):
    """A dummy cell and a dummy per-layer metric, added as new files in a
    copy of the layout, run on the CPU; no file of the benchmark changes."""
    from lexbench.harness.cli import run_cell

    files = [p for p in LEX.rglob("*") if p.suffix in (".py", ".json", ".md")
             and "__pycache__" not in p.parts] + [REPO / "BENCHMARK.json"]
    before = {p: hashlib.sha1(p.read_bytes()).hexdigest() for p in files}
    src = "def read(t):\n    return float(t.steps) if t.steps else None\n"
    cell = tiny("warm_fused", metrics={"dummy_steps": src})
    assert "dummy_steps" in [m["name"] for m in cell.per_layer]
    res = run_cell(cell, 2 ** 31 + 11, 2.0, True, device="cpu")
    assert res["metrics"]["dummy_steps"]["value"] == 2.0
    assert "host_issue_ms.warm" in res["metrics"]
    after = {p: hashlib.sha1(p.read_bytes()).hexdigest() for p in before}
    assert before == after
