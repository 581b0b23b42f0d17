"""Fixtures of the benchmark's own tests: tiny cells built as new files in a
temporary copy of the benchmark's layout (``BENCHMARK.json`` beside a
``lexbench/`` folder), run on the CPU through the port's plain versions."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

F32_PARAMS = {"max_number_of_factorizations": 250, "tol_linear_dependence": 1e-07,
              "tol_wrong_sign_lambda": 0.0001, "tol_correct_sign_lambda": 1e-06,
              "tol_feasibility": 1e-05}
F64_PARAMS = {"max_number_of_factorizations": 1000, "tol_linear_dependence": 1e-12,
              "tol_wrong_sign_lambda": 1e-08, "tol_correct_sign_lambda": 1e-12,
              "tol_feasibility": 1e-13}
ENTRY_TRAFFIC = {"warm_fused": ("float32", False, 3, 1e-3),
                 "cold_fused": ("float32", False, 3, 1e-3)}


def tiny_config(dtype, simple_bounds):
    return {"name": f"tiny_{dtype}", "source": "test", "dtype": dtype, "tf32": False,
            "n_var": 12, "dims": [4, 4, 4, 4] if simple_bounds else [4, 4, 4],
            "simple_bounds": simple_bounds,
            "hierarchy": {"generator": "random_inequality_hierarchy", "seed": 5,
                          "equality_fraction": 0.1, "tight_fraction": 0.3},
            "perturbation": 0.001,
            "params": F32_PARAMS if dtype == "float32" else F64_PARAMS,
            "assumed": [], "reduced": []}


def tiny_traffic(entry, batch, limit, sample=16):
    return {"entry": entry, "why": "test", "batch": batch,
            "ring": {"length": 16, "step": 0.001, "seed": 1}, "loop": "closed", "warmup_steps": 1,
            "trace_warmup_steps": 1, "trace_steps": 2,
            "check": {"sample": sample, "limits": {"resid_gap": limit, "failed": 0}}}


def make_root(tmp_path: Path, entries=tuple(ENTRY_TRAFFIC), metrics=()):
    """A copy of BENCHMARK.json and lexbench/metrics with one tiny cell per
    entry (``tiny.<entry>``) and the extra metric readers ``metrics``
    (name -> source) added as new files and entries."""
    root = tmp_path / "lexbench"
    shutil.copytree(REPO / "lexbench" / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for entry in entries:
        dtype, sb, batch, limit = ENTRY_TRAFFIC[entry]
        cfg = tiny_config(dtype, sb)
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        if cfg["name"] not in [c["name"] for c in bench["configs"]]:
            bench["configs"].append({"name": cfg["name"], "source": "test",
                                     "file": f"lexbench/configs/{cfg['name']}.json",
                                     "reduced": [], "why": "test"})
        name = f"tiny.{entry}"
        (root / "workloads" / f"{name}.json").write_text(
            json.dumps(tiny_traffic(entry, batch, limit)))
        bench["workloads"].append({"name": name, "config": cfg["name"], "traffic": entry,
                                   "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            real = [w for w in m.get("workloads", []) if not w.startswith("tiny.")]
            kinds = {WORKLOAD_ENTRY[w] for w in real if w in WORKLOAD_ENTRY}
            if entry in kinds:
                m["workloads"].append(name)
    for name, src in dict(metrics).items():
        (root / "metrics" / f"{name}.py").write_text(src)
        bench["per_layer"].append({"name": name, "unit": "steps", "better": "higher",
                                   "source": "device_trace", "layer": "test",
                                   "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path / "BENCHMARK.json", root


WORKLOAD_ENTRY = {w.stem: json.loads(w.read_text())["entry"]
                  for w in (REPO / "lexbench" / "workloads").glob("*.json")}


@pytest.fixture
def tiny(tmp_path):
    """``tiny(entry)``: the tiny cell of that entry, loaded from a new root."""
    from lexbench.harness import spec

    def load(entry, metrics=()):
        bench_json, root = make_root(tmp_path, metrics=metrics)
        return spec.load_cell(f"tiny.{entry}", bench_json, root)

    return load
