"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root
of the checkout, the configuration's file, the traffic file
``workloads/<cell>.json`` and one reader ``metrics/<metric>.py`` for each
per-layer metric.  Nothing here knows a cell, a configuration or a metric
by name: a new one is new files and new entries in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List

LEXBENCH = Path(__file__).resolve().parents[1]  # the folder of the benchmark
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(RuntimeError):
    pass


@dataclass
class Cell:
    name: str
    root: Path                  # the folder that holds configs/, workloads/, metrics/
    entry: dict                 # the cell's entry in BENCHMARK.json
    config: dict                # the configuration's file
    traffic: dict               # workloads/<cell>.json
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_json(path: Path) -> dict:
    try:
        return json.loads(Path(path).read_text())
    except FileNotFoundError:
        raise SpecError(f"missing file: {path}") from None


def reports(metric: dict, cell: str, e2e_of_cell: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` key
    lists or, without the key, an end-to-end metric in every cell and a
    per-layer metric in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def load_cell(name: str, bench_json: Path, root: Path = LEXBENCH) -> Cell:
    """The cell ``name`` of ``bench_json``, its files looked up under ``root``."""
    bench = load_json(bench_json)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no cell {name!r} in {bench_json}: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    config = load_json(bench_json.parent / cfg_entry["file"])
    traffic = load_json(root / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, root=root, entry=entry, config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def reader(root: Path, metric: str) -> Callable:
    """The ``read(trace)`` function of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"no reader for the per-layer metric {metric!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "lexbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_names(bench: dict) -> List[str]:
    """The names and units of ``bench`` outside the characters a name or unit may use."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in bench[group]:
            if not NAME.match(item["name"]):
                bad.append(f"{group}: name {item['name']!r}")
            if "unit" in item and not UNIT.match(item["unit"]):
                bad.append(f"{group}: unit {item['unit']!r}")
            for key in ("config", "traffic"):
                if key in item and not NAME.match(item[key]):
                    bad.append(f"{group}: {key} {item[key]!r}")
            for key in item.get("reduced", []):
                if not NAME.match(key):
                    bad.append(f"{group}: reduced key {key!r}")
    return bad

