"""Finding a cell's parts by the names `BENCHMARK.json` gives them: the
configuration, the traffic mix, the per-layer metrics' readers, the input
kinds, the comparison and the plain reference each sit in files of their
own under this folder, so that a new cell, configuration, mix or metric is
new files and entries, never an edit."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


def load_module(path: Path) -> ModuleType:
    """Import the file at `path` under a name of its own (a metric's file
    name holds dots, so it is loaded by path, not by package)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    name = f"bench_h100_{path.parent.name}_{path.stem}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                       # configs/<name>.json
    traffic: dict                      # traffic/<name>.json
    size: List[int]                    # the output's (width, height)
    work: dict                         # the frozen work at that size
    metrics: Dict[str, dict] = field(default_factory=dict)  # per-layer
    root: Path = HERE

    def reference(self) -> ModuleType:
        return load_module(self.root / "reference" / f"{self.config['name']}.py")

    def compare(self) -> ModuleType:
        return load_module(self.root / "compare"
                           / f"{self.config['check']['kind']}.py")

    def input_kind(self, kind: str) -> ModuleType:
        return load_module(self.root / "inputs" / f"{kind}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "metrics" / f"{metric}.py")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(benchmark: dict, workload: str, root: Path = HERE) -> Cell:
    """The cell named `workload` with its configuration, mix and per-layer
    metrics (those that name it under `workloads`, or name no cells)."""
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has "
                       + ", ".join(sorted(cells)))
    w = cells[workload]
    config = load_json(root / "configs" / f"{w['config']}.json")
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    size_class = traffic["size"]
    if size_class not in config["sizes"]:
        raise KeyError(f"configuration {w['config']} has no size "
                       f"{size_class!r} for traffic {w['traffic']}")
    metrics = {m["name"]: m for m in benchmark["per_layer"]
               if workload in m.get("workloads", [workload])}
    return Cell(workload, int(w["chips"]), config, traffic,
                list(config["sizes"][size_class]),
                config.get("work", {}).get(size_class, {}), metrics, root)
