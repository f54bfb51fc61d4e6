"""Everything a cell is made of, found by name.

`BENCHMARK.json` at the root of the checkout names the cells, the
configurations and the metrics.  Each piece is a file of its own under
`benchmark/`, so a cell, a traffic mix or a metric is added by adding files
and entries, never by editing a file that is there:

- a configuration: the JSON file that its `BENCHMARK.json` entry names
  (`configs/<name>.json`), with its geometry `geometries/<geometry>.py`
  and its kernel formula `kernels/<kernel>.py` beside it;
- a traffic mix: `traffic/<traffic>.json`, whose `kind` names the general
  generator `kinds/<kind>.py` that reads it;
- the limits of a cell's correctness check: `limits/<workload>.json`;
- a metric, end-to-end or per-layer: its reader `metrics/<name>.py`.  A
  name `<quantity>.<qualifier>` without a file of its own is read by
  `metrics/<quantity>.py`: the qualifier only tells apart the same quantity
  under the end-to-end metrics of different cells, each with its own bound.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(ValueError):
    """A name that BENCHMARK.json or the files under benchmark/ lack."""


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path} does not exist")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file at `path`, imported under a private module name (file
    names carry dots and dashes, so they are not importable by name)."""
    if not path.is_file():
        raise SpecError(f"{path} does not exist")
    modname = "_bench_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of BENCHMARK.json with every file it needs read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)

    def kind(self):
        return load_module(BENCH_DIR / "kinds" / f"{self.traffic['kind']}.py",
                           "kind." + self.traffic["kind"])

    def geometry(self):
        return load_module(
            BENCH_DIR / "geometries" / f"{self.config['geometry']}.py",
            "geometry." + self.config["geometry"])

    def kernel(self):
        return load_module(
            BENCH_DIR / "kernels" / f"{self.config['kernel']['name']}.py",
            "kernel." + self.config["kernel"]["name"])


def metric_reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH_DIR / "metrics" / f"{name.split('.', 1)[0]}.py"
    return load_module(path, "metric." + path.stem)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {workload!r} names the configuration "
                        f"{w['config']!r}, which BENCHMARK.json lacks")
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{workload}.json")
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, workload)])
