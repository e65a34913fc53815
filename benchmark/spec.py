"""Finding a cell by name: BENCHMARK.json, the configuration and workload
files, and the metric readers that the cell reports."""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    """One cell: its entry in BENCHMARK.json, its configuration and its
    workload file, and the metrics it reports."""

    name: str
    root: str               # the checkout that holds BENCHMARK.json
    chips: int
    config_name: str
    config: dict
    workload: dict
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(entry: dict, cell: str) -> bool:
    """Whether a metric entry names `cell` (or names no cells)."""
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json; raises KeyError or
    FileNotFoundError where something it names is missing."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    workload = _json(os.path.join(root, "benchmark", "workloads",
                                  f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name, root, int(w["chips"]), w["config"], config, workload,
                e2e, layer)


def verify_files(cell: Cell) -> None:
    """The scene files the configuration pins must hold the bytes it
    names (sha256), so that a changed scene fails loudly."""
    for rel, digest in cell.config["files"].items():
        with open(cell.path(rel), "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != digest:
            raise ValueError(f"{rel}: sha256 {got}, the configuration "
                             f"pins {digest}")


def reader(cell: Cell, metric: str):
    """The `read` function of benchmark/metrics/<metric>.py, or where there
    is no such file, of the one named by the metric's name up to its first
    dot (idle_pct.py reads idle_pct.offline and idle_pct.interactive)."""
    folder = os.path.join(cell.root, "benchmark", "metrics")
    path = os.path.join(folder, f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(folder, f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_program_scene(cell: Cell, device):
    """The configuration's scene loaded by the program under test."""
    from pathtracer_tpu_torch.scene.loader import load_scene

    verify_files(cell)
    c = cell.config
    return load_scene(cell.path(c["scene"]), device,
                      overrides=c.get("overrides") or None,
                      bvh_impl=c.get("bvh_impl"))


def load_reference_scene(cell: Cell):
    """The configuration's scene parsed by the plain reference."""
    from .reference.scene import Scene

    verify_files(cell)
    return Scene(cell.path(cell.config["scene"]),
                 cell.config.get("overrides") or None)
