"""A copy of the benchmark's files at tiny sizes, for runs on the CPU."""
from __future__ import annotations

import json
import os
import shutil

from benchmark import spec

TINY = {"cornell": {"RES": [8, 8], "DEPTH": 3},
        "alien": {"RES": [8, 8], "DEPTH": 2},
        "alien_1200_d12": {"RES": [8, 8], "DEPTH": 3}}


# The sharded cell: its mode and files are kept and tested, but the cell
# is out of BENCHMARK.json until its set-up reads steadily (PERF.md).
SHARDED = {
    "configs": [{"name": "alien_1200_d12", "source": "scenes/animal.json",
                 "file": "benchmark/configs/alien_1200_d12.json",
                 "reduced": [], "why": "a frame worth spreading over cards"}],
    "workloads": [{"name": "alien_1200_d12.sharded4",
                   "config": "alien_1200_d12", "traffic": "sharded",
                   "chips": 4, "why": "the all-gather and the imbalance"}],
    "end_to_end": [{"name": "sharded_frame_ms", "unit": "ms",
                    "better": "lower", "bound": 0.15,
                    "source": "host_clock",
                    "workloads": ["alien_1200_d12.sharded4"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": source,
         "layer": layer, "moves": "sharded_frame_ms",
         "workloads": ["alien_1200_d12.sharded4"]}
        for name, unit, source, layer in (
            ("idle_pct.sharded", "%", "device_trace", "device"),
            ("gather_ms", "ms", "host_clock", "parallel"),
            ("rank_imbalance", "ratio", "host_clock", "parallel"))],
}


def tiny_copy(dest: str, sizes: dict = TINY, pixels: int = 48) -> str:
    """BENCHMARK.json, with the sharded cell added, and the benchmark's
    data files under `dest`, every configuration cut to `sizes` and every
    check to `pixels` pixels; the scenes are the repository's. Returns
    `dest`."""
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for key, entries in SHARDED.items():
        names = {e["name"] for e in bench[key]}
        bench[key] += [e for e in entries if e["name"] not in names]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, sub),
                        os.path.join(dest, "benchmark", sub))
    os.symlink(os.path.join(spec.ROOT, "scenes"),
               os.path.join(dest, "scenes"))
    for name, ov in sizes.items():
        path = os.path.join(dest, "benchmark", "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg["overrides"] = ov
        with open(path, "w") as f:
            json.dump(cfg, f)
    wdir = os.path.join(dest, "benchmark", "workloads")
    for fn in os.listdir(wdir):
        path = os.path.join(wdir, fn)
        with open(path) as f:
            wl = json.load(f)
        wl["check"]["pixels"] = min(wl["check"]["pixels"], pixels)
        if "chunk" in wl:
            wl["chunk"] = 2
            wl["trace"] = {"skip_chunks": 0}
        else:
            wl["trace"] = {"skip_frames": 2, "frames": 3}
        if "frames" in wl["check"]:
            wl["check"]["frames"] = 8
        if "ranks" in wl:
            wl["ranks"], wl["backend"] = 2, "gloo"
        with open(path, "w") as f:
            json.dump(wl, f)
    return dest
