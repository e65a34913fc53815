"""The control of the check: the plain reference in bfloat16 put in the
program's place, judged by the cell's own check against the float32
reference. Each of its numbers has to exceed the cell's limit.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        --iterations N          (offline and sharded cells)
        --frames F              (the interactive cell)

For each seed it builds what a run of the cell would hand the check (the
pixels drawn from the seed; N iterations, or the seed's first F frames of
moves), fills it with the bfloat16 reference's values, and prints one
JSON line of the check's numbers and limits. The benchmark's runs never
run it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import numpy as np
import torch

from . import spec
from .outcome import Outcome, Run


def control_outcome(run: Run, iterations: int = 0, frames: int = 0
                    ) -> Outcome:
    """What the check reads, with the bfloat16 reference's values."""
    from .reference import tracer
    from .traffic import reference_average, sample
    cell, dev = run.cell, torch.device(run.device)
    scene = spec.load_reference_scene(cell)
    low = tracer.Tables(scene, dev, torch.bfloat16)
    n_pix = scene.width * scene.height
    pixels = sample(run.seed, 1, n_pix, int(cell.workload["check"]["pixels"]))
    mode = cell.workload["mode"]
    if mode in ("offline", "sharded"):
        cams = {k: v[None] for k, v in scene.startup_camera().items()}
        values = reference_average(low, cams, 0, pixels, iterations,
                                   run.seed).float().cpu().numpy()
        answers = {"iterations": iterations, "pixels": pixels,
                   "values": values}
    else:
        from .traffic import interactive as it
        _, plans, epochs = it.plan(run.seed, cell.workload,
                                   it.scene_block(cell), frames)
        log = [(e, m, None) for e, m in plans]
        answers = {"frames": log, "epochs": epochs, "pixels": pixels}
        chosen = it.chosen_frames(run.seed, answers,
                                  int(cell.workload["check"]["frames"]))
        for j, vals in zip(chosen, it.reference_frames(low, scene, answers,
                                                       chosen, run.seed)):
            log[j] = (log[j][0], log[j][1], vals)
    return Outcome({}, 0, 0, 0, "", answers)


def main(argv=None, root: str = spec.ROOT, device: str = "cuda") -> list:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--iterations", type=int, default=0)
    ap.add_argument("--frames", type=int, default=0)
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload, root)
    mode = importlib.import_module(
        f"benchmark.traffic.{cell.workload['mode']}")
    lines = []
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(cell, seed, 0.0, False, device, t0)
        checks = mode.check(run, control_outcome(run, a.iterations,
                                                 a.frames))
        line = {"cell": cell.name, "seed": seed, "control": {
            k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
            "fails": not all(v <= lim for v, lim in checks.values()),
            "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    sys.exit(0 if all(x["fails"] for x in main()) else 1)
