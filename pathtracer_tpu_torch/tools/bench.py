"""The port's headline benchmark (the counterpart of the repo's bench.py):
prints ONE JSON line.

    python -m pathtracer_tpu_torch.tools.bench [--device cuda] [--res N] \
        [--depth N]

`value` is Cornell 800x800 d8 ms/frame (the best of 3 chunks of 50
iterations after 2 warm-up chunks) against the reference CUDA tracer's
published 35.18 ms at the same config (RTX 3060 Laptop, BASELINE.md
"Frame time, defaults"); `vs_baseline` is value / 35.18. `extra` has the
JAX line's keys, with the same chunks, warm-ups and reps: the sorted mode
(reference 42.95 ms) and the teapot and animal scenes at their checked-in
800x800 d4 configs (reference 17 and 22 ms), with primary Mrays/s; and
beside each best, the median of its timed chunks (`*_median_ms`). `device`
is the card's name and power limit. A scene that raises is recorded in
`extra` as `<name>_error`, as the JAX line records it, and the process then
exits 1 after printing the line. `--res` / `--depth` cut every scene's
size (for a short run on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ..scene.fixtures import scene_path
from ..scene.loader import load_scene
from .bench_suite import bench_wavefront, card

BASELINE_MS = 35.18   # Cornell 800x800 d8, compaction on, AA off
SORTED_REF_MS = 42.95  # BASELINE.md "Material sort"
TEAPOT_REF_MS = 17.0  # BASELINE.md BVH SAH table
ALIEN_REF_MS = 22.0


def bench(scene, settings, chunk: int, warmup: int = 2, reps: int = 3):
    """`warmup` chunks, then `reps` timed chunks from iteration 1 on; the
    Timing of the timed ones."""
    return bench_wavefront(scene, settings, chunk=chunk, reps=reps,
                           warmup=warmup)[0]


def device_info(device) -> dict:
    """{"name", "power_limit"} of the card (the CPU: no limit)."""
    name, _, limit = card(device).partition(", ")
    return {"name": name, "power_limit": limit or None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.bench")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--res", type=int, default=None,
                    help="cut every scene to N x N")
    ap.add_argument("--depth", type=int, default=None,
                    help="cut every scene to this trace depth")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device
    device = resolve_device(args.device)
    size = {}
    if args.res:
        size["RES"] = [args.res, args.res]
    if args.depth:
        size["DEPTH"] = args.depth
    if device.type == "cuda":
        from ..ops import kernels
        kernels.library()      # the build stays out of the timed chunks

    scene, settings = load_scene(scene_path("cornell"), device,
                                 overrides=size or None)
    if not size and (settings.width, settings.trace_depth) != (800, 8):
        raise ValueError("scenes/cornell.json is not 800x800 d8")
    cornell = bench(scene, settings, chunk=50)
    extra = {
        "cornell_mrays_s": round(settings.pixel_count / cornell.best / 1e3,
                                 1),
        "cornell_median_ms": round(cornell.median, 3),
    }
    try:
        s_sorted = dataclasses.replace(settings, sort_materials=True)
        t = bench(scene, s_sorted, chunk=10, warmup=1, reps=2)
        extra["cornell_sorted_ms_per_frame"] = round(t.best, 3)
        extra["cornell_sorted_vs_ref"] = round(t.best / SORTED_REF_MS, 3)
        extra["cornell_sorted_median_ms"] = round(t.median, 3)
    except Exception as e:   # recorded as the JAX line does; exits 1
        extra["cornell_sorted_error"] = f"{type(e).__name__}: {e}"[:120]
    for name, ref_ms in (("teapot", TEAPOT_REF_MS), ("animal", ALIEN_REF_MS)):
        try:
            scene, settings = load_scene(scene_path(name), device,
                                         overrides=size or None)
            t = bench(scene, settings, chunk=4, warmup=1, reps=2)
            extra[f"{name}_ms_per_frame"] = round(t.best, 3)
            extra[f"{name}_vs_ref"] = round(t.best / ref_ms, 3)
            extra[f"{name}_mrays_s"] = round(
                settings.pixel_count / t.best / 1e3, 1)
            extra[f"{name}_median_ms"] = round(t.median, 3)
        except Exception as e:   # recorded as the JAX line does; exits 1
            extra[f"{name}_error"] = f"{type(e).__name__}: {e}"[:120]

    print(json.dumps({
        "metric": "cornell_800x800_d8_ms_per_frame",
        "value": round(cornell.best, 3),
        "unit": "ms",
        "vs_baseline": round(cornell.best / BASELINE_MS, 4),
        "extra": extra,
        "device": device_info(device),
    }))
    return 1 if any(k.endswith("_error") for k in extra) else 0


if __name__ == "__main__":
    sys.exit(main())
