"""Per-stage timings and ray-survival counts of a scene, for the port (the
counterpart of the repo's tools/perfstats.py; the reference's EVALUATION
and PRINT_RAY_COUNT output, pathtrace.cu:629-673,746-750):

    python -m pathtracer_tpu_torch.tools.perfstats [scene.json] [--res N] \
        [--depth N] [--bvh IMPL] [--iters N] [--device cuda]

Prints the scene line, the live rays after each bounce of iteration 10,
and `measure_stages`' table (utils/profiling.py). Runs on the CUDA device
unless `--device cpu`.
"""
from __future__ import annotations

import argparse

import torch

from ..ops.intersect import BVH_IMPLS
from ..utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.perfstats")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene JSON (default: the Cornell box)")
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--bvh", choices=BVH_IMPLS, default=None,
                    help="mesh intersector (default: the loader's pick)")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls of each stage and frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    from ..scene.fixtures import scene_path
    from ..scene.loader import load_scene
    from ..utils.profiling import measure_stages, ray_survival_report

    device = resolve_device(args.device)
    overrides = {}
    if args.res:
        overrides["RES"] = [args.res, args.res]
    if args.depth:
        overrides["DEPTH"] = args.depth
    path = args.scene or scene_path("cornell")
    scene, settings = load_scene(path, device, overrides=overrides or None,
                                 bvh_impl=args.bvh)
    print(f"scene: {path} {settings.width}x{settings.height} "
          f"d{settings.trace_depth} bvh {settings.bvh_impl} on {device}")
    with torch.inference_mode():
        print(ray_survival_report(scene, settings))
        print()
        print(measure_stages(scene, settings, iters=args.iters).table())


if __name__ == "__main__":
    main()
