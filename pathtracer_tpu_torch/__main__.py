"""Command-line render with the port (the counterpart of render.py):

    python -m pathtracer_tpu_torch scenes/teapot.json --res 800 --spp 16 \
        --depth 4 --out teapot.png --seed 0 [--bvh wide] [--device cuda] \
        [--engine persistent] [--chunk 16] [--no-early-exit] \
        [--checkpoint ck.npz] [--width W --height H] [--no-jitter] \
        [--no-dof] [--hdr]

Renders on the CUDA device (`--device`, default "cuda"); without one it
fails rather than fall back. `--device cpu` runs on the CPU, where every
kernel's plain PyTorch version runs. `--bvh` picks the mesh intersector
(default: the loader's pick, "binned" for mesh scenes) and loads the tables
it needs. `--engine` picks the wavefront engine (default) or the persistent
one (identical images). `--checkpoint FILE` resumes from FILE if it exists
and saves the accumulation to it after rendering. Writes the PNG and prints
the time per iteration with the device it ran on; `--hdr` also writes the
Radiance .hdr beside it. `--width` / `--height` override one side of the
resolution (the other comes from `--res`); `--no-jitter` / `--no-dof` turn
off the antialiasing jitter and the thin lens.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from .ops.intersect import BVH_IMPLS
from .utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m pathtracer_tpu_torch")
    ap.add_argument("scene")
    ap.add_argument("--res", type=int, default=None,
                    help="override square resolution")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None,
                    help="override ITERATIONS")
    ap.add_argument("--depth", type=int, default=None, help="override DEPTH")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=16,
                    help="iterations between progress points (checkpoints)")
    ap.add_argument("--no-jitter", action="store_true")
    ap.add_argument("--no-dof", action="store_true")
    ap.add_argument("--hdr", action="store_true", help="also save .hdr")
    ap.add_argument("--no-early-exit", action="store_true",
                    help="run every bounce, even when no path is live")
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="checkpoint file: resumes from it if present, and "
                         "saves to it after rendering")
    ap.add_argument("--bvh", choices=BVH_IMPLS, default=None,
                    help="mesh intersector override (default: the loader's "
                         "pick)")
    ap.add_argument("--engine", choices=("wavefront", "persistent"),
                    default="wavefront",
                    help="wavefront: masked fixed-pool bounce loop. "
                         "persistent: rotating work-queue lanes (identical "
                         "images)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    args = ap.parse_args(argv)
    if (args.width is None) != (args.height is None) and args.res is None:
        ap.error("--width and --height need each other or --res")

    import dataclasses

    from . import load_scene, render, render_persistent
    from .io.image import reference_style_name, save_hdr, save_png
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    device = resolve_device(args.device)
    overrides = {}
    if args.res is not None:
        overrides["RES"] = [args.res, args.res]
    if args.width is not None or args.height is not None:
        overrides["RES"] = [args.width or args.res, args.height or args.res]
    if args.spp is not None:
        overrides["ITERATIONS"] = args.spp
    if args.depth is not None:
        overrides["DEPTH"] = args.depth
    scene, settings = load_scene(args.scene, device,
                                 overrides=overrides or None,
                                 bvh_impl=args.bvh)
    if args.no_jitter or args.no_dof:
        settings = dataclasses.replace(settings, jitter=not args.no_jitter,
                                       dof=not args.no_dof)

    start_iteration, accum, seed = 0, None, args.seed
    if args.checkpoint and os.path.exists(args.checkpoint):
        accum, start_iteration, seed = load_checkpoint(
            args.checkpoint, settings, device)
        print(f"resuming from {args.checkpoint} at {start_iteration} spp")

    final = {}

    def progress(done, a):
        final.update(done=done, accum=a)

    t0 = time.perf_counter()
    if args.engine == "persistent":
        # persistent chunks drain fully, so every chunk boundary is a
        # checkpoint, as with the wavefront engine
        img = render_persistent(scene, settings, seed=seed,
                                chunk=max(args.chunk, 32), progress=progress,
                                accum=accum, start_iteration=start_iteration)
    else:
        img = render(scene, settings, seed=seed, chunk=args.chunk,
                     early_exit=not args.no_early_exit, accum=accum,
                     start_iteration=start_iteration, progress=progress)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if args.checkpoint and final:
        save_checkpoint(args.checkpoint, final["accum"], final["done"],
                        settings, seed=seed)
        print(f"checkpoint -> {args.checkpoint} ({final['done']} spp)")
    name = args.out or reference_style_name(
        settings.image_name, start_iteration + settings.iterations)
    save_png(img, name)
    if args.hdr:
        save_hdr(img, name.rsplit(".", 1)[0] + ".hdr")
    print(f"{settings.width}x{settings.height} d{settings.trace_depth} "
          f"{settings.iterations} iterations on {device.type}, bvh "
          f"{settings.bvh_impl}: "
          f"{1000.0 * dt / max(settings.iterations, 1):.2f} ms/iteration "
          f"({args.engine} engine) -> {name}")


if __name__ == "__main__":
    main()
