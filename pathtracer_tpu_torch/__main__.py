"""Command-line render with the port (the counterpart of render.py):

    python -m pathtracer_tpu_torch scenes/teapot.json --res 800 --spp 16 \
        --depth 4 --out teapot.png --seed 0

Renders on the first CUDA device when there is one, else on the CPU (where
the kernels' plain PyTorch versions run), writes the PNG, and prints the
time per iteration with the device it ran on.
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m pathtracer_tpu_torch")
    ap.add_argument("scene")
    ap.add_argument("--res", type=int, default=None,
                    help="override square resolution")
    ap.add_argument("--spp", type=int, default=None,
                    help="override ITERATIONS")
    ap.add_argument("--depth", type=int, default=None, help="override DEPTH")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from . import load_scene, render
    from .io.image import reference_style_name, save_png

    device = "cuda" if torch.cuda.is_available() else "cpu"
    overrides = {}
    if args.res is not None:
        overrides["RES"] = [args.res, args.res]
    if args.spp is not None:
        overrides["ITERATIONS"] = args.spp
    if args.depth is not None:
        overrides["DEPTH"] = args.depth
    scene, settings = load_scene(args.scene, device,
                                 overrides=overrides or None)

    t0 = time.perf_counter()
    img = render(scene, settings, seed=args.seed)
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    name = args.out or reference_style_name(settings.image_name,
                                            settings.iterations)
    save_png(img, name)
    print(f"{settings.width}x{settings.height} d{settings.trace_depth} "
          f"{settings.iterations} iterations on {device}: "
          f"{1000.0 * dt / max(settings.iterations, 1):.2f} ms/iteration "
          f"-> {name}")


if __name__ == "__main__":
    main()
