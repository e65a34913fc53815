"""Differentiable-rendering demo on one device: recover the IOR from a
target render by gradient descent through the path tracer (the port of
tools/fit_ior.py).

    python -m pathtracer_tpu_torch.tools.fit_ior [scene.json] [--steps 60] \
        [--res 32] [--depth 6] [--spp 4] [--lr-ior 0.08] \
        [--perturb-ior 0.2] [--device cuda]

The IOR gradient carries the Fresnel reflect/transmit probability channel
(ops/bsdf.py _branch_prob_surrogate) and the continuous dependence of the
refracted direction; it does not carry visibility discontinuities. The
default scene (scenes/glass_slab.json, a glass slab before an emitting
wall) is built so that the transmission channel dominates the loss.

Each step averages `spp` fixed-depth iterations rendered with the seed of
one of 4 targets (common random numbers, cycled), clips the gradient to
+-2, applies momentum 0.6, steps, clamps to [1.05, 3] and keeps the IOR of
the non-refractive materials. Exits 0 when the mean IOR error ends below
half of where it started, else 1. Runs on the CUDA device unless
`--device` says otherwise.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..engine.wavefront import render_iteration, zero_accum
from ..scene.types import RenderSettings, SceneArrays
from ..utils.vec import Vec3
from ..utils.grad import value_and_grad, with_materials

N_SEEDS = 4       # the target pool
GRAD_CLIP = 2.0   # the surrogate's gradient spikes
MOMENTUM = 0.6
IOR_RANGE = (1.05, 3.0)


def render_avg(scene: SceneArrays, settings: RenderSettings, spp: int,
               seed: int) -> Vec3:
    """The mean of iterations 1..spp (fixed depth), in lane order."""
    accum = zero_accum(settings, scene.device)
    for k in range(spp):
        accum = render_iteration(scene, settings, accum, k + 1, seed=seed,
                                 early_exit=False)
    return accum * (1.0 / spp)


def ior_fit_step(scene: SceneArrays, settings: RenderSettings,
                 ior: torch.Tensor, vel: torch.Tensor, target: Vec3,
                 seed: int, spp: int, lr: float):
    """One momentum step on the IOR of the refractive materials against
    `target` (tools/fit_ior.py step). Returns (ior, vel, loss)."""
    refr = scene.materials.has_refractive > 0

    def loss_fn(ior):
        img = render_avg(with_materials(scene, ior=ior), settings, spp, seed)
        d = img - target
        return (d.x * d.x + d.y * d.y + d.z * d.z).mean()

    loss, g = value_and_grad(loss_fn, ior)
    g = torch.clamp(g, -GRAD_CLIP, GRAD_CLIP)
    vel = MOMENTUM * vel + g * refr.to(g.dtype)
    new = torch.clamp(ior - lr * vel, *IOR_RANGE)
    return torch.where(refr, new, scene.materials.ior), vel, loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.fit_ior")
    ap.add_argument("scene", nargs="?", default=None)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--spp", type=int, default=4, help="spp per SGD step")
    ap.add_argument("--lr-ior", type=float, default=0.08)
    ap.add_argument("--perturb-ior", type=float, default=0.2)
    ap.add_argument("--device", default="cuda",
                    help="torch device to fit on (default cuda)")
    args = ap.parse_args(argv)

    from .. import load_scene
    from ..scene.fixtures import scene_path
    from ..utils.debug import validate_iteration
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    path = args.scene or scene_path("glass_slab")
    scene, settings = load_scene(path, device, overrides={
        "RES": [args.res, args.res], "DEPTH": args.depth})
    refr = scene.materials.has_refractive > 0
    if not bool(refr.any()):
        raise ValueError(f"{path}: no refractive material to fit")
    print(f"device: {device.type}  scene: {path} {args.res}x{args.res} "
          f"d{args.depth} refractive materials: "
          f"{torch.nonzero(refr)[:, 0].tolist()}")

    validate_iteration(scene, settings)
    with torch.no_grad():
        targets = [render_avg(scene, settings, args.spp, s)
                   for s in range(N_SEEDS)]
    true_ior = scene.materials.ior
    ior = torch.where(refr, true_ior + args.perturb_ior, true_ior)

    def ior_err(x):
        return float((x - true_ior).abs()[refr].mean())

    err0 = ior_err(ior)
    vel = torch.zeros_like(ior)
    for k in range(args.steps):
        ior, vel, loss = ior_fit_step(scene, settings, ior, vel,
                                      targets[k % N_SEEDS], k % N_SEEDS,
                                      args.spp, args.lr_ior)
        if k % 10 == 0 or k == args.steps - 1:
            print(f"step {k:3d}: loss={float(loss):.6f} "
                  f"ior_err={ior_err(ior):.4f}")
    err = ior_err(ior)
    print(f"ior error: {err0:.4f} -> {err:.4f} "
          f"({'RECOVERED' if err < 0.4 * err0 else 'partial'})")
    return 0 if err < 0.5 * err0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
