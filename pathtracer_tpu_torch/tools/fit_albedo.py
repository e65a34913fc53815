"""Differentiable-rendering demo on one device: recover the material
albedos from a target render by gradient descent through the path tracer
(the port of tools/fit_albedo.py).

    python -m pathtracer_tpu_torch.tools.fit_albedo [scene.json] \
        [--steps 40] [--res 64] [--depth 4] [--lr 1.0] [--perturb 0.25] \
        [--device cuda]

Renders the target with the true albedos (iteration 1, seed 0), perturbs
them (numpy seed 0, +-perturb, clipped to [0.02, 0.98]), checks one
iteration for NaN/Inf (utils/debug.validate_iteration), then runs SGD steps
whose gradient runs back through the whole bounce loop. Every step renders
with the target's random numbers, so the loss is zero at the true albedos.
Runs on the CUDA device unless `--device` says otherwise.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..engine.wavefront import render_iteration, zero_accum
from ..scene.types import RenderSettings, SceneArrays
from ..utils.vec import Vec3
from ..utils.grad import value_and_grad, with_materials


def albedo_loss(scene: SceneArrays, settings: RenderSettings, target: Vec3,
                iteration: int, seed: int = 0, pixel_offset: int = 0,
                key_salt=None):
    """The fit's loss as a function of the albedo table: one fixed-depth
    iteration, L2 against `target` (lane order) over 3 * pixel_count.
    `target` may be a shard's block of the image, whose first lane is
    global lane `pixel_offset`, with `key_salt` its shard index: the loss is
    then that shard's share of the whole image's loss
    (parallel/sharding.albedo_fit_step sums them)."""
    def loss_fn(albedo):
        img = render_iteration(with_materials(scene, color=albedo), settings,
                               zero_accum(settings, scene.device,
                                          n=target.x.shape[0]),
                               iteration, seed=seed, early_exit=False,
                               pixel_offset=pixel_offset, key_salt=key_salt)
        d = img - target
        return (d.x * d.x + d.y * d.y + d.z * d.z).sum() / (
            3.0 * settings.pixel_count)
    return loss_fn


def albedo_fit_step(scene: SceneArrays, settings: RenderSettings,
                    target: Vec3, iteration: int, lr: float = 0.5,
                    seed: int = 0):
    """One SGD step on the material albedos: `albedo_loss`, backprop
    through the bounce loop, step and clip to [0, 1]. Returns (new_scene,
    loss). The single-device body of pathtracer_tpu/parallel/sharding.py
    albedo_fit_step."""
    loss, g = value_and_grad(
        albedo_loss(scene, settings, target, iteration, seed),
        scene.materials.color)
    return sgd_albedo(scene, g, lr), loss


def sgd_albedo(scene: SceneArrays, g: torch.Tensor, lr: float
               ) -> SceneArrays:
    """The fit's update: albedo - lr * g, clipped to [0, 1]."""
    new_color = torch.clamp(scene.materials.color - lr * g, 0.0, 1.0)
    return with_materials(scene, color=new_color)


def perturbed_albedo(true_albedo: np.ndarray, perturb: float,
                     seed: int = 0) -> np.ndarray:
    """The fit's starting point: true +- U(perturb), clipped to
    [0.02, 0.98] (numpy's default_rng(seed))."""
    rng = np.random.default_rng(seed)
    return np.clip(true_albedo + rng.uniform(-perturb, perturb,
                                             true_albedo.shape), 0.02, 0.98)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.fit_albedo")
    ap.add_argument("scene", nargs="?", default=None)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--perturb", type=float, default=0.25)
    ap.add_argument("--device", default="cuda",
                    help="torch device to fit on (default cuda)")
    args = ap.parse_args(argv)

    from .. import load_scene
    from ..scene.fixtures import scene_path
    from ..utils.debug import validate_iteration
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    path = args.scene or scene_path("cornell")
    scene, settings = load_scene(path, device, overrides={
        "RES": [args.res, args.res], "DEPTH": args.depth})
    print(f"device: {device.type}  scene: {path} "
          f"{args.res}x{args.res} d{args.depth}")

    with torch.no_grad():
        target = render_iteration(scene, settings,
                                  zero_accum(settings, device), 1, seed=0,
                                  early_exit=False)
    true_albedo = scene.materials.color.cpu().numpy()
    wrong = perturbed_albedo(true_albedo, args.perturb)
    s = with_materials(scene, color=torch.as_tensor(
        wrong, dtype=torch.float32, device=device))
    validate_iteration(s, settings)

    def mae(sc):
        return float(np.abs(sc.materials.color.cpu().numpy()
                            - true_albedo).mean())

    err0 = mae(s)
    print(f"initial albedo MAE: {err0:.4f}")
    for k in range(args.steps):
        s, loss = albedo_fit_step(s, settings, target, 1, lr=args.lr, seed=0)
        if (k + 1) % 5 == 0 or k == 0:
            print(f"step {k + 1:3d}: loss {float(loss):.6f}  "
                  f"albedo MAE {mae(s):.4f}")
    err = mae(s)
    print(f"final albedo MAE: {err:.4f} ({err0:.4f} -> {err:.4f}, "
          f"{100 * (1 - err / err0):.0f}% recovered)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
