"""Numerical-safety check: the port of pathtracer_tpu/utils/debug.py.

The JAX package checkifies one render iteration for NaN/Inf. Here one
fixed-depth iteration runs with the material colours requiring grad, and
both the image and the gradient of its sum with respect to the colours must
be finite: the gradient is where the guards against inf in unselected
branches matter (box_intersect's |dc| clamp, sphere_intersect's root
select, refract's k clamp, Vec3.normalize's clamp).
"""
from __future__ import annotations

import torch

from ..engine.wavefront import render_iteration, zero_accum
from ..scene.types import RenderSettings, SceneArrays
from .grad import value_and_grad, with_materials


def validate_iteration(scene: SceneArrays, settings: RenderSettings,
                       seed: int = 0) -> None:
    """Run one fixed-depth iteration; raises FloatingPointError on any
    NaN/Inf in the image or in d(image sum)/d(material colour)."""
    def image_sum(color):
        img = render_iteration(with_materials(scene, color=color), settings,
                               zero_accum(settings, scene.device), 1,
                               seed=seed, early_exit=False)
        for name, c in zip("xyz", img):
            if not bool(torch.isfinite(c).all()):
                bad = int((~torch.isfinite(c)).sum())
                raise FloatingPointError(
                    f"image channel {name}: {bad} non-finite pixels")
        return img.x.sum() + img.y.sum() + img.z.sum()

    _, g = value_and_grad(image_sum, scene.materials.color)
    if not bool(torch.isfinite(g).all()):
        raise FloatingPointError(
            f"d(image sum)/d(material colour) is not finite: {g.tolist()}")
