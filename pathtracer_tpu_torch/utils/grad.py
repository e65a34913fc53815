"""Gradient helpers of the port: `value_and_grad`, with zeros where the loss
does not depend on the parameter (as jax.grad gives), and `with_materials`,
a scene with some material fields replaced. The fits (tools/), the
numerical-safety check (utils/debug.py) and the chip smoke take their
gradients through them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..scene.types import SceneArrays


def value_and_grad(loss_fn, param: torch.Tensor):
    """(loss, d loss / d param) of the scalar `loss_fn(p)` at p = param.

    The gradient is zeros where the loss does not depend on a coordinate of
    the parameter, and all zeros where it depends on none of it (the loss
    then has no autograd graph at all: the camera position of a diffuse
    scene, whose rays reach the image only through discrete hits), as
    jax.grad gives."""
    p = param.detach().requires_grad_(True)
    loss = loss_fn(p)
    if loss.grad_fn is None:
        return loss.detach(), torch.zeros_like(param)
    (g,) = torch.autograd.grad(loss, p, allow_unused=True,
                               materialize_grads=True)
    return loss.detach(), g


def with_materials(scene: SceneArrays, **fields) -> SceneArrays:
    """`scene` with some material fields replaced (color=..., ior=...)."""
    return dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, **fields))
