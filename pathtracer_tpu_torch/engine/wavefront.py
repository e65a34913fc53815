"""Wavefront render engine, masked mode: the port of
pathtracer_tpu/engine/wavefront.py.

One lane per pixel; `remaining_bounces` encodes liveness as in the reference
(>0 live, ==0 done-not-gathered, -1 gathered, -2 dead). Each bounce runs
intersect -> shade -> an elementwise gather into the running-sum image. The
JAX package compiles the bounce loop into one program; here it is a Python
loop of eager torch ops. The image is a running SUM over iterations; `render`
divides by the iteration count.

The sorted (COALESCED) and tiled compact modes are not part of this slice.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import rng
from ..ops.bsdf import shade
from ..ops.camera import generate_camera_rays
from ..ops.intersect import intersect_scene
from ..scene.types import RenderSettings, SceneArrays
from ..utils.vec import Vec3


class PathState(NamedTuple):
    origin: Vec3                      # [N] x3
    direction: Vec3                   # [N] x3
    color: Vec3                       # [N] x3 running throughput
    remaining_bounces: torch.Tensor   # [N] i32
    pixel: torch.Tensor               # [N] local pixel index (lane order)


def generate_paths(scene: SceneArrays, settings: RenderSettings,
                   irng: rng.IterationRng) -> PathState:
    """Camera raygen -> fresh path pool, one lane per pixel
    (pathtrace.cu:260-322)."""
    n = settings.pixel_count
    dev = scene.device
    lanes = torch.arange(n, dtype=torch.int64, device=dev)
    jitter = irng.normals(-1, lanes, 2) if settings.jitter else None
    dof_u = irng.uniforms(-2, lanes, 2) if settings.dof else None
    pixel_ids = settings.pixel_map()(lanes)
    origin, direction = generate_camera_rays(
        scene.camera, settings.width, settings.height, jitter, dof_u,
        pixel_idx=pixel_ids)
    one = torch.ones(n, device=dev)
    return PathState(
        origin=origin,
        direction=direction,
        color=Vec3(one, one, one),
        remaining_bounces=torch.full((n,), settings.trace_depth,
                                     dtype=torch.int32, device=dev),
        pixel=lanes,
    )


def bounce_step(scene: SceneArrays, settings: RenderSettings,
                irng: rng.IterationRng, depth: int,
                state: PathState, image: Vec3) -> PathState:
    """One bounce, masked mode: intersect -> shade -> gather
    (pathtrace.cu:752-894 body). Adds the lanes that just finished to
    `image` in place and returns the new path state."""
    t, normal, mat_id = intersect_scene(
        scene, settings.geom_types, state.origin, state.direction,
        bvh_impl=settings.bvh_impl, active=state.remaining_bounces > 0)

    u = irng.uniforms(depth, state.pixel, 5 if settings.rr_start else 4)
    origin, direction, color, rb = shade(
        state.origin, state.direction, state.color, state.remaining_bounces,
        t, normal, mat_id, scene.materials, u,
        any_glossy=settings.any_glossy,
        any_refractive=settings.any_refractive,
        depth_quirk=settings.depth_quirk,
        rr_depth=depth, rr_start=settings.rr_start)

    # gatherImage: add lanes whose remaining_bounces just reached 0, then
    # mark them gathered (-1) so they are never added twice
    # (pathtrace.cu:574-589)
    newly_done = rb == 0
    for img_c, col_c in zip(image, color):
        img_c.add_(torch.where(newly_done, col_c, 0.0))
    rb = torch.where(newly_done, -1, rb)
    return PathState(origin, direction, color, rb, state.pixel)


@torch.inference_mode()
def render_iteration(scene: SceneArrays, settings: RenderSettings,
                     accum: Vec3, iteration: int, seed: int = 0,
                     early_exit: bool = False) -> Vec3:
    """One progressive-render iteration: raygen + the bounce loop.

    `accum` (Vec3 of [N] running sums) is updated IN PLACE, where the JAX
    package donates it to the compiled program, and returned. early_exit
    stops once no path is live: that test reads one flag back from the
    device per bounce (the JAX package's while_loop keeps it on the chip);
    otherwise all trace_depth bounces run.
    """
    irng = rng.IterationRng(seed, iteration, pixel_map=settings.pixel_map())
    state = generate_paths(scene, settings, irng)
    for depth in range(settings.trace_depth):
        if early_exit and not bool((state.remaining_bounces > 0).any()):
            break
        state = bounce_step(scene, settings, irng, depth, state, accum)
    return accum


def render_chunk(scene: SceneArrays, settings: RenderSettings,
                 accum: Vec3, start_iteration: int, n_iters: int,
                 seed: int = 0, early_exit: bool = True) -> Vec3:
    """Run `n_iters` progressive iterations from `start_iteration` into
    `accum` (in place)."""
    for k in range(n_iters):
        render_iteration(scene, settings, accum, start_iteration + k,
                         seed=seed, early_exit=early_exit)
    return accum


def zero_accum(settings: RenderSettings, device) -> Vec3:
    return Vec3.zeros(settings.pixel_count, torch.device(device))


def render(scene: SceneArrays, settings: RenderSettings,
           iterations: int | None = None, seed: int = 0,
           early_exit: bool = True) -> np.ndarray:
    """Full progressive render; returns the AVERAGED image [H, W, 3] as a
    numpy array."""
    n_total = settings.iterations if iterations is None else iterations
    accum = zero_accum(settings, scene.device)
    # iterations count from 1, as the reference's ++iteration
    render_chunk(scene, settings, accum, 1, n_total, seed, early_exit)
    avg = accum * (1.0 / float(n_total))
    return lanes_to_image(avg, settings)


def lanes_to_image(avg: Vec3, settings: RenderSettings) -> np.ndarray:
    """Lane-space Vec3 -> [H, W, 3] numpy image (undoes the tile-major lane
    order)."""
    arr = avg.to_array().cpu().numpy()
    if settings.tile is None:
        return arr.reshape(settings.height, settings.width, 3)
    pm = np.asarray(settings.pixel_map()(
        np.arange(settings.pixel_count, dtype=np.int64)))
    out = np.empty_like(arr)
    out[pm] = arr
    return out.reshape(settings.height, settings.width, 3)

