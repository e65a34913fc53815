"""Wavefront render engine: the port of pathtracer_tpu/engine/wavefront.py.

One lane per pixel; `remaining_bounces` encodes liveness as in the reference
(>0 live, ==0 done-not-gathered, -1 gathered, -2 dead). The JAX package
compiles the bounce loop into one program; here it is a Python loop of eager
torch ops. The image is a running SUM over iterations; `render` divides by
the iteration count. Three modes, as in the JAX package:

  masked (default)   lane == pixel; each bounce runs intersect -> shade ->
                     an elementwise gather into the image (bounce_step).
  sorted             settings.sort_materials (COALESCED): each bounce
                     intersects the whole pool, sorts state and hit by
                     material key, then shades; pixels ride the sorts and
                     one unsort after the loop gathers (bounce_step_sorted).
  tiled compact      settings.compact (STREAM_COMPACT): the pool is walked in
                     tiles of compact_tile lanes and a tile with no live lane
                     is skipped (bounce_step_tiled).

The RNG is keyed by pixel, so the three modes draw the same numbers for a
path and give the same image up to float rounding.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..ops import rng
from ..ops.bsdf import shade
from ..ops.camera import generate_camera_rays
from ..ops.intersect import intersect_scene
from ..ops.scan import (SEG, sort_by_key_multisort, sort_by_key_segmented,
                        tree_map)
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


def _sorter(n: int):
    """The segmented sort where the pool fills whole columns, else the
    full-pool multisort (pathtracer_tpu/engine/wavefront.py:184-186)."""
    return sort_by_key_segmented if n % SEG == 0 else sort_by_key_multisort


def bounce_step_sorted(scene: SceneArrays, settings: RenderSettings,
                       irng: rng.IterationRng, depth: int,
                       state: PathState, image: Vec3) -> PathState:
    """One bounce, material-sorted mode (COALESCED, pathtrace.cu:825-841):
    intersect the whole pool, sort state and hit by the material key
    (misses keep key 0, pathtrace.cu:755), then shade. Lanes stay permuted
    across bounces with their pixel ids; lanes that finish are marked
    gathered (-1) without an image add, and render_iteration gathers them
    after the loop. `image` is untouched."""
    t, normal, mat_id = intersect_scene(
        scene, settings.geom_types, state.origin, state.direction,
        bvh_impl=settings.bvh_impl)
    keys = torch.where(t > 0.0, mat_id, 0)
    _, (state, t, normal, mat_id) = _sorter(t.shape[0])(
        keys, (state, t, normal, mat_id))

    u = irng.uniforms(depth, state.pixel, 5 if settings.rr_start else 4)
    origin, direction, color, rb = shade(
        state.origin, state.direction, state.color, state.remaining_bounces,
        t, normal, mat_id, scene.materials, u,
        any_glossy=settings.any_glossy,
        any_refractive=settings.any_refractive,
        depth_quirk=settings.depth_quirk,
        rr_depth=depth, rr_start=settings.rr_start)
    rb = torch.where(rb == 0, -1, rb)
    return PathState(origin, direction, color, rb, state.pixel)


def bounce_step_tiled(scene: SceneArrays, settings: RenderSettings,
                      irng: rng.IterationRng, depth: int,
                      state: PathState, image: Vec3, tile: int) -> PathState:
    """One bounce, compact mode: the pool as [n_tiles, tile] rows, and a
    tile whose lanes are all dead skips intersect, RNG and shade. The
    liveness of every tile comes back to the host in one copy per bounce.
    Lane == pixel, so the image add stays elementwise (in place, on the
    tile's slice of `image`)."""
    n = state.origin.x.shape[0]
    assert n % tile == 0, f"pool {n} not divisible by tile {tile}"
    n_tiles = n // tile
    live = (state.remaining_bounces.view(n_tiles, tile) > 0).any(
        dim=1).tolist()
    out = []
    for k in range(n_tiles):
        sl = slice(k * tile, (k + 1) * tile)
        s = tree_map(lambda a: a[sl], state)
        if not live[k]:
            out.append(s)
            continue
        t, normal, mat_id = intersect_scene(
            scene, settings.geom_types, s.origin, s.direction,
            bvh_impl=settings.bvh_impl)
        u = irng.uniforms(depth, s.pixel, 5 if settings.rr_start else 4)
        origin, direction, color, rb = shade(
            s.origin, s.direction, s.color, s.remaining_bounces,
            t, normal, mat_id, scene.materials, u,
            any_glossy=settings.any_glossy,
            any_refractive=settings.any_refractive,
            depth_quirk=settings.depth_quirk,
            rr_depth=depth, rr_start=settings.rr_start)
        newly_done = rb == 0
        for img_c, col_c in zip(image, color):
            img_c[sl].add_(torch.where(newly_done, col_c, 0.0))
        rb = torch.where(newly_done, -1, rb)
        out.append(PathState(origin, direction, color, rb, s.pixel))
    return tree_map(lambda *parts: torch.cat(parts), *out)


def _dispatch_bounce(scene, settings, irng, depth, state, image):
    """The bounce of the configured mode (early-exit loops only, as in the
    JAX package): sorted, tiled, or masked. A compact_tile that does not
    divide the pool, or is not smaller than it, warns and falls back to
    masked."""
    if settings.sort_materials:
        return bounce_step_sorted(scene, settings, irng, depth, state,
                                  image)
    if settings.compact:
        n = image.x.shape[0]
        tile = min(settings.compact_tile, n)
        if n % tile == 0 and n > tile:
            return bounce_step_tiled(scene, settings, irng, depth, state,
                                     image, tile)
        warnings.warn(
            f"compact=True but pool size {n} is not divisible "
            f"by compact_tile={settings.compact_tile} (or not larger than "
            "it); falling back to masked mode. Pick a dividing compact_tile "
            "to get tile skipping.", stacklevel=2)
    return bounce_step(scene, settings, irng, depth, state, image)


def render_iteration(scene: SceneArrays, settings: RenderSettings,
                     accum: Vec3, iteration: int, seed: int = 0,
                     early_exit: bool = False) -> Vec3:
    """One progressive-render iteration: raygen + the bounce loop.

    `accum` (Vec3 of [N] running sums) is updated IN PLACE, where the JAX
    package donates it to the compiled program, and returned. early_exit
    stops once no path is live: that test reads one flag back from the
    device per bounce (the JAX package's while_loop keeps it on the chip);
    it also selects the sorted or tiled mode where the settings ask for
    one. Otherwise all trace_depth masked bounces run.

    Differentiable with early_exit=False, as the JAX package's is: autograd
    records the bounce loop whenever a scene tensor requires grad (the mesh
    intersectors other than "jnp" return their hits as constants,
    ops/intersect.py). `render` and `render_chunk` run it without autograd.
    """
    irng = rng.IterationRng(seed, iteration, pixel_map=settings.pixel_map())
    state = generate_paths(scene, settings, irng)
    if not early_exit:
        for depth in range(settings.trace_depth):
            state = bounce_step(scene, settings, irng, depth, state, accum)
        return accum
    for depth in range(settings.trace_depth):
        if not bool((state.remaining_bounces > 0).any()):
            break
        state = _dispatch_bounce(scene, settings, irng, depth, state, accum)
    if settings.sort_materials:
        # the deferred COALESCED gather: one unsort by pixel restores
        # lane == pixel (exact: lanes never leave their column, and within a
        # column the pixels started ascending), then the gathered lanes add
        _, (color, rb) = _sorter(state.pixel.shape[0])(
            state.pixel, (state.color, state.remaining_bounces))
        done = rb == -1
        for img_c, col_c in zip(accum, color):
            img_c.add_(torch.where(done, col_c, 0.0))
    return accum


@torch.inference_mode()
def ray_survival(scene: SceneArrays, settings: RenderSettings,
                 iteration: int, seed: int = 0) -> torch.Tensor:
    """Live-ray count per bounce depth for one iteration of the masked
    engine (the reference's PRINT_RAY_COUNT, pathtrace.cu:746-750,877-881).
    Returns [trace_depth + 1] int32 on the scene's device: the counts
    before each bounce (index 0 = primary rays) and after the last."""
    irng = rng.IterationRng(seed, iteration, pixel_map=settings.pixel_map())
    state = generate_paths(scene, settings, irng)
    image = zero_accum(settings, scene.device)
    counts = []
    for depth in range(settings.trace_depth):
        counts.append((state.remaining_bounces > 0).sum(dtype=torch.int32))
        state = bounce_step(scene, settings, irng, depth, state, image)
    counts.append((state.remaining_bounces > 0).sum(dtype=torch.int32))
    return torch.stack(counts)


@torch.inference_mode()
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


@torch.inference_mode()
def render(scene: SceneArrays, settings: RenderSettings,
           iterations: int | None = None, seed: int = 0,
           chunk: int = 16, early_exit: bool = True,
           accum: Vec3 | None = None, start_iteration: int = 0,
           progress=None) -> np.ndarray:
    """Full progressive render; returns the AVERAGED image [H, W, 3] as a
    numpy array.

    Resumes from a checkpoint's (accum, start_iteration) (utils/checkpoint):
    the RNG is a pure function of (seed, iteration, pixel), so a resumed
    render equals an uninterrupted one. `accum` is updated in place.
    `progress(done, accum)` is called after every `chunk` iterations."""
    n_total = settings.iterations if iterations is None else iterations
    if accum is None:
        accum = zero_accum(settings, scene.device)
    done = start_iteration
    while done < start_iteration + n_total:
        this = min(chunk, start_iteration + n_total - done)
        # iterations count from 1, as the reference's ++iteration
        render_chunk(scene, settings, accum, done + 1, this, seed,
                     early_exit)
        done += this
        if progress is not None:
            progress(done, accum)
    avg = accum * (1.0 / float(start_iteration + n_total))
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

