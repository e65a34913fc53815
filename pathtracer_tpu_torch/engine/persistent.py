"""Persistent wavefront engine: the port of pathtracer_tpu/engine/persistent.py.

Every lane that finishes a path respawns at once with its next work item,
and the loop runs until every pixel has its samples, so the steps are about
spp x the mean path length plus one drain tail, against trace_depth bounces
a sample in the masked engine.

Schedule: lane i's k-th assignment serves pixel (i + k*C) mod n, C coprime
with n (pixel_stride), so each round k is a permutation of all pixels and
the lane -> pixel map of a whole round is one circular shift. A finished
sample is banked in LANE space into the buffer of its round (WINDOW
buffers in flight); once every lane has passed round r, the buffer flushes
into the image as accum += roll(buf[r mod W], r*C mod n), at most one flush
a step. A lane more than W - 1 rounds ahead of the slowest waits.

The JAX package computes assign * C in int32, where the product wraps from
about round 5,429 at 800x800; the lane's pixel and the flush shift both use
the wrapped product, floor-mod n. The port reproduces that wrap in int64
(_wrap_i32), so its schedule stays the JAX package's at any spp.

The RNG is keyed on (seed, sample, depth, pixel) (ops/rng.decision_state),
always the fast hash streams, whatever RenderSettings.fast_rng says (as in
the JAX package, engine/persistent.py:160-181: a lane's stream must not
depend on which lane row it sits in), so this engine draws the same numbers
for a sample as the wavefront engine's fast path,
and the images agree up to the order of float additions. The JAX package's
while_loop is a host loop here: each step reads its loop condition and the
least completed round back in one device-to-host copy.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import rng
from ..ops.bsdf import shade
from ..ops.camera import generate_camera_rays
from ..ops.intersect import intersect_scene
from ..scene.types import RenderSettings, SceneArrays
from ..utils.vec import Vec3

WINDOW = 4  # in-flight assignment rounds (W buffers of 3 x [n] f32)


def pixel_stride(n: int) -> int:
    """Golden-ratio stride coprime with n: consecutive assignments of a lane
    land far apart in the image."""
    c = max(1, int(n * 0.6180339887498949)) | 1
    while math.gcd(c, n) != 1:
        c += 2
    return c % n


def _wrap_i32(p):
    """An integer (or int64 tensor) wrapped to int32 two's complement, as
    the JAX package's int32 product assign * stride wraps."""
    return ((p + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def schedule_pixel(lane: torch.Tensor, assign: torch.Tensor, stride: int,
                   n: int) -> torch.Tensor:
    """The pixel of lane i's assignment k: (i + wrap32(k*C) mod n) mod n
    (pathtracer_tpu/engine/persistent.py:154-157)."""
    return (lane + _wrap_i32(assign * stride) % n) % n


def flush_shift(r: int, stride: int, n: int) -> int:
    """The roll that takes round r's lane-space buffer to pixel order:
    wrap32(r*C) mod n (pathtracer_tpu/engine/persistent.py:125)."""
    return _wrap_i32(r * stride) % n


class LaneState(NamedTuple):
    """Per-lane persistent state and the windowed accumulation."""

    origin: Vec3
    direction: Vec3
    color: Vec3                     # throughput of the current sample
    remaining_bounces: torch.Tensor  # i32: >0 live, <=0 done
    assign: torch.Tensor            # i64: 1-based assignment (= sample)
    pixel: torch.Tensor             # i64: pixel of the current sample
    round_buf: torch.Tensor         # [W, 3, n] f32 lane-space round banks
    flushed: int                    # rounds <= flushed are in accum
    accum: Vec3                     # running SUM image (lane order)


def fresh_lanes(settings: RenderSettings, device, accum: Vec3 | None = None,
                start_spp: int = 0, *, n: int | None = None) -> LaneState:
    """`n` lanes (default: the whole image; a shard's block for the sharded
    engine) parked at assignment `start_spp` (they respawn on the first
    step). A drained chunk boundary is a checkpoint: resuming is fresh lanes
    at (accum, start_spp), and the schedule and RNG are functions of the
    assignment index, so the resumed render is the uninterrupted one."""
    if n is None:
        n = settings.pixel_count
    device = torch.device(device)
    return LaneState(
        origin=Vec3.zeros(n, device), direction=Vec3.zeros(n, device),
        color=Vec3.zeros(n, device),
        remaining_bounces=torch.zeros(n, dtype=torch.int32, device=device),
        assign=torch.full((n,), start_spp, dtype=torch.int64, device=device),
        pixel=torch.arange(n, dtype=torch.int64, device=device),
        round_buf=torch.zeros((WINDOW, 3, n), device=device),
        flushed=int(start_spp),
        accum=Vec3.zeros(n, device) if accum is None else accum,
    )


def _flush_round(state: LaneState, r: int, stride: int) -> LaneState:
    """Bank round r: accum += roll(round_buf[r % W], r*C mod n) (in place),
    then zero the slot."""
    n = state.assign.shape[0]
    buf = state.round_buf[r % WINDOW]                        # [3, n]
    rolled = torch.roll(buf, flush_shift(r, stride, n), dims=1)
    for a, b in zip(state.accum, rolled):
        a.add_(b)
    buf.zero_()
    return state._replace(flushed=r)


def _step(scene: SceneArrays, settings: RenderSettings, seed: int,
          state: LaneState, spp_target: int, stride: int,
          pixel_offset: int = 0):
    """One persistent step: respawn -> intersect -> shade -> bank. Returns
    the new state (round_buf updated in place) and the least round every
    lane has completed, still on the device. `state.pixel` is local to the
    pool; `pixel_offset` is the global lane of its first pixel (a shard's
    block), so the camera and the RNG see global pixel ids."""
    n = state.assign.shape[0]
    dev = state.assign.device
    lane = torch.arange(n, dtype=torch.int64, device=dev)

    # respawn dead lanes that still owe assignments (window-gated)
    need = ((state.remaining_bounces <= 0) & (state.assign < spp_target)
            & (state.assign <= state.flushed + (WINDOW - 1)))
    assign = torch.where(need, state.assign + 1, state.assign)
    pixel = torch.where(need, schedule_pixel(lane, assign, stride, n),
                        state.pixel)
    pixel_g = settings.pixel_map()(pixel + pixel_offset if pixel_offset
                                   else pixel)

    jitter = (rng.fast_normals_perlane(
        rng.decision_state(seed, assign, -1, pixel_g), 2)
        if settings.jitter else None)
    dof_u = (rng.fast_uniforms_perlane(
        rng.decision_state(seed, assign, -2, pixel_g), 2)
        if settings.dof else None)
    o, d = generate_camera_rays(scene.camera, settings.width, settings.height,
                                jitter, dof_u, pixel_idx=pixel_g)

    one = torch.ones(n, device=dev)
    origin = Vec3.where(need, o, state.origin)
    direction = Vec3.where(need, d, state.direction)
    color = Vec3.where(need, Vec3(one, one, one), state.color)
    rb = torch.where(need, settings.trace_depth, state.remaining_bounces)

    # one bounce for every live lane
    t, normal, mat_id = intersect_scene(
        scene, settings.geom_types, origin, direction,
        bvh_impl=settings.bvh_impl, active=rb > 0)
    depth = settings.trace_depth - rb                    # per-lane depth
    u = rng.fast_uniforms_perlane(
        rng.decision_state(seed, assign, depth, pixel_g),
        5 if settings.rr_start else 4)
    origin, direction, color, rb = shade(
        origin, direction, color, rb, t, normal, mat_id, scene.materials, u,
        any_glossy=settings.any_glossy,
        any_refractive=settings.any_refractive,
        depth_quirk=settings.depth_quirk,
        rr_depth=depth, rr_start=settings.rr_start)

    # bank finished samples into their round's lane-space buffer
    done = rb == 0
    for w in range(WINDOW):
        m = done & (assign % WINDOW == w)
        state.round_buf[w].add_(torch.stack([torch.where(m, c, 0.0)
                                             for c in color]))
    rb = torch.where(done, -1, rb)

    completed = assign - (rb > 0).to(torch.int64)   # rounds done per lane
    new = LaneState(origin, direction, color, rb, assign, pixel,
                    state.round_buf, state.flushed, state.accum)
    return new, completed.min()


@torch.inference_mode()
def render_persistent_chunk(scene: SceneArrays, settings: RenderSettings,
                            state: LaneState, spp_target: int,
                            seed: int = 0, stride: int | None = None,
                            pixel_offset: int = 0) -> LaneState:
    """Run until every pixel has `spp_target` samples flushed into
    state.accum (updated in place). Carry the returned state into the next
    chunk, with a larger target, to keep lanes rolling across chunks.
    `pixel_offset`: the global lane of the pool's first pixel (a shard's
    block, parallel/sharding.render_persistent_sharded)."""
    n = state.assign.shape[0]
    if stride is None:
        stride = pixel_stride(n)
    pending = bool(((state.remaining_bounces > 0)
                    | (state.assign < spp_target)).any())
    while pending or state.flushed < spp_target:
        state, min_done = _step(scene, settings, seed, state, spp_target,
                                stride, pixel_offset)
        busy = ((state.remaining_bounces > 0)
                | (state.assign < spp_target)).any()
        min_done, busy = torch.stack([min_done, busy.to(torch.int64)]
                                     ).tolist()      # one copy a step
        if min_done > state.flushed:    # min rises by at most one a step
            state = _flush_round(state, state.flushed + 1, stride)
        pending = bool(busy)
    return state


def render_persistent(scene: SceneArrays, settings: RenderSettings,
                      iterations: int | None = None, seed: int = 0,
                      chunk: int = 64, progress=None,
                      accum: Vec3 | None = None,
                      start_iteration: int = 0) -> np.ndarray:
    """Full progressive render with the persistent engine; returns the
    averaged [H, W, 3] image. `accum` / `start_iteration` resume from a
    drained checkpoint (the contract of engine/wavefront.render); `accum` is
    updated in place. `progress(done, accum)` is called after each chunk."""
    from .wavefront import lanes_to_image

    spp = settings.iterations if iterations is None else iterations
    state = fresh_lanes(settings, scene.device, accum=accum,
                        start_spp=start_iteration)
    stride = pixel_stride(settings.pixel_count)
    done = start_iteration
    total = start_iteration + spp
    while done < total:
        done = min(done + chunk, total)
        state = render_persistent_chunk(scene, settings, state, done, seed,
                                        stride)
        if progress is not None:
            progress(done, state.accum)
    avg = state.accum * (1.0 / float(total))
    return lanes_to_image(avg, settings)
