"""Wavefront render engine: the port of pathtracer_tpu/engine/wavefront.py.

One lane per pixel; `remaining_bounces` encodes liveness as in the reference
(>0 live, ==0 done-not-gathered, -1 gathered, -2 dead). The image is a
running SUM over iterations; `render` divides by the iteration count. Three
modes, as in the JAX package:

  masked (default)   lane == pixel; each bounce runs intersect -> shade ->
                     an elementwise gather into the image (bounce_step).
  sorted             settings.sort_materials (COALESCED): each bounce
                     intersects the whole pool, sorts state and hit by
                     material key, then shades; pixels ride the sorts and
                     one unsort after the loop gathers (bounce_step_sorted).
  tiled compact      settings.compact (STREAM_COMPACT): the pool is walked in
                     tiles of compact_tile lanes and a tile with no live lane
                     is skipped (bounce_step_tiled).

The fast RNG (the default) is keyed by pixel, so the three modes draw the
same numbers for a path and give the same image up to float rounding. A
pool may be a shard's block of the image (`n` lanes from global lane
`pixel_offset`, parallel/sharding.py); pixel ids, and so the random
numbers, stay global. With RenderSettings.fast_rng=False the draws come
from the threefry streams by lane row, as in the JAX package (ops/rng.py):
the sorted mode then draws for its permuted lanes, the tiled mode folds the
tile index into each tile's draws, and a shard's `key_salt` (its index)
into its key, so those images differ from the masked one as the JAX
package's do.

The compiled frame. The JAX package runs `render_chunk` as one jitted
program (pathtracer_tpu/engine/wavefront.py:382-400). Here, on a CUDA device,
`render_chunk` runs each iteration as one replay of a captured
torch.cuda.CUDAGraph of `capturable_iteration`: the masked iteration of all
trace_depth bounces (the JAX package's early_exit=False scan form, whose
image equals the early-exit loop's), its iteration number a 0-d device
tensor that the graph advances, no host read (captured under
torch.cuda.set_sync_debug_mode("error")). The first chunk of a
configuration runs its first iteration eagerly (the warm-up: it builds the
kernel library and fills the kernels' host-side caches) and then captures;
graphs are cached by everything baked into them (`frame_key`), each with
its own accumulator that a chunk copies `accum` into and back out of, and
the least recently used is dropped, with a warning, once their memory
pools together pass FRAME_MEMORY_SHARE of the card's memory. `eager_reason`
decides from the settings, before any capture, which calls stay on the
eager loop (`render_chunk_eager`, a Python loop of eager torch ops): the
CPU, threefry (its key is folded on the host), the "jnp" walk (its loop
reads the host), and the sorted and tiled modes, which run only in the
early-exit loop (it reads a liveness flag on the host every bounce; the
tiled mode also reads each tile's). A capture that fails for settings the
rule admits raises; nothing falls back. `render_iteration`, the gradients
and the persistent engine (engine/persistent.py) are eager.

Each stage runs as a stage of the span recorder (utils/spans.py), a
torch.profiler range while a profiler records, named as the JAX package's
scopes (engine/wavefront.py:97-145): pt_raygen (generate_paths), and in
every mode's bounce pt_intersect, pt_shade (the draws and shade) and
pt_gather (the image add and the gathered marker). tools/trace_stats.py
charges the eager frame's device kernels to them. A graph replay runs no
host code, so no range: a frame's timed graph, the same iteration
captured with timed events at the boundaries of its stages, replays in
place of the plain one about once a second, and the next call of the
compiled frame reads it (utils/spans.py). Each call is the host span
pt_frame, with pt_frame.key, .warm, .capture, .copy and .launch inside it;
lanes_to_image is the span pt_display.fetch.
"""
from __future__ import annotations

import dataclasses
import importlib
import time
import warnings
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..ops import kernels, rng
from ..ops.bsdf import shade_lanes
from ..ops.camera import camera_paths
from ..ops.intersect import intersect_scene
from ..ops.scan import (SEG, sort_by_key_multisort, sort_by_key_segmented,
                        tree_map)
from ..scene.types import MESH, RenderSettings, SceneArrays
from ..utils import spans
from ..utils.vec import Vec3

# the share of a card's memory that the compiled frames' graph pools may
# hold together; past it the least recently used graph is dropped
FRAME_MEMORY_SHARE = 0.25
# the modules whose functions and upper-case flags a captured iteration
# bakes in (read at capture; part of frame_key)
BAKED_MODULES = ("engine.wavefront", "ops.rng", "ops.camera", "ops.bsdf",
                 "ops.intersect", "ops.binned", "ops.bvh_packet", "ops.wide",
                 "ops.brute", "ops.kernels", "utils.spans")


class PathState(NamedTuple):
    origin: Vec3                      # [N] x3
    direction: Vec3                   # [N] x3
    color: Vec3                       # [N] x3 running throughput
    remaining_bounces: torch.Tensor   # [N] i32
    pixel: torch.Tensor               # [N] local pixel index (lane order)


def generate_paths(scene: SceneArrays, settings: RenderSettings,
                   irng: rng.IterationRng, n: int | None = None,
                   pixel_offset: int = 0) -> PathState:
    """Camera raygen -> fresh path pool, one lane per pixel
    (pathtrace.cu:260-322). `n` lanes (default: the whole image) from
    global lane `pixel_offset` on, for a shard's block; on the fast RNG
    `irng` must carry the same offset and the settings' pixel map.
    `pixel` stays local (0..n-1), as in the JAX package. ops/camera.py
    camera_paths: one launch of csrc/raygen.cu on a CUDA device."""
    if n is None:
        n = settings.pixel_count
    with spans.stage("pt_raygen"):
        ox, oy, oz, dx, dy, dz, one, rb, lane = camera_paths(
            scene.camera, settings, n, pixel_offset, irng)
        return PathState(origin=Vec3(ox, oy, oz),
                         direction=Vec3(dx, dy, dz),
                         color=Vec3(one, one, one), remaining_bounces=rb,
                         pixel=lane)


def bounce_step(scene: SceneArrays, settings: RenderSettings,
                irng: rng.IterationRng, depth: int,
                state: PathState, image: Vec3) -> PathState:
    """One bounce, masked mode: intersect -> shade -> gather
    (pathtrace.cu:752-894 body). Adds the lanes that just finished to
    `image` in place and returns the new path state."""
    with spans.stage("pt_intersect"):
        t, normal, mat_id = intersect_scene(
            scene, settings.geom_types, state.origin, state.direction,
            bvh_impl=settings.bvh_impl, active=state.remaining_bounces > 0)
    origin, direction, color, rb = _shade(scene, settings, irng, depth,
                                          state, t, normal, mat_id)
    with spans.stage("pt_gather"):
        rb = _gather(image, color, rb)
    return PathState(origin, direction, color, rb, state.pixel)


def _shade(scene, settings, irng, depth, state, t, normal, mat_id,
           salt=None):
    """The bounce's draws and shade under the pt_shade range: the next
    (origin, direction, color, remaining_bounces), by ops/bsdf.py
    shade_lanes (one launch of csrc/shade.cu on a CUDA device). `salt`:
    the tiled mode's tile index."""
    with spans.stage("pt_shade"):
        return shade_lanes(
            state.origin, state.direction, state.color,
            state.remaining_bounces, t, normal, mat_id, scene.materials,
            irng, depth, state.pixel, salt=salt,
            any_glossy=settings.any_glossy,
            any_refractive=settings.any_refractive,
            depth_quirk=settings.depth_quirk, rr_start=settings.rr_start)


def _gather(image: Vec3, color: Vec3, rb: torch.Tensor) -> torch.Tensor:
    """gatherImage (pathtrace.cu:574-589): adds the lanes whose
    remaining_bounces just reached 0 to `image` in place, and returns rb
    with them marked gathered (-1), so they are never added twice."""
    newly_done = rb == 0
    for img_c, col_c in zip(image, color):
        img_c.add_(torch.where(newly_done, col_c, 0.0))
    return torch.where(newly_done, -1, rb)


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
    with spans.stage("pt_intersect"):
        t, normal, mat_id = intersect_scene(
            scene, settings.geom_types, state.origin, state.direction,
            bvh_impl=settings.bvh_impl)
    keys = torch.where(t > 0.0, mat_id, 0)
    _, (state, t, normal, mat_id) = _sorter(t.shape[0])(
        keys, (state, t, normal, mat_id))
    origin, direction, color, rb = _shade(scene, settings, irng, depth,
                                          state, t, normal, mat_id)
    with spans.stage("pt_gather"):
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
        with spans.stage("pt_intersect"):
            t, normal, mat_id = intersect_scene(
                scene, settings.geom_types, s.origin, s.direction,
                bvh_impl=settings.bvh_impl)
        origin, direction, color, rb = _shade(scene, settings, irng, depth,
                                              s, t, normal, mat_id, salt=k)
        with spans.stage("pt_gather"):
            rb = _gather(Vec3(*(c[sl] for c in image)), color, rb)
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
                     early_exit: bool = False,
                     pixel_offset: int = 0, key_salt=None) -> Vec3:
    """One progressive-render iteration: raygen + the bounce loop.

    `accum` (Vec3 of [N] running sums) is updated IN PLACE, where the JAX
    package donates it to the compiled program, and returned. N may be a
    shard's block of the pool, whose first lane is global lane
    `pixel_offset` (parallel/sharding.py), and `key_salt` is folded into
    the threefry key (the shard index; the fast RNG ignores it). early_exit
    stops once no path is live: that test reads one flag back from the
    device per bounce (the JAX package's while_loop keeps it on the chip);
    it also selects the sorted or tiled mode where the settings ask for
    one. Otherwise all trace_depth masked bounces run.

    Differentiable with early_exit=False, as the JAX package's is: autograd
    records the bounce loop whenever a scene tensor requires grad (the mesh
    intersectors other than "jnp" return their hits as constants,
    ops/intersect.py). `render` and `render_chunk` run it without autograd.
    """
    irng = rng.IterationRng(seed, iteration, pixel_map=settings.pixel_map(),
                            pixel_offset=pixel_offset,
                            fast=settings.fast_rng, key_salt=key_salt)
    state = generate_paths(scene, settings, irng, n=accum.x.shape[0],
                           pixel_offset=pixel_offset)
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


def capturable_iteration(scene: SceneArrays, settings: RenderSettings,
                         accum: Vec3, iteration: torch.Tensor, seed: int = 0,
                         pixel_offset: int = 0, key_salt=None) -> Vec3:
    """One masked iteration of all trace_depth bounces with no host read and
    no host value that changes between iterations: the iteration number is
    `iteration`, a 0-d int64 tensor on accum's device, advanced by one at
    the end; `accum` is updated in place and returned. The fast RNG only.
    The compiled frame captures it; its image is render_iteration's at that
    iteration, with early exit or without."""
    irng = rng.IterationRng(seed, iteration, pixel_map=settings.pixel_map(),
                            pixel_offset=pixel_offset,
                            fast=settings.fast_rng, key_salt=key_salt)
    state = generate_paths(scene, settings, irng, n=accum.x.shape[0],
                           pixel_offset=pixel_offset)
    for depth in range(settings.trace_depth):
        state = bounce_step(scene, settings, irng, depth, state, accum)
    iteration.add_(1)
    return accum


@torch.inference_mode()
def ray_survival(scene: SceneArrays, settings: RenderSettings,
                 iteration: int, seed: int = 0, n: int | None = None,
                 pixel_offset: int = 0, key_salt=None) -> torch.Tensor:
    """Live-ray count per bounce depth for one iteration of the masked
    engine (the reference's PRINT_RAY_COUNT, pathtrace.cu:746-750,877-881).
    Returns [trace_depth + 1] int32 on the scene's device: the counts
    before each bounce (index 0 = primary rays) and after the last.
    `n` / `pixel_offset` / `key_salt` count a shard's block only
    (parallel/sharding.shard_work_counts)."""
    irng = rng.IterationRng(seed, iteration, pixel_map=settings.pixel_map(),
                            pixel_offset=pixel_offset,
                            fast=settings.fast_rng, key_salt=key_salt)
    state = generate_paths(scene, settings, irng, n=n,
                           pixel_offset=pixel_offset)
    image = zero_accum(settings, scene.device, n=n)
    counts = []
    for depth in range(settings.trace_depth):
        counts.append((state.remaining_bounces > 0).sum(dtype=torch.int32))
        state = bounce_step(scene, settings, irng, depth, state, image)
    counts.append((state.remaining_bounces > 0).sum(dtype=torch.int32))
    return torch.stack(counts)


def eager_reason(settings: RenderSettings, device,
                 early_exit: bool = True) -> str | None:
    """Why render_chunk runs `settings` on `device` on the eager loop, or
    None where it runs the compiled frame: decided from the settings, the
    device and the loop alone, before any capture. Compiled: a CUDA device,
    the fast RNG, the masked mode (early_exit=False, or no sorted or tiled
    mode asked for) and any --bvh but "jnp" on a mesh scene. (Gradients go
    through render_iteration, never render_chunk, which runs under
    inference mode.)"""
    if torch.device(device).type != "cuda":
        return "not a CUDA device"
    if not settings.fast_rng:
        return "threefry folds its keys on the host"
    if MESH in settings.geom_types and settings.bvh_impl == "jnp":
        return "the 'jnp' walk reads its loop condition on the host"
    if early_exit and settings.sort_materials:
        return ("the sorted mode runs only in the early-exit loop, which "
                "reads a liveness flag on the host every bounce")
    if early_exit and settings.compact:
        return "the tiled mode reads tile liveness on the host"
    return None


def _signature(obj):
    """What a captured graph bakes in of `obj`: each tensor's address,
    shape, strides, type and device; every other value as it is."""
    if isinstance(obj, torch.Tensor):
        return (obj.data_ptr(), tuple(obj.shape), obj.stride(), obj.dtype,
                obj.device)
    if dataclasses.is_dataclass(obj):
        return tuple(_signature(getattr(obj, f.name))
                     for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_signature(o) for o in obj)
    return obj


def _module_state() -> tuple:
    """The functions (by identity) and the upper-case scalar flags of
    BAKED_MODULES: a patched wrapper or flag (binned.EXPAND, a recording
    stream, ...) gets a graph of its own."""
    pkg = __name__.rsplit(".", 2)[0]
    out = []
    for name in BAKED_MODULES:
        for k, v in vars(importlib.import_module(f"{pkg}.{name}")).items():
            if callable(v):
                out.append((name, k, id(v)))
            elif k.isupper() and isinstance(v, (bool, int, float, str,
                                                type(None))):
                out.append((name, k, v))
    return tuple(out)


def frame_key(scene: SceneArrays, settings: RenderSettings, n: int,
              seed: int, pixel_offset: int, key_salt, device) -> tuple:
    """The compiled-frame cache key: everything a captured iteration bakes
    in (the scene's tensors and statics, the frozen settings, the seed, the
    pool size, the shard's first lane and key salt, the device, and the
    modules' functions and flags)."""
    return (_signature(scene), settings, int(n), int(seed), int(pixel_offset),
            None if key_salt is None else int(key_salt),
            torch.device(device), _module_state())


class Frame:
    """One captured iteration: the graph, the accumulator and iteration
    tensor it reads and writes, the kernel launches and forms one replay
    runs (kernels.add_counts), the capture's seconds, the device memory its
    pool took, the scene it read (held, so its tensors stay where the
    graph reads them), and its timed graph: the same iteration with timed
    events at its stages' boundaries (spans.GraphEvents `events`), sharing
    the graph's pool (both None with the recorder off)."""

    __slots__ = ("graph", "accum", "iteration", "launches", "forms",
                 "capture_s", "pool_bytes", "scene", "timed", "events")

    def __init__(self, graph, accum: Vec3, iteration: torch.Tensor,
                 launches: dict, forms: dict, capture_s: float,
                 pool_bytes: int, scene, timed=None, events=None):
        self.graph, self.accum, self.iteration = graph, accum, iteration
        self.launches, self.forms = launches, forms
        self.capture_s, self.pool_bytes = capture_s, pool_bytes
        self.scene, self.timed, self.events = scene, timed, events

    def replay(self, timed: bool = False) -> None:
        """One iteration: the graph's replay, or with `timed` the timed
        graph's (where there is one; its events are then the ones the
        recorder reads next), and its launches counted."""
        if timed and self.timed is not None:
            self.timed.replay()
            spans.replayed(self.events)
        else:
            self.graph.replay()
        kernels.add_counts(self.launches, self.forms)


_FRAMES: OrderedDict = OrderedDict()


def clear_frames() -> None:
    """Drop every cached graph (and the memory it holds), after taking the
    last timed replay's stage times if it has finished."""
    spans.read_replay()
    _FRAMES.clear()


def cached_frames() -> list:
    """The cached Frames, least recently used first."""
    return list(_FRAMES.values())


def frame_budget(device: torch.device) -> int:
    """The bytes the graph pools of `device`'s compiled frames may hold
    together: FRAME_MEMORY_SHARE of its memory."""
    return int(FRAME_MEMORY_SHARE
               * torch.cuda.get_device_properties(device).total_memory)


def _evict(device: torch.device) -> None:
    """Drop `device`'s least recently used graphs, all but the newest,
    while their pools pass frame_budget; warn of each (a later chunk of
    its settings captures again)."""
    keys = [k for k, f in _FRAMES.items() if f.accum.x.device == device]
    if len(keys) < 2:
        return
    held = sum(_FRAMES[k].pool_bytes for k in keys)
    budget = frame_budget(device)
    for key in keys[:-1]:
        if held <= budget:
            break
        frame = _FRAMES.pop(key)
        held -= frame.pool_bytes
        spans.count("evictions")
        warnings.warn(
            f"compiled frame cache on {device}: dropped a graph of "
            f"{frame.pool_bytes / 2**30:.2f} GiB (the pools passed "
            f"{budget / 2**30:.2f} GiB); its settings capture again on "
            "their next chunk", stacklevel=2)


def _captured_iteration(scene, settings, accum, iteration, seed,
                        pixel_offset, key_salt, events) -> None:
    """capturable_iteration inside a capture, under
    set_sync_debug_mode("error"), so that a host read raises; its top
    stages record their boundaries into `events` (None: none)."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with spans.capturing(events):
            capturable_iteration(scene, settings, accum, iteration, seed,
                                 pixel_offset, key_salt)
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def capture_frame(scene: SceneArrays, settings: RenderSettings, n: int,
                  seed: int, pixel_offset: int, key_salt, device) -> Frame:
    """Capture capturable_iteration on `device` into a new CUDA graph and,
    with the recorder on, into its timed graph in the same pool (the two
    replay in turn, never at once). Run one iteration of these settings
    eagerly first (the kernel library, the kernels' cached grids and
    shared-memory attributes). The counts a capture adds are taken out
    again and one capture's kept for the replays; the pool's size is the
    growth of the memory the allocator holds on `device` over the captures
    (read inside the first: entering torch.cuda.graph empties the
    allocator's cache)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    accum = zero_accum(settings, device, n=n)
    iteration = torch.zeros((), dtype=torch.int64, device=device)
    args = (scene, settings, accum, iteration, seed, pixel_offset, key_salt)
    events = spans.graph_events()
    timed = None
    before = kernels.counts()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            reserved = torch.cuda.memory_reserved(device)
            _captured_iteration(*args, None)
        launches, forms = kernels.counts_since(before)
        if events is not None:
            timed = torch.cuda.CUDAGraph()
            with torch.cuda.graph(timed, pool=graph.pool()):
                _captured_iteration(*args, events)
    finally:
        kernels.restore_counts(before)
    pool = max(0, torch.cuda.memory_reserved(device) - reserved)
    spans.count("captures")
    return Frame(graph, accum, iteration, launches, forms,
                 time.perf_counter() - t0, pool, scene, timed, events)


def render_chunk_compiled(scene: SceneArrays, settings: RenderSettings,
                          accum: Vec3, start_iteration: int, n_iters: int,
                          seed: int = 0, pixel_offset: int = 0,
                          key_salt=None) -> Vec3:
    """`n_iters` iterations as replays of the cached graph of these
    settings; without one, the first iteration runs eagerly (the warm-up)
    and the graph is captured for the rest. `accum` is copied into the
    graph's accumulator and back. The call is the span pt_frame; it first
    takes the last timed replay's stage times if that replay has finished,
    and its last iteration replays the timed graph where one is due
    (spans.timed_due: at most once in spans.TIMED_EVERY_S)."""
    if n_iters <= 0:
        return accum
    dev = accum.x.device
    with spans.span(spans.FRAME, call=True):
        spans.read_replay()
        with spans.span("pt_frame.key"):
            key = frame_key(scene, settings, accum.x.shape[0], seed,
                            pixel_offset, key_salt, dev)
        with torch.cuda.device(dev):
            frame = _FRAMES.get(key)
            done = 0
            if frame is None:
                with spans.span("pt_frame.warm"):
                    it = torch.full((), start_iteration, dtype=torch.int64,
                                    device=dev)
                    capturable_iteration(scene, settings, accum, it, seed,
                                         pixel_offset, key_salt)
                done = 1
                with spans.span("pt_frame.capture"):
                    frame = capture_frame(scene, settings, accum.x.shape[0],
                                          seed, pixel_offset, key_salt, dev)
                _FRAMES[key] = frame
                _evict(dev)
            else:
                _FRAMES.move_to_end(key)
            if done < n_iters:
                with spans.span("pt_frame.copy"):
                    for own, a in zip(frame.accum, accum):
                        own.copy_(a)
                    frame.iteration.fill_(start_iteration + done)
                with spans.span("pt_frame.launch"):
                    for _ in range(n_iters - done - 1):
                        frame.replay()
                    frame.replay(timed=spans.timed_due())
                with spans.span("pt_frame.copy"):
                    for own, a in zip(frame.accum, accum):
                        a.copy_(own)
    return accum


@torch.inference_mode()
def render_chunk(scene: SceneArrays, settings: RenderSettings,
                 accum: Vec3, start_iteration: int, n_iters: int,
                 seed: int = 0, early_exit: bool = True,
                 pixel_offset: int = 0, key_salt=None) -> Vec3:
    """Run `n_iters` progressive iterations from `start_iteration` into
    `accum` (in place; a shard's block from global lane `pixel_offset`,
    its threefry key salted with `key_salt`).

    Compiled where `eager_reason` gives None (a CUDA device, the fast RNG,
    the masked mode, any --bvh but "jnp"): one graph replay an iteration
    (render_chunk_compiled), the image of the eager loop bit for bit.
    Otherwise the eager loop (render_chunk_eager): the sorted and tiled
    modes, threefry, "jnp" and the CPU."""
    if eager_reason(settings, accum.x.device, early_exit) is None:
        return render_chunk_compiled(scene, settings, accum, start_iteration,
                                     n_iters, seed, pixel_offset, key_salt)
    return render_chunk_eager(scene, settings, accum, start_iteration,
                              n_iters, seed, early_exit, pixel_offset,
                              key_salt)


@torch.inference_mode()
def render_chunk_eager(scene: SceneArrays, settings: RenderSettings,
                       accum: Vec3, start_iteration: int, n_iters: int,
                       seed: int = 0, early_exit: bool = True,
                       pixel_offset: int = 0, key_salt=None) -> Vec3:
    """render_chunk's eager loop: render_iteration `n_iters` times, every
    stage issued from the host under its pt_* range (the frame
    tools/trace_stats.py and utils/profiling.measure_stages split)."""
    for k in range(n_iters):
        render_iteration(scene, settings, accum, start_iteration + k,
                         seed=seed, early_exit=early_exit,
                         pixel_offset=pixel_offset, key_salt=key_salt)
    return accum


def zero_accum(settings: RenderSettings, device, n: int | None = None
               ) -> Vec3:
    """A zero image of `n` lanes (default: the whole image)."""
    return Vec3.zeros(settings.pixel_count if n is None else n,
                      torch.device(device))


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


@spans.span("pt_display.fetch")
def lanes_to_image(avg: Vec3, settings: RenderSettings) -> np.ndarray:
    """Lane-space Vec3 -> [H, W, 3] numpy image (undoes the tile-major lane
    order and the shard interleave, by scatter); the span
    pt_display.fetch."""
    arr = avg.to_array().cpu().numpy()
    if settings.tile is None and not settings.shard_interleave:
        return arr.reshape(settings.height, settings.width, 3)
    pm = np.asarray(settings.pixel_map()(
        np.arange(settings.pixel_count, dtype=np.int64)))
    out = np.empty_like(arr)
    out[pm] = arr
    return out.reshape(settings.height, settings.width, 3)

