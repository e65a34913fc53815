"""Compile-and-run check of one render iteration, and a dry run of the
sharded path: the port's counterpart of __graft_entry__.py `entry` and
`dryrun_multichip`.

`dryrun_multichip(n)` runs, on n local shards of one device: one forward
chunk of Cornell 64x64 d2, one sharded albedo step against it (the render,
the backward through the bounce loop, the sum of the gradient over shards,
the SGD step), and the `binned` intersection of teapot 64x64 camera rays,
shard by shard, which must equal the single-pool call bit for bit. Runs on
the CUDA device unless `device` says otherwise.
"""
from __future__ import annotations

import torch

from ..engine.wavefront import (generate_paths, render_iteration,
                                zero_accum)
from ..ops.intersect import intersect_scene
from ..ops.rng import IterationRng
from ..scene.fixtures import scene_path
from ..scene.loader import load_scene
from ..utils.vec import Vec3
from .sharding import (albedo_fit_step, make_ray_mesh, render_chunk_sharded,
                       replicate, shard_accum)


def _load(name: str, res: int, depth: int, device):
    return load_scene(scene_path(name), device,
                      overrides={"RES": [res, res], "DEPTH": depth})


def entry(device="cuda"):
    """(fn, example_args): one fixed-depth forward render iteration of
    Cornell 256x256 d4, the flagship workload."""
    scene, settings = _load("cornell", 256, 4, device)

    def fn(scene, accum, iteration):
        return render_iteration(scene, settings, accum, iteration, seed=0,
                                early_exit=False)

    return fn, (scene, zero_accum(settings, scene.device), 1)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One forward chunk and one albedo step of Cornell 64x64 d2 with the
    pool over `n_devices` local shards on `device`, and the sharded
    `binned` intersection of teapot 64x64 camera rays bit-equal to the
    single-pool call. Raises on a non-finite loss or a differing hit."""
    scene, settings = _load("cornell", 64, 2, device)
    mesh = make_ray_mesh(n_devices, devices=device)
    scenes = replicate(scene, mesh)
    accum = shard_accum(zero_accum(settings, mesh.devices[0]), mesh)
    target = render_chunk_sharded(scenes, settings, mesh, accum, 1, 1,
                                  seed=0, early_exit=False)
    _, loss = albedo_fit_step(scene, settings, mesh, target, 2, lr=0.1,
                              seed=0)
    if not bool(torch.isfinite(loss)):
        raise AssertionError("non-finite loss in the sharded dry run")

    t_scene, t_set = _load("teapot", 64, 2, device)
    if t_set.bvh_impl != "binned" or t_set.pixel_count % n_devices:
        raise AssertionError("teapot 64x64 must load binned and divide into "
                             f"{n_devices} shards")
    with torch.inference_mode():
        state = generate_paths(t_scene, t_set, IterationRng(
            0, 1, pixel_map=t_set.pixel_map()))

        def isect(o, d):
            return intersect_scene(t_scene, t_set.geom_types, o, d,
                                   bvh_impl="binned")

        whole = isect(state.origin, state.direction)
        parts = [isect(Vec3(*o), Vec3(*d)) for o, d in zip(
            zip(*(c.chunk(n_devices) for c in state.origin)),
            zip(*(c.chunk(n_devices) for c in state.direction)))]
    t1, n1, m1 = whole
    t2 = torch.cat([p[0] for p in parts])
    m2 = torch.cat([p[2] for p in parts])
    n2 = [torch.cat([p[1][k] for p in parts]) for k in range(3)]
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip((t1, *n1), (t2, *n2)))
    if not (same and torch.equal(m1, m2)):
        raise AssertionError("sharded binned mesh intersect diverged from "
                             "the single-pool call")
