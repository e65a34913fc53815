"""Multi-process rendering: the port of pathtracer_tpu/parallel/distributed.py.

One rank a shard of the ray pool (parallel/sharding.py): `init_distributed`
wires the process into a torch.distributed group, `global_ray_mesh` gives
the mesh of one shard a rank, `make_global_accum` allocates only this
rank's block of the image, and `fetch_image` assembles the image on every
rank with one all-gather, the only data a render moves between ranks.
Tracing has no collectives, so ranks may run different numbers of bounces
and steps; every rank must reach the gather (and the albedo step's
all-reduce) in the same order.

NCCL serves one GPU a rank (`torchrun --nproc_per_node=N`); gloo serves
ranks on the CPU, or ranks that share one GPU, which NCCL refuses (its
collectives then go through host tensors). The port never calls
`init_process_group` by itself: without a group the sharded entry points
run local shards.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engine.wavefront import zero_accum
from ..scene.types import RenderSettings, SceneArrays
from .sharding import (RayMesh, fetch_image, make_ray_mesh,
                       render_chunk_sharded, replicate)

__all__ = ["init_distributed", "global_ray_mesh", "make_global_accum",
           "fetch_image", "render_distributed"]


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> None:
    """Join this process to the job's default process group.

    With no arguments it reads the env:// variables that torchrun sets
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), as the JAX package's
    no-argument call discovers the pod; otherwise pass e.g.
    init_method="tcp://127.0.0.1:<port>", world_size and rank. The backend
    is NCCL where the process sees a CUDA device, and gloo only when asked
    for; without a CUDA device and without backend="gloo" it raises. Under
    NCCL the rank's card becomes the current device (LOCAL_RANK, else the
    rank modulo the cards)."""
    if backend is None:
        backend = "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: torch sees no CUDA device; "
                           'pass backend="gloo" to run the ranks on the CPU')
    kwargs = {k: v for k, v in (("world_size", world_size), ("rank", rank))
              if v is not None}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kwargs)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))


def global_ray_mesh(device=None) -> RayMesh:
    """The mesh of one shard a rank of the default group, on `device`
    (default: the current card under NCCL; gloo needs it given)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("global_ray_mesh: call init_distributed first")
    return make_ray_mesh(devices=device)


def make_global_accum(settings: RenderSettings, mesh: RayMesh) -> tuple:
    """The zero sharded accumulator: each process allocates only the blocks
    of the shards it runs."""
    n_local = mesh.n_local(settings)
    return tuple(zero_accum(settings, dev, n=n_local) for dev in mesh.devices)


def render_distributed(scene: SceneArrays, settings: RenderSettings,
                       iterations: Optional[int] = None, seed: int = 0,
                       chunk: int = 16, device=None) -> np.ndarray:
    """The full progressive render over the group's mesh. Every rank calls
    it with the same arguments and gets the assembled [H, W, 3] image, the
    single-process render's bit for bit (the RNG is keyed on global pixel
    ids, not on ranks)."""
    mesh = global_ray_mesh(device)
    n_total = settings.iterations if iterations is None else iterations
    scenes = replicate(scene, mesh)
    accum = make_global_accum(settings, mesh)
    done = 0
    while done < n_total:
        this = min(chunk, n_total - done)
        render_chunk_sharded(scenes, settings, mesh, accum, done + 1, this,
                             seed)
        done += this
    return fetch_image(accum, settings, n_total, mesh)
