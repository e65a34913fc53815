"""Data parallelism over the ray pool: the port of
pathtracer_tpu/parallel/sharding.py.

The pixels (lanes) are split into n_shards equal blocks on a 1-D mesh, the
scene is replicated on every shard's device, and tracing does no
communication: a ray's pixel never leaves its shard. The only collectives
are the all-reduce of the albedo gradient and loss (`albedo_fit_step`) and
the gather of the image (`fetch_image`).

A `RayMesh` is one of two kinds:
  - local shards (`make_ray_mesh(n, devices=...)`): n shards that this
    process runs one after another, all on one device (several on one card,
    or "cpu") or one device each. The counterpart of the JAX package's
    single-process mesh, its 8 virtual CPU devices included;
  - one shard a rank (`make_ray_mesh()` once torch.distributed is
    initialised, parallel/distributed.py): the counterpart of its
    multi-host mesh.

Shard s owns the global lanes [s * n_local, (s + 1) * n_local), and every
sharded entry point sets `settings.shard_interleave` to the shard count
(`_interleaved`), so those lanes are spread over the image. The fast RNG
is keyed on (seed, iteration, depth, global pixel id), and each pixel is
traced and summed only in its own shard, in iteration order: a sharded
image equals the single-device image bit for bit. (With fast_rng=False a
shard draws its own threefry stream, its key salted with its index, as in
the JAX package: the image is then another sample.) The per-lane closest hit
of every intersector does not depend on the other lanes of the pool. Only
the gradient's sum over shards adds floats in another order.

A sharded accumulator is a tuple of Vec3, one block of n_local lanes for
each shard the process runs, in the order of `mesh.shards`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engine.persistent import (fresh_lanes, pixel_stride,
                                 render_persistent_chunk)
from ..engine.wavefront import (lanes_to_image, ray_survival, render_chunk,
                                zero_accum)
from ..scene.types import RenderSettings, SceneArrays
from ..tools.fit_albedo import albedo_loss, sgd_albedo
from ..utils.device import resolve_device
from ..utils.grad import value_and_grad
from ..utils.vec import Vec3


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A 1-D mesh over the ray pool, as this process sees it."""

    n_shards: int
    shards: tuple        # the shard ids this process runs, ascending
    devices: tuple       # the torch.device of each of them
    group: object = None  # the process group; None for local shards

    def n_local(self, settings: RenderSettings) -> int:
        """Lanes a shard: the pixel count over the shard count."""
        n = settings.pixel_count
        if n % self.n_shards:
            raise ValueError(f"pixel count {n} not divisible by "
                             f"{self.n_shards} shards")
        return n // self.n_shards


def _device(name) -> torch.device:
    """`name` as a torch.device with its index (a bare "cuda" is the
    current card), raising where torch sees no CUDA device."""
    dev = resolve_device(str(name))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_ray_mesh(n_shards: Optional[int] = None, devices=None) -> RayMesh:
    """The 1-D mesh over the ray pool.

    With torch.distributed initialised and `n_shards` not given: one shard
    a rank of the default group, on `devices` (one device; default: this
    rank's CUDA device under NCCL, which init_distributed selected; gloo
    needs it given). Otherwise `n_shards` local shards on `devices`: one
    device for all of them, or one a shard; by default the first
    `n_shards` CUDA devices (all of them if `n_shards` is not given), as
    the JAX package takes the first devices."""
    if n_shards is None and dist.is_available() and dist.is_initialized():
        if devices is None:
            if dist.get_backend() != "nccl":
                raise ValueError("make_ray_mesh: pass this rank's device "
                                 f"(backend {dist.get_backend()})")
            devices = "cuda"
        return RayMesh(dist.get_world_size(), (dist.get_rank(),),
                       (_device(devices),), dist.group.WORLD)
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_ray_mesh: torch sees no CUDA device; "
                               'pass devices="cpu" to shard on the CPU')
        devices = [f"cuda:{k}" for k in range(count)]
        if n_shards is not None:
            if n_shards > count:
                raise ValueError(f"make_ray_mesh: {n_shards} shards, "
                                 f"{count} CUDA devices")
            devices = devices[:n_shards]
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * (n_shards or 1)
    devices = tuple(_device(d) for d in devices)
    if n_shards is None:
        n_shards = len(devices)
    if len(devices) != n_shards:
        raise ValueError(f"make_ray_mesh: {len(devices)} devices for "
                         f"{n_shards} shards")
    return RayMesh(n_shards, tuple(range(n_shards)), devices)


def _to_device(obj, device: torch.device):
    """A tree of dataclasses with every tensor moved to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def replicate(scene: SceneArrays, mesh: RayMesh) -> tuple:
    """The scene on the device of each shard the process runs, copied once
    a device (the counterpart of the JAX package's scene upload,
    pathtrace.cu:143-233). On the scene's own device it is the same
    object."""
    copies = {scene.device: scene}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = _to_device(scene, dev)
    return tuple(copies[dev] for dev in mesh.devices)


def _replicas(scene, mesh: RayMesh) -> tuple:
    """`replicate(scene, mesh)`, or `scene` if it is already that tuple."""
    return scene if isinstance(scene, tuple) else replicate(scene, mesh)


def shard_accum(accum: Vec3, mesh: RayMesh) -> tuple:
    """A whole-image accumulator split into the blocks of the shards the
    process runs, each a copy on its shard's device. Its lanes are in the
    order of the sharded settings (`_interleaved(settings, n_shards)`): an
    image accumulated by the single-pool engine has another lane order
    once the interleave is on (n_shards > 1)."""
    n_local = accum.x.shape[0] // mesh.n_shards
    return tuple(
        Vec3(*(c[s * n_local:(s + 1) * n_local].to(dev, copy=True)
               for c in accum))
        for s, dev in zip(mesh.shards, mesh.devices))


def _interleaved(settings: RenderSettings, n_shards: int) -> RenderSettings:
    """The settings with the shard interleave of `n_shards` shards (none for
    one): every sharded entry point routes through this, so the lanes mean
    the same pixels in the render, the fit and the counts."""
    return dataclasses.replace(
        settings, shard_interleave=n_shards if n_shards > 1 else None)


def _on_host(mesh: RayMesh) -> bool:
    """Whether the group's collectives take host tensors (gloo)."""
    return dist.get_backend(mesh.group) == "gloo"


def _all_gather(t: torch.Tensor, mesh: RayMesh) -> list:
    """Every rank's `t`, in rank order, on t's device (gloo gathers through
    host tensors)."""
    send = t.cpu() if _on_host(mesh) else t.contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.n_shards)]
    dist.all_gather(parts, send, group=mesh.group)
    return [p.to(t.device) for p in parts]


def all_reduce(t: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """The sum of every rank's `t`, the same on every rank, on t's
    device."""
    buf = t.cpu() if _on_host(mesh) else t
    buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(t.device)


def gather_accum(accum: tuple, mesh: RayMesh) -> Vec3:
    """The whole pool's accumulator (lane order) on the first shard's
    device: the local blocks put together, or one all-gather over the
    group."""
    blocks = [torch.stack(tuple(a)) for a in accum]          # [3, n_local]
    if mesh.group is None:
        full = torch.cat([b.to(mesh.devices[0]) for b in blocks], dim=1)
    else:
        (block,) = blocks
        full = torch.cat(_all_gather(block, mesh), dim=1)
    return Vec3(*full.unbind(0))


def fetch_image(accum: tuple, settings: RenderSettings, iterations: int,
                mesh: RayMesh) -> np.ndarray:
    """The averaged [H, W, 3] image of a sharded accumulator, on every rank
    (pathtracer_tpu/parallel/distributed.py fetch_image): the gather, then
    lanes_to_image under the shard interleave of the render."""
    avg = gather_accum(accum, mesh) * (1.0 / float(iterations))
    return lanes_to_image(avg, _interleaved(settings, mesh.n_shards))


def render_chunk_sharded(scene, settings: RenderSettings, mesh: RayMesh,
                         accum: tuple, start_iteration: int, n_iters: int,
                         seed: int = 0, early_exit: bool = True) -> tuple:
    """`n_iters` progressive iterations from `start_iteration` into the
    sharded accumulator `accum` (in place), each shard over its own block
    with no communication. `scene` is a SceneArrays or `replicate`'s
    tuple."""
    n_local = mesh.n_local(settings)
    settings = _interleaved(settings, mesh.n_shards)
    for sc, s, a in zip(_replicas(scene, mesh), mesh.shards, accum):
        render_chunk(sc, settings, a, start_iteration, n_iters, seed,
                     early_exit, pixel_offset=s * n_local, key_salt=s)
    return accum


def render_sharded(scene: SceneArrays, settings: RenderSettings,
                   mesh: Optional[RayMesh] = None,
                   iterations: Optional[int] = None, seed: int = 0,
                   chunk: int = 16, early_exit: bool = True) -> np.ndarray:
    """The full progressive render with the pool sharded over `mesh`
    (default `make_ray_mesh()`); returns the averaged [H, W, 3] image, the
    single-device `render`'s bit for bit."""
    if mesh is None:
        mesh = make_ray_mesh()
    n_total = settings.iterations if iterations is None else iterations
    settings = _interleaved(settings, mesh.n_shards)
    scenes = replicate(scene, mesh)
    accum = shard_accum(zero_accum(settings, mesh.devices[0]), mesh)
    done = 0
    while done < n_total:
        this = min(chunk, n_total - done)
        render_chunk_sharded(scenes, settings, mesh, accum, done + 1, this,
                             seed, early_exit)
        done += this
    return fetch_image(accum, settings, n_total, mesh)


def render_persistent_sharded(scene: SceneArrays, settings: RenderSettings,
                              mesh: Optional[RayMesh] = None,
                              iterations: Optional[int] = None,
                              seed: int = 0, chunk: int = 64) -> np.ndarray:
    """The persistent engine over `mesh`: each shard runs its own rotating
    lane -> pixel schedule over its block (stride `pixel_stride(n_local)`),
    with global pixel ids, so every sample draws the numbers it draws in
    the single-device render; the image agrees up to the order of float
    additions. The host loop reads each shard's state a step, so ranks may
    run different numbers of steps; they meet at the gather."""
    if mesh is None:
        mesh = make_ray_mesh()
    spp = settings.iterations if iterations is None else iterations
    n_local = mesh.n_local(settings)
    settings = _interleaved(settings, mesh.n_shards)
    stride = pixel_stride(n_local)
    accum = []
    for sc, s, dev in zip(replicate(scene, mesh), mesh.shards,
                          mesh.devices):
        state = fresh_lanes(settings, dev, n=n_local)
        done = 0
        while done < spp:
            done = min(done + chunk, spp)
            state = render_persistent_chunk(sc, settings, state, done, seed,
                                            stride, pixel_offset=s * n_local)
        accum.append(state.accum)
    return fetch_image(tuple(accum), settings, spp, mesh)


def _sync(mesh: RayMesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def scaling_efficiency(scene: SceneArrays, settings: RenderSettings,
                       shard_counts, iterations: int = 32, seed: int = 0,
                       devices=None) -> dict:
    """Rays/s on local meshes of each size in `shard_counts` (devices as
    `make_ray_mesh`), and the efficiency against linear scaling from the
    first: {n: {"rays_per_s", "efficiency"}}. Local shards on one device
    run in turn, so there it measures the cost of splitting the pool, not
    scaling."""
    results, base = {}, None
    for n in shard_counts:
        mesh = make_ray_mesh(n, devices)
        scenes = replicate(scene, mesh)
        accum = shard_accum(zero_accum(settings, mesh.devices[0]), mesh)
        render_chunk_sharded(scenes, settings, mesh, accum, 1, iterations,
                             seed)                                # warm-up
        _sync(mesh)
        t0 = time.perf_counter()
        render_chunk_sharded(scenes, settings, mesh, accum, 1 + iterations,
                             iterations, seed)
        _sync(mesh)
        rays_s = settings.pixel_count * iterations / (time.perf_counter()
                                                      - t0)
        if base is None:
            base = (n, rays_s)
        results[n] = {"rays_per_s": rays_s,
                      "efficiency": rays_s / (base[1] * n / base[0])}
    return results


def shard_work_counts(scene: SceneArrays, settings: RenderSettings,
                      mesh: RayMesh, iterations: int = 4, seed: int = 0,
                      interleave: bool = True) -> np.ndarray:
    """Each shard's path-tracing work: live lane-bounces summed over the
    bounce loop and `iterations` samples ([n_shards] int64, on every rank).

    Tracing does no communication, so the loss of scaling efficiency one
    can control is the imbalance of work between shards: max / mean of
    these counts bounds it (pathtracer_tpu/parallel/sharding.py:211 has
    the argument). `interleave=False` counts contiguous bands."""
    n_local = mesh.n_local(settings)
    if interleave:
        settings = _interleaved(settings, mesh.n_shards)
    counts = []
    for sc, s in zip(replicate(scene, mesh), mesh.shards):
        tot = 0
        for k in range(iterations):
            c = ray_survival(sc, settings, 1 + k, seed=seed, n=n_local,
                             pixel_offset=s * n_local)
            tot += int(c[:-1].sum())
        counts.append(tot)
    local = torch.tensor(counts, dtype=torch.int64)
    if mesh.group is not None:
        local = torch.cat(_all_gather(local.to(mesh.devices[0]), mesh))
    return local.cpu().numpy()


def albedo_fit_step(scene: SceneArrays, settings: RenderSettings,
                    mesh: RayMesh, target: tuple, iteration: int,
                    lr: float = 0.5, seed: int = 0):
    """One differentiable-rendering SGD step with the pool sharded over
    `mesh`: each shard renders its block of one fixed-depth iteration and
    takes the value and gradient of its share of the L2 loss against its
    block of `target` (tools/fit_albedo.albedo_loss, over 3 * the whole
    pixel count); the gradients and losses are summed (in shard order over
    local shards, by one all-reduce over a group, after the backward, as
    the JAX package psums after value_and_grad); then the SGD step,
    clipped to [0, 1]. Returns (new_scene, loss), the same on every
    rank."""
    n_local = mesh.n_local(settings)
    settings = _interleaved(settings, mesh.n_shards)
    loss = g = None
    for sc, s, tgt in zip(replicate(scene, mesh), mesh.shards, target):
        l_s, g_s = value_and_grad(
            albedo_loss(sc, settings, tgt, iteration, seed,
                        pixel_offset=s * n_local, key_salt=s),
            sc.materials.color)
        l_s, g_s = l_s.to(scene.device), g_s.to(scene.device)
        loss, g = (l_s, g_s) if loss is None else (loss + l_s, g + g_s)
    if mesh.group is not None:
        both = all_reduce(torch.cat([g.reshape(-1), loss.reshape(1)]),
                           mesh)
        g, loss = both[:-1].reshape(g.shape), both[-1]
    return sgd_albedo(scene, g, lr), loss
