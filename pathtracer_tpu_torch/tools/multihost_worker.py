"""One rank of a multi-process render (the port's counterpart of the repo's
tools/multihost_worker.py).

    torchrun --nproc_per_node=N -m pathtracer_tpu_torch.tools.multihost_worker \
        scene.json out [--res R] [--spp S] [--depth D] [--fit]

    python -m pathtracer_tpu_torch.tools.multihost_worker scene.json out \
        --init-method tcp://127.0.0.1:PORT --world-size N --rank R \
        [--backend gloo] [--device cpu] ...

Each rank joins the group (parallel/distributed.init_distributed: env://
under torchrun, else the given address, world size and rank), renders the
scene over the group's mesh (one shard a rank) after one warm-up
iteration, and writes the assembled image, the same on every rank, to
<out>.<rank>.npy. `--fit` also takes one sharded albedo step
(parallel/sharding.albedo_fit_step) from the albedo perturbed as
tools/fit_albedo perturbs it, against the target of iteration 1, and writes
the new albedo to <out>.albedo.<rank>.npy. Then it times one gather of the
pool and one all-reduce of the gradient's size, and prints one JSON line:
the rank, ms a frame, the kernel launches of the timed render, the fit's
loss and ms, the collectives' ms and the peak device memory.

The backend is NCCL by default (one card a rank); gloo serves ranks on the
CPU, or ranks that share one card. `--device` (default cuda) is the rank's
device; a bare "cuda" is the card that init_distributed made current.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_REPS = 5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.multihost_worker")
    ap.add_argument("scene")
    ap.add_argument("out", help="output prefix: <out>.<rank>.npy")
    ap.add_argument("--res", type=int, default=None,
                    help="override square resolution")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=None, help="override DEPTH")
    ap.add_argument("--fit", action="store_true",
                    help="also take one sharded albedo step")
    ap.add_argument("--device", default="cuda",
                    help="this rank's torch device (default cuda)")
    ap.add_argument("--backend", default=None,
                    help="nccl (default) or gloo")
    ap.add_argument("--init-method", default=None,
                    help="default env://, as torchrun sets it")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args(argv)

    from .. import load_scene
    from ..ops import kernels
    from ..parallel.distributed import (global_ray_mesh, init_distributed,
                                        make_global_accum,
                                        render_distributed)
    from ..parallel.sharding import (all_reduce, albedo_fit_step,
                                     gather_accum, render_chunk_sharded)
    from ..utils.grad import with_materials
    from .fit_albedo import perturbed_albedo

    if args.device == "cpu":
        torch.set_num_threads(1)
    init_distributed(args.backend, args.init_method, args.world_size,
                     args.rank)
    try:
        mesh = global_ray_mesh(args.device)
        device = mesh.devices[0]
        rank = dist.get_rank()
        overrides = {"ITERATIONS": args.spp}
        if args.res is not None:
            overrides["RES"] = [args.res, args.res]
        if args.depth is not None:
            overrides["DEPTH"] = args.depth
        scene, settings = load_scene(args.scene, device, overrides=overrides)
        report = {"rank": rank, "world": mesh.n_shards,
                  "backend": dist.get_backend(), "device": str(device),
                  "bvh_impl": settings.bvh_impl,
                  "size": [settings.width, settings.height,
                           settings.trace_depth]}
        if device.type == "cuda":
            report["card"] = torch.cuda.get_device_name(device)
            torch.cuda.reset_peak_memory_stats(device)

        render_distributed(scene, settings, iterations=1, device=device)
        _sync(device)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        img = render_distributed(scene, settings, iterations=args.spp,
                                 device=device)
        _sync(device)
        report["ms_per_frame"] = (1000.0 * (time.perf_counter() - t0)
                                  / args.spp)
        report["launches"] = {k: v for k, v in kernels.LAUNCHES.items()
                              if v}
        np.save(f"{args.out}.{rank}.npy", img)

        target = render_chunk_sharded(
            scene, settings, mesh, make_global_accum(settings, mesh), 1, 1,
            seed=0, early_exit=False)
        if args.fit:
            wrong = with_materials(scene, color=torch.as_tensor(
                perturbed_albedo(scene.materials.color.cpu().numpy(), 0.25),
                dtype=torch.float32, device=device))
            t0 = time.perf_counter()
            new, loss = albedo_fit_step(wrong, settings, mesh, target, 1,
                                        lr=1.0, seed=0)
            _sync(device)
            report["fit_ms"] = 1000.0 * (time.perf_counter() - t0)
            report["fit_loss"] = float(loss)
            np.save(f"{args.out}.albedo.{rank}.npy",
                    new.materials.color.cpu().numpy())

        grad_like = torch.zeros(scene.materials.color.numel() + 1,
                                device=device)
        for name, fn in (("gather_ms", lambda: gather_accum(target, mesh)),
                         ("all_reduce_ms",
                          lambda: all_reduce(grad_like, mesh))):
            fn()
            dist.barrier()
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(COLLECTIVE_REPS):
                fn()
            _sync(device)
            report[name] = (1000.0 * (time.perf_counter() - t0)
                            / COLLECTIVE_REPS)
        if device.type == "cuda":
            report["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        print(json.dumps(report), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
