"""Where the time of a frame goes, for the port (the counterpart of
pathtracer_tpu/utils/profiling.py):

    python -m pathtracer_tpu_torch.utils.profiling scenes/teapot.json \
        [--iters 3] [--res R] [--depth D] [--json out.json] [--device cuda] \
        [--bvh wide]

Three measurements of whole iterations (`render_iteration` with early exit,
as `render` runs it), each after one warm-up iteration:

  * frame_ms: plain wall time per iteration, nothing traced;
  * device_profile: torch.profiler over the iterations. Device kernels are
    grouped by kind (`kernel_kind`); per frame it gives each kind's device
    time and launches, the traced wall time, and the device's busy share
    (device kernel time over wall time: the engine issues everything on one
    stream, so kernels barely overlap);
  * stage_times: each stage function wrapped in a timer that synchronizes
    the device before and after it, so a stage's time includes the host
    time of issuing its ops. Stages nest (a sort inside the mesh pipeline
    inside intersect), so their times are inclusive and do not add up.

It runs on the CUDA device unless `--device cpu` asks for the CPU, where
there is no device to trace: the device fields are then None.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from unittest import mock

import torch

from ..engine import wavefront
from ..ops import binned, brute, bvh_packet, intersect, wide
from .device import resolve_device

# (module, function, stage name), outermost first
STAGES = (
    (wavefront, "generate_paths", "raygen"),
    (wavefront, "intersect_scene", "intersect"),
    (intersect, "box_intersect", "intersect.box"),
    (intersect, "sphere_intersect", "intersect.sphere"),
    (binned, "mesh_intersect_binned", "intersect.mesh_binned"),
    (binned, "_seg_sort", "mesh_binned.sorts"),
    (binned, "cull", "mesh_binned.cull"),
    (binned, "stream", "mesh_binned.stream"),
    (bvh_packet, "packet_walk", "mesh.packet"),
    (wide, "wide_walk", "mesh.wide"),
    (brute, "brute", "mesh.brute"),
    (wavefront, "shade", "shade"),
)

# device kernel name fragment -> kind, first match wins
KINDS = (
    ("cull_kernel", "cull kernel"),
    ("stream_kernel", "stream kernel"),
    ("packet_kernel", "packet kernel"),
    ("wide_push_kernel", "wide push kernel"),
    ("wide_mask_kernel", "wide mask kernel"),
    ("brute_kernel", "brute kernel"),
    ("memcpy", "memcpy/memset"),
    ("memset", "memcpy/memset"),
    ("sort", "sorts"),
    ("radix", "sorts"),
    ("gather", "gathers/indexing"),
    ("index", "gathers/indexing"),
    ("scatter", "gathers/indexing"),
    ("fill", "fills"),
    ("reduce", "reductions"),
)


def kernel_kind(name: str) -> str:
    """The kind a device kernel's (mangled) name belongs to."""
    low = name.lower()
    for frag, kind in KINDS:
        if frag in low:
            return kind
    return "elementwise/other"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _iterations(scene, settings, iters: int, seed: int, start: int) -> None:
    accum = wavefront.zero_accum(settings, scene.device)
    wavefront.render_chunk(scene, settings, accum, start, iters, seed, True)
    _sync(scene.device)


def frame_ms(scene, settings, iters: int = 3, seed: int = 0) -> float:
    """Wall milliseconds per iteration, after one warm-up iteration."""
    _iterations(scene, settings, 1, seed, 1)
    t0 = time.perf_counter()
    _iterations(scene, settings, iters, seed, 2)
    return 1000.0 * (time.perf_counter() - t0) / iters


def device_profile(scene, settings, iters: int = 3, seed: int = 0) -> dict:
    """torch.profiler over `iters` iterations: per frame, the traced wall
    ms, and on a CUDA device the device kernel ms, launches and busy share,
    in all and by kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = scene.device
    on_gpu = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_gpu else [])
    _iterations(scene, settings, 1, seed, 1)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        _iterations(scene, settings, iters, seed, 2)
        wall_ms = 1000.0 * (time.perf_counter() - t0) / iters
    out = {"wall_ms": wall_ms, "device_ms": None, "launches": None,
           "busy_share": None, "by_kind": None}
    if not on_gpu:
        return out
    by_kind = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        kind = kernel_kind(evt.key)
        ms, n = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (ms + evt.self_device_time_total / 1000.0 / iters,
                         n + evt.count / iters)
    device_ms = sum(ms for ms, _ in by_kind.values())
    out.update(device_ms=device_ms,
               launches=sum(n for _, n in by_kind.values()),
               busy_share=device_ms / wall_ms,
               by_kind={k: {"ms": ms, "launches": n} for k, (ms, n) in
                        sorted(by_kind.items(), key=lambda kv: -kv[1][0])})
    return out


def stage_times(scene, settings, iters: int = 3, seed: int = 0) -> dict:
    """Per frame, each stage's synchronized wall ms and number of calls."""
    dev = scene.device
    acc = {}

    def timed(fn, name):
        def wrapper(*args, **kwargs):
            _sync(dev)
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            _sync(dev)
            ms, calls = acc.get(name, (0.0, 0))
            acc[name] = (ms + 1000.0 * (time.perf_counter() - t0), calls + 1)
            return res
        return wrapper

    _iterations(scene, settings, 1, seed, 1)
    with contextlib.ExitStack() as stack:
        for mod, attr, name in STAGES:
            stack.enter_context(mock.patch.object(
                mod, attr, timed(getattr(mod, attr), name)))
        t0 = time.perf_counter()
        _iterations(scene, settings, iters, seed, 2)
        wall = 1000.0 * (time.perf_counter() - t0) / iters
    stages = {name: {"ms": acc[name][0] / iters, "calls": acc[name][1] / iters}
              for _, _, name in STAGES if name in acc}
    return {"wall_ms": wall, "stages": stages}


def report(scene_file: str, device, iters: int = 3, seed: int = 0,
           overrides: dict | None = None, bvh: str | None = None) -> dict:
    """All three measurements of one scene on `device`, through the mesh
    intersector `bvh` (None: the loader's pick)."""
    from ..scene.loader import load_scene
    scene, settings = load_scene(scene_file, device, overrides=overrides,
                                 bvh_impl=bvh)
    with torch.inference_mode():
        return {
            "scene": scene_file, "device": str(scene.device),
            "bvh": settings.bvh_impl,
            "res": [settings.width, settings.height],
            "depth": settings.trace_depth, "iters": iters,
            "frame_ms": frame_ms(scene, settings, iters, seed),
            "device_profile": device_profile(scene, settings, iters, seed),
            "stage_times": stage_times(scene, settings, iters, seed),
        }


def format_report(rep: dict) -> str:
    lines = [f"{rep['scene']} {rep['res'][0]}x{rep['res'][1]} "
             f"d{rep['depth']} bvh {rep['bvh']} on {rep['device']}, "
             f"{rep['iters']} iterations:"
             f" untraced {rep['frame_ms']:.2f} ms/frame"]
    prof = rep["device_profile"]
    lines.append(f"  traced wall {prof['wall_ms']:.2f} ms/frame")
    if prof["device_ms"] is not None:
        lines.append(f"  device kernels {prof['device_ms']:.2f} ms/frame, "
                     f"{prof['launches']:.0f} launches/frame, busy "
                     f"{100.0 * prof['busy_share']:.1f}%")
        for kind, v in prof["by_kind"].items():
            lines.append(f"    {kind:<20}{v['ms']:>10.3f} ms"
                         f"{v['launches']:>10.0f} launches")
    st = rep["stage_times"]
    lines.append(f"  synchronized stages (wall {st['wall_ms']:.2f} "
                 "ms/frame, inclusive):")
    for name, v in st["stages"].items():
        lines.append(f"    {name:<24}{v['ms']:>10.3f} ms"
                     f"{v['calls']:>8.1f} calls")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.utils.profiling")
    ap.add_argument("scenes", nargs="+")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=str, default=None,
                    help="also write the reports to this file")
    ap.add_argument("--device", default="cuda",
                    help="torch device to profile on (default cuda)")
    ap.add_argument("--bvh", choices=intersect.BVH_IMPLS, default=None,
                    help="mesh intersector (default: the loader's pick)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    overrides = {}
    if args.res is not None:
        overrides["RES"] = [args.res, args.res]
    if args.depth is not None:
        overrides["DEPTH"] = args.depth
    reps = []
    for s in args.scenes:
        rep = report(s, device, args.iters, args.seed, overrides or None,
                     args.bvh)
        print(format_report(rep), flush=True)
        reps.append(rep)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(reps, f, indent=1)


if __name__ == "__main__":
    main()
