"""Times of the packet walk and the scan on the main path's inputs, by CUDA
events and by torch.profiler's device time, for comparing two checkouts of
the port on one card:

    python pathtracer_tpu_torch/utils/kernel_bench.py [--root DIR] \
        [--json FILE]

`--root` is the checkout whose `pathtracer_tpu_torch` is imported and whose
kernels are built (default: the one holding this file), so the same script
times an older checkout unpacked beside this one. Inputs, as chip_smoke.py
phases 3 and 9 take them: the teapot 800x800 bounce-1 pool; the packet
walk's binned-fallback call on it and the walk over every live lane
(bvh_impl "pallas"); the scan on its int32 liveness mask and on 2^24 + 3
random bits, beside torch.cumsum. Each kernel's outputs are checked against
its plain version first. Prints one JSON object, with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

FLT_MAX = 3.402823466e38


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int, warmup: int = 2) -> tuple[float, dict]:
    """torch.profiler's device time of fn() per call, over `reps` calls:
    (ms, {device kernel or memset name: ms per call})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            by_name[evt.key] = (by_name.get(evt.key, 0.0)
                                + evt.self_device_time_total / 1000.0 / reps)
    return sum(by_name.values()), by_name


def host_us(fn, calls: int) -> float:
    """Host microseconds a call of fn(), over `calls` calls issued without
    a synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 20) -> dict:
    ms = cuda_ms(fn, reps)
    dms, by_name = device_ms(fn, reps)
    return {"ms": ms, "device_ms": dms, "device_by_kernel": by_name}


def bench() -> dict:
    import torch
    from pathtracer_tpu_torch import load_scene
    from pathtracer_tpu_torch.engine import wavefront
    from pathtracer_tpu_torch.ops import bvh_packet, kernels, rng, scan
    from pathtracer_tpu_torch.ops.intersect import intersect_scene

    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: torch sees no CUDA device")
    dev = torch.device("cuda")
    _, secs, _ = kernels.build()
    out = {"card": card_line(), "root": os.path.dirname(os.path.dirname(
        os.path.abspath(kernels.__file__))), "build_s": secs}
    scene, settings = load_scene("scenes/teapot.json", dev)
    captured = {}
    real = bvh_packet.packet_walk

    def recording(*args):
        captured.setdefault("packet", args)
        return real(*args)

    with torch.inference_mode():
        irng = rng.IterationRng(0, 1, pixel_map=settings.pixel_map())
        state = wavefront.generate_paths(scene, settings, irng)
        accum = wavefront.zero_accum(settings, dev)
        state = wavefront.bounce_step(scene, settings, irng, 0, state, accum)
        live = state.remaining_bounces > 0
        with mock.patch.object(bvh_packet, "packet_walk", recording):
            intersect_scene(scene, settings.geom_types, state.origin,
                            state.direction, bvh_impl="binned", active=live)
        n = live.shape[0]
        inputs = {
            "fallback": captured["packet"],
            "all_live": (scene.bvh_packed_f, scene.bvh_packed_i,
                         scene.tris_packed, scene.mesh_roots[0],
                         *(c.contiguous() for c in state.origin),
                         *(c.contiguous() for c in state.direction),
                         live.to(torch.int32),
                         torch.full((n,), FLT_MAX, device=dev))}
        for name, args in inputs.items():
            got = bvh_packet.packet_walk(*args)
            ref = bvh_packet.packet_walk_plain(*args)
            equal = all(torch.equal(a, b) for a, b in zip(got, ref))
            if not equal:
                raise AssertionError(f"packet {name}: differs from plain")
            rec = timed(lambda: bvh_packet.packet_walk(*args))
            rec.update(lanes=args[4].shape[0],
                       active=int((args[10] > 0).sum()), equal=equal,
                       host_us=host_us(lambda: bvh_packet.packet_walk(*args),
                                       200))
            out["packet_" + name] = rec
        gen = torch.Generator(device=dev).manual_seed(0)
        for name, x in (("mask", live.to(torch.int32)),
                        ("big", torch.randint(0, 2, (2 ** 24 + 3,),
                                              device=dev, dtype=torch.int32,
                                              generator=gen))):
            if not torch.equal(scan.exclusive_scan(x),
                               scan.exclusive_scan_plain(x)):
                raise AssertionError(f"scan {name}: differs from plain")
            rec = timed(lambda: scan.exclusive_scan(x))
            lib = timed(lambda: torch.cumsum(x, 0, dtype=x.dtype))
            rec.update(n=x.shape[0], library_ms=lib["ms"],
                       library_device_ms=lib["device_ms"],
                       library_by_kernel=lib["device_by_kernel"],
                       host_us=host_us(lambda: scan.exclusive_scan(x), 1000),
                       library_host_us=host_us(
                           lambda: torch.cumsum(x, 0, dtype=x.dtype), 1000))
            out["scan_" + name] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    res = bench()
    text = json.dumps(res)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    # run as a file: import the checkout named by --root (default: this
    # file's), and keep this directory off the path (its math.py and
    # profiling.py would shadow other modules)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    if "--root" in sys.argv:
        root = sys.argv[sys.argv.index("--root") + 1]
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.abspath(root))
    sys.exit(main())
