"""Times of the cull, stream, packet-walk, scan, 8-wide walk and
brute-force kernels (B1-B7) on the inputs of their paths, by CUDA events
and by torch.profiler's device time, for comparing two checkouts of the
port on one card:

    python pathtracer_tpu_torch/utils/kernel_bench.py [--root DIR] \
        [--json FILE]

`--root` is the checkout whose `pathtracer_tpu_torch` is imported and whose
kernels are built (default: the one holding this file), so the same script
times an older checkout unpacked beside this one. Inputs, as chip_smoke.py
phases 3 and 9 take them: the teapot 800x800 bounce-1 pool, and every cull
and stream call of its binned intersection (three culls and two streams,
each on its pass's inputs); the bounce-1 pass-1 cull and stream of
animal.json at 800x800 (48-row treelets); the packet walk's binned-fallback
call on the teapot pool and the walk over every live lane (bvh_impl
"pallas"); the scan on the teapot pool's int32 liveness mask and on 2^24 + 3
random bits, beside torch.cumsum; the 8-wide walk (push, push with the
cull, mask), each input the call that the path makes (captured by
wrapping ops/wide.py wide_walk, so every checkout's own arguments are
replayed): the teapot's camera rays and bounce-1 pool through bvh_impl
"wide", the bounce-1 pool through "wide_nosort" and through the binned
intersector with the wide fallback, and animal's bounce-1 pool through
"wide"; the brute-force kernel (through mesh_intersect_brute, whose
signature every checkout shares) on every lane of the teapot and animal
bounce-1 pools. Each kernel's outputs are checked against its plain
version first, floats by their bits (brute: the whole teapot pool and the
first BRUTE_CHECK_LANES animal lanes; the plain version over every animal
lane takes too long). Prints one JSON object, with the card's name and
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
# the bound of an 8-wide walk call (chip_smoke.py's rates and operation
# counts): the larger of its bytes over 3.35 TB/s and its FP32 operations
# (25 a slab test, 55 a triangle test) over 67 TFLOP/s
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
OPS_BOX, OPS_TRI = 25, 55
BRUTE_CHECK_LANES = {"teapot": None, "animal": 65536}   # None: every lane
PAD_SPINS = 16       # spin kernels on each side of a profiled window
SPIN_CYCLES = 1000   # clock cycles a spin kernel waits
ATTEMPTS = 3         # profiles device_ms takes before it gives up


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
    (ms, {device kernel or memset name: ms per call}).

    Late in a long process the profiler drops device activities: on an
    H100, a session's first one or two (9 of 10 calls recorded), and once
    the memsets and first kernels of 12 of 20 calls, with CPU and CUDA
    tracing alike. So the calls are framed by PAD_SPINS short spin kernels
    on each side, left out of the sums, which absorb a loss at either end;
    every other kernel or memset must be recorded a whole multiple of
    `reps` times, and a profile that fails this is taken again, up to
    ATTEMPTS times, after which this raises rather than report a time with
    calls missing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(reps):
                fn()
            for _ in range(PAD_SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        by_name, counts = {}, {}
        for evt in prof.key_averages():
            if (evt.device_type == DeviceType.CUDA
                    and evt.self_device_time_total
                    and "spin_kernel" not in evt.key):
                by_name[evt.key] = (by_name.get(evt.key, 0.0)
                                    + evt.self_device_time_total / 1000.0
                                    / reps)
                counts[evt.key] = counts.get(evt.key, 0) + evt.count
        lost = {k: n for k, n in counts.items() if n % reps}
        if not lost:
            return sum(by_name.values()), by_name
    raise RuntimeError(f"device_ms: over {reps} calls the profiler "
                       f"recorded {lost} ({ATTEMPTS} attempts)")


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


def same_bits(got, ref) -> bool:
    """Every output tensor equal, floats by their bits (so -0 and +0, or two
    NaNs of other payloads, differ)."""
    import torch

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return all(torch.equal(bits(a), bits(b)) for a, b in zip(got, ref))


def bounce1(scene, settings, dev):
    """One iteration's bounce-1 state of `scene` and its live mask."""
    from pathtracer_tpu_torch.engine import wavefront
    from pathtracer_tpu_torch.ops import rng
    irng = rng.IterationRng(0, 1, pixel_map=settings.pixel_map())
    state = wavefront.generate_paths(scene, settings, irng)
    accum = wavefront.zero_accum(settings, dev)
    state = wavefront.bounce_step(scene, settings, irng, 0, state, accum)
    return state, state.remaining_bounces > 0


def binned_calls(scene, settings, state, live) -> dict:
    """The arguments of every cull, stream and packet-walk call of the
    binned intersection of `state`'s rays, in call order."""
    from pathtracer_tpu_torch.ops import binned, bvh_packet
    from pathtracer_tpu_torch.ops.intersect import intersect_scene
    calls = {"cull": [], "stream": [], "packet": []}

    def recording(name, fn):
        def wrapper(*args):
            calls[name].append(args)
            return fn(*args)
        return wrapper

    with mock.patch.object(binned, "cull", recording("cull", binned.cull)), \
            mock.patch.object(binned, "stream",
                              recording("stream", binned.stream)), \
            mock.patch.object(bvh_packet, "packet_walk",
                              recording("packet", bvh_packet.packet_walk)):
        intersect_scene(scene, settings.geom_types, state.origin,
                        state.direction, bvh_impl="binned", active=live)
    return calls


def bench_binned(kern, plain, args, n_work: int) -> dict:
    """A cull or stream call: bit-equal to its plain version, then timed."""
    if not same_bits(kern(*args), plain(*args)):
        raise AssertionError(f"{kern.__name__}: differs from plain")
    rec = timed(lambda: kern(*args))
    rec.update(lanes=args[-1].shape[0], work=n_work,
               host_us=host_us(lambda: kern(*args), 200))
    return rec


def bench_brute(scene, state, check_lanes) -> dict:
    """The brute-force kernel on every lane of `state`'s rays: bit-equal to
    brute_plain on the first `check_lanes` lanes (None: all), then timed."""
    import torch
    from pathtracer_tpu_torch.ops import brute

    def call():
        t, nrm, mat = brute.mesh_intersect_brute(scene, state.origin,
                                                 state.direction)
        return t, *nrm, mat
    sl = slice(None, check_lanes)
    ref = brute.brute_plain(scene.tris_mxu_c, scene.tris_mxu_n,
                            *(c[sl].contiguous() for c in state.origin),
                            *(c[sl].contiguous() for c in state.direction))
    got = call()
    if not same_bits([g[sl] for g in got], ref):
        raise AssertionError("brute: differs from plain")
    rec = timed(call, reps=10)
    rec.update(lanes=got[0].shape[0], checked=ref[0].shape[0],
               hits=int((got[0] > 0).sum()),
               slots=scene.tris_mxu_n.shape[0],
               sweep=getattr(scene, "brute_tris", scene.tris_mxu_n.shape[0]),
               host_us=host_us(call, 20))
    torch.cuda.synchronize()
    return rec


def wide_calls(name, scene, settings, state, live) -> dict:
    """{input: (args, kwargs)} of the 8-wide walk call that each path makes
    on `state`'s rays: bvh_impl "wide" (and, for the teapot, "wide_nosort"
    and the binned intersector with the wide fallback)."""
    from pathtracer_tpu_torch.ops import binned, wide
    from pathtracer_tpu_torch.ops.intersect import intersect_scene
    paths = {"wide": ("wide", "packet")}
    if name == "teapot":
        paths.update(nosort=("wide_nosort", "packet"),
                     fallback=("binned", "wide"))
    calls = {}
    for key, (impl, fallback) in paths.items():
        got = []

        def recording(*args, **kwargs):
            got.append((args, kwargs))
            return walk(*args, **kwargs)
        walk = wide.wide_walk
        with mock.patch.object(wide, "wide_walk", recording), \
                mock.patch.object(binned, "FALLBACK_IMPL", fallback):
            intersect_scene(scene, settings.geom_types, state.origin,
                            state.direction, bvh_impl=impl, active=live)
        calls[key] = got[0]
    return calls


def bench_wide(args, kwargs) -> dict:
    """One 8-wide walk call with push, push with the cull and mask: each
    bit-equal to the plain walk of its variant, then timed; with the box
    and triangle tests the walk makes and its bound (bytes: 32 a child slot
    of the node table, the triangle table, the ray planes of the active
    lanes, the active mask and the outputs of every lane)."""
    from pathtracer_tpu_torch.ops import wide
    counts = {}
    plain = {v: wide.wide_walk_plain(*args, variant=v,
                                     counts=counts if v == "push" else None)
             for v in wide.VARIANTS}
    if not same_bits(plain["push"], plain["mask"]):
        raise AssertionError("wide: the plain push and mask walks differ")
    n, active = args[4].shape[0], int((args[10] > 0).sum())
    n_bytes = (args[0].shape[0] * 2 * 8 * 32 + 4 * args[2].numel()
               + 28 * active + 24 * n)
    ops = OPS_BOX * counts["box_tests"] + OPS_TRI * counts["tri_tests"]
    rec = {"lanes": n, "active": active, **counts, "bytes": n_bytes,
           "ops": ops,
           "bound_ms": 1e3 * max(n_bytes / PEAK_BYTES, ops / PEAK_FLOPS)}
    for label, kw in (("push", {"variant": "push"}),
                      ("push_cull", {"variant": "push", "cull": True}),
                      ("mask", {"variant": "mask"})):
        kw = {**kwargs, **kw}

        def call():
            return wide.wide_walk(*args, **kw)
        if not same_bits(call(), plain[kw["variant"]]):
            raise AssertionError(f"wide {label}: differs from plain")
        rec[label] = timed(call)
        rec[label]["host_us"] = host_us(call, 200)
    rec["hits"] = int((plain["push"][0] > 0).sum())
    return rec


def bench() -> dict:
    import torch
    from pathtracer_tpu_torch import load_scene
    from pathtracer_tpu_torch.ops import binned, bvh_packet, kernels, scan

    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: torch sees no CUDA device")
    dev = torch.device("cuda")
    _, secs, _ = kernels.build()
    out = {"card": card_line(), "root": os.path.dirname(os.path.dirname(
        os.path.abspath(kernels.__file__))), "build_s": secs}
    pools = {}
    with torch.inference_mode():
        for name in ("teapot", "animal"):
            scene, settings = load_scene(f"scenes/{name}.json", dev,
                                         brute_tables=True, wide_tables=True)
            if name == "teapot":
                from pathtracer_tpu_torch.engine import wavefront
                from pathtracer_tpu_torch.ops import rng
                camera = wavefront.generate_paths(scene, settings,
                                                  rng.IterationRng(
                                                      0, 1, pixel_map=settings
                                                      .pixel_map()))
                args, kwargs = wide_calls(
                    name, scene, settings, camera,
                    camera.remaining_bounces > 0)["wide"]
                out["wide_teapot_camera"] = bench_wide(args, kwargs)
            state, live = bounce1(scene, settings, dev)
            pools[name] = scene, state
            for key, (args, kwargs) in wide_calls(name, scene, settings,
                                                  state, live).items():
                out[f"wide_{name}_{key}"] = bench_wide(args, kwargs)
            calls = binned_calls(scene, settings, state, live)
            if name == "teapot":
                teapot = scene, state, live, calls["packet"][0]
            else:                      # pass 1 only
                calls = {k: v[:1] for k, v in calls.items()}
            for k, args in enumerate(calls["cull"]):
                out[f"cull_{name}_{k}"] = bench_binned(
                    binned.cull, binned.cull_plain, args,
                    int((args[-1] > 0).sum()))
            for k, args in enumerate(calls["stream"]):
                tid = args[-1]
                out[f"stream_{name}_{k}"] = bench_binned(
                    binned.stream, binned.stream_plain, args,
                    int(((tid >= 0) & (tid < args[0].numel() // 4)).sum()))
        scene, state, live, fallback = teapot
        n = live.shape[0]
        inputs = {
            "fallback": fallback,
            "all_live": (scene.bvh_packed_f, scene.bvh_packed_i,
                         scene.tris_packed, scene.mesh_roots[0],
                         *(c.contiguous() for c in state.origin),
                         *(c.contiguous() for c in state.direction),
                         live.to(torch.int32),
                         torch.full((n,), FLT_MAX, device=dev))}
        for name, args in inputs.items():
            got = bvh_packet.packet_walk(*args)
            ref = bvh_packet.packet_walk_plain(*args)
            equal = same_bits(got, ref)
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
        for name, (b_scene, b_state) in pools.items():
            out["brute_" + name] = bench_brute(b_scene, b_state,
                                               BRUTE_CHECK_LANES[name])
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
