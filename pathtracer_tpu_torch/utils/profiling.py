"""Where the time of a frame goes, for the port (the counterpart of
pathtracer_tpu/utils/profiling.py):

    python -m pathtracer_tpu_torch.utils.profiling scenes/teapot.json \
        [--iters 3] [--res R] [--depth D] [--json out.json] [--device cuda] \
        [--bvh wide] [--fallback packet|wide] \
        [--mode masked|sorted|tiled|persistent] [--tile 16000] \
        [--frame compiled|eager]

Three measurements of whole iterations (`render_chunk` with early exit, as
`render` runs it, in the wavefront mode `--mode`; or, for
`--mode persistent`, the persistent engine over as many samples), each after
one warm-up iteration:

  * frame_ms: plain wall time per iteration, nothing traced;
  * device_profile: torch.profiler over the iterations. Device kernels are
    grouped by kind (`kernel_kind`); per frame it gives each kind's device
    time and launches, the traced wall time, the device's busy share
    (device kernel time over wall time: the engine issues everything on one
    stream, so kernels barely overlap) and the host's launch calls
    (`is_host_launch`: a graph replay is one). The device-side spans of the
    engine's and the binned intersector's profiler ranges are no kernels
    and are left out (`is_range_span`);
  * stage_times: each stage function wrapped in a timer that synchronizes
    the device before and after it, so a stage's time includes the host
    time of issuing its ops. Stages nest (a sort inside the mesh pipeline
    inside intersect), so their times are inclusive and do not add up.
    Always the eager frame: a graph replay calls no stage function (the
    compiled frame's split is graph_stages, below).
The first two time the frame `--frame` names: "compiled" (the default,
render_chunk: a graph replay an iteration where engine/wavefront.py
eager_reason allows, what users run) or "eager" (render_chunk_eager).
Beside device_profile, the compiled frame's own split by stage
(`graph_stages`): the span recorder's device ms an iteration of pt_raygen,
pt_intersect, pt_shade and pt_gather, timed by events inside each
frame's timed graph (utils/spans.py), from the untraced timed replays of
these measurements;
the host ms of the compiled frame's calls, split into its spans
(`frame_host`: pt_frame.key, .copy, .launch and the call's self time);
the graphs captured, dropped past the cache's budget and cached, with
their pools' bytes (`graph_cache`).

It runs on the CUDA device unless `--device cpu` asks for the CPU, where
there is no device to trace: the device fields are then None.

`measure_stages` is the other contract, the JAX package's (printed by
`python -m pathtracer_tpu_torch.tools.perfstats`): raygen, intersect, shade
and gather each called on its own on one pool, synchronized, beside the
eager frame (render_chunk_eager).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import statistics
import time
from unittest import mock

import torch

from ..engine import persistent, wavefront
from ..ops import (binned, brute, bsdf, bvh_packet, intersect, kernels, rng,
                   wide)
from . import spans
from .device import resolve_device
from .vec import Vec3

MODES = ("masked", "sorted", "tiled", "persistent")
FRAMES = ("compiled", "eager")

# (module, function, stage name), outermost first; the persistent engine's
# step has its own references to the stage functions
STAGES = (
    (wavefront, "generate_paths", "raygen"),
    (persistent, "generate_camera_rays", "raygen"),
    (wavefront, "intersect_scene", "intersect"),
    (persistent, "intersect_scene", "intersect"),
    (intersect, "analytic_hit", "intersect.analytic"),
    (intersect, "box_intersect", "intersect.box"),
    (intersect, "sphere_intersect", "intersect.sphere"),
    (binned, "mesh_intersect_binned", "intersect.mesh_binned"),
    (binned, "_seg_sort", "mesh_binned.sorts"),
    (binned, "cull", "mesh_binned.cull"),
    (binned, "stream", "mesh_binned.stream"),
    (bvh_packet, "packet_walk", "mesh.packet"),
    (wide, "wide_walk", "mesh.wide"),
    (brute, "brute", "mesh.brute"),
    (wavefront, "sort_by_key_segmented", "mode.sorts"),
    (wavefront, "sort_by_key_multisort", "mode.sorts"),
    (wavefront, "shade_lanes", "shade"),
    (persistent, "shade", "shade"),
    (bsdf, "shade", "shade.plain"),
)

# device kernel name fragment -> kind, first match wins: the port's kernels
# (ops/kernels.py KERNELS), the compactions their walks run beside them,
# then the torch op families
KINDS = (
    *((k.device_kernel, k.kind) for k in kernels.KERNELS),
    ("wide_compact_kernel", "wide compaction kernel"),
    ("packet_kernel", "packet kernel"),
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


# the port's stage ranges (utils/spans.py; engine/wavefront.py,
# ops/binned.py)
RANGES = spans.RANGES


def is_host_launch(evt) -> bool:
    """A host call of the CUDA driver or runtime that issues device work:
    a kernel launch, a graph launch, a memset or a memcpy."""
    return evt.key.startswith("cu") and any(
        w in evt.key for w in ("Launch", "Memset", "Memcpy"))


def is_range_span(evt) -> bool:
    """A range's own device-side span (the GPU user annotation that a
    record_function range gets when the CPU and the card are traced
    together): it covers the range's kernels, so counting it as a kernel
    counts them twice."""
    return evt.key in RANGES or bool(getattr(evt, "is_user_annotation",
                                             False))


def kernel_kind(name: str) -> str:
    """The kind a device kernel's (mangled) name belongs to."""
    low = name.lower()
    for frag, kind in KINDS:
        if frag in low:
            return kind
    return "elementwise/other"


# the device kernel that each counted launch of kernels.LAUNCHES runs once,
# by its name (the packet and wide walks' compactions and the deferring
# stream's support sort run beside it)
PORT_KERNELS = tuple((k.device_kernel, k.name) for k in kernels.KERNELS)
_PORT_NAME = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
    name for name, _ in PORT_KERNELS) + r")(?![A-Za-z0-9_])")


def port_launches(events, cuda) -> dict:
    """The port's kernel launches that the profiler saw run on the card:
    the count of `events` (profiler key averages) on device type `cuda`
    whose name holds a PORT_KERNELS name, by its kernels.LAUNCHES key (every
    key, 0 where none ran). A graph replay's kernels are seen by their own
    names, so this reads what a compiled frame ran."""
    keys = dict(PORT_KERNELS)
    out = dict.fromkeys(keys.values(), 0)
    for evt in events:
        if evt.device_type != cuda or is_range_span(evt):
            continue
        m = _PORT_NAME.search(evt.key)
        if m is not None:
            out[keys[m.group(1)]] += evt.count
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mode_settings(settings, mode: str, tile: int = 16000):
    """The settings of wavefront mode `mode` (persistent: unchanged)."""
    if mode == "sorted":
        return dataclasses.replace(settings, sort_materials=True)
    if mode == "tiled":
        return dataclasses.replace(settings, compact=True, compact_tile=tile)
    return settings


def _iterations(scene, settings, iters: int, seed: int, start: int,
                mode: str = "masked", frame: str = "compiled") -> None:
    """Iterations start .. start + iters - 1 (persistent: those samples),
    of the compiled frame (render_chunk) or the eager one."""
    if frame not in FRAMES:
        raise ValueError(f"frame {frame!r}: expected one of {FRAMES}")
    if mode == "persistent":
        state = persistent.fresh_lanes(settings, scene.device,
                                       start_spp=start - 1)
        persistent.render_persistent_chunk(scene, settings, state,
                                           start - 1 + iters, seed)
    else:
        chunk = (wavefront.render_chunk if frame == "compiled"
                 else wavefront.render_chunk_eager)
        accum = wavefront.zero_accum(settings, scene.device)
        chunk(scene, settings, accum, start, iters, seed, True)
    _sync(scene.device)


def frame_ms(scene, settings, iters: int = 3, seed: int = 0,
             mode: str = "masked", frame: str = "compiled") -> float:
    """Wall milliseconds per iteration, after one warm-up iteration."""
    _iterations(scene, settings, 1, seed, 1, mode, frame)
    t0 = time.perf_counter()
    _iterations(scene, settings, iters, seed, 2, mode, frame)
    return 1000.0 * (time.perf_counter() - t0) / iters


def device_profile(scene, settings, iters: int = 3, seed: int = 0,
                   mode: str = "masked", frame: str = "compiled") -> dict:
    """torch.profiler over `iters` iterations: per frame, the traced wall
    ms, and on a CUDA device the device kernel ms, launches and busy share,
    in all and by kind, and the host's launch calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = scene.device
    on_gpu = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_gpu else [])
    _iterations(scene, settings, 1, seed, 1, mode, frame)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        _iterations(scene, settings, iters, seed, 2, mode, frame)
        wall_ms = 1000.0 * (time.perf_counter() - t0) / iters
    out = {"wall_ms": wall_ms, "device_ms": None, "launches": None,
           "busy_share": None, "by_kind": None, "host_launches": None}
    if not on_gpu:
        return out
    by_kind = {}
    host_launches = 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            if is_host_launch(evt):
                host_launches += evt.count
            continue
        if is_range_span(evt):
            continue
        kind = kernel_kind(evt.key)
        ms, n = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (ms + evt.self_device_time_total / 1000.0 / iters,
                         n + evt.count / iters)
    device_ms = sum(ms for ms, _ in by_kind.values())
    out.update(device_ms=device_ms,
               launches=sum(n for _, n in by_kind.values()),
               busy_share=device_ms / wall_ms,
               host_launches=host_launches / iters,
               by_kind={k: {"ms": ms, "launches": n} for k, (ms, n) in
                        sorted(by_kind.items(), key=lambda kv: -kv[1][0])})
    return out


def stage_times(scene, settings, iters: int = 3, seed: int = 0,
                mode: str = "masked") -> dict:
    """Per frame, each stage's synchronized wall ms and number of calls, in
    the eager frame (a graph replay calls no stage)."""
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

    _iterations(scene, settings, 1, seed, 1, mode, "eager")
    with contextlib.ExitStack() as stack:
        for mod, attr, name in STAGES:
            stack.enter_context(mock.patch.object(
                mod, attr, timed(getattr(mod, attr), name)))
        t0 = time.perf_counter()
        _iterations(scene, settings, iters, seed, 2, mode, "eager")
        wall = 1000.0 * (time.perf_counter() - t0) / iters
    stages = {name: {"ms": acc[name][0] / iters, "calls": acc[name][1] / iters}
              for _, _, name in STAGES if name in acc}
    return {"wall_ms": wall, "stages": stages}


def graph_stages() -> dict | None:
    """{top stage: median device ms an iteration} of the compiled frame's
    untraced timed replays that the span recorder read (utils/spans.py),
    or None where it read none (the eager frame, the CPU, the recorder
    off)."""
    spans.read_replay()
    dev = spans.snapshot()["device_ms"]
    out = {s: spans.median(dev.get(s)) for s in spans.TOP}
    return {s: ms for s, ms in out.items() if ms is not None} or None


def frame_host() -> dict | None:
    """Median host ms of the compiled frame's untraced calls that captured
    nothing: the whole call (pt_frame), each span inside it summed over the
    call (pt_frame.key, .copy, .launch) and the call's self time (reading
    the last timed replay's events, and Python); None where there were
    none."""
    recs = spans.snapshot()["spans"]
    captured = {r[5] for r in recs if r[1] == "pt_frame.capture"}
    calls = {r[0]: r for r in recs if r[1] == spans.FRAME and not r[6]
             and r[5] not in captured}
    if not calls:
        return None
    own = spans.self_seconds(recs)
    inside = {}
    for sid, name, start, end, parent, *_ in recs:
        if parent in calls:
            per_call = inside.setdefault(name, dict.fromkeys(calls, 0.0))
            per_call[parent] += end - start
    ms = lambda xs: 1000.0 * statistics.median(xs)
    return {spans.FRAME: ms([r[3] - r[2] for r in calls.values()]),
            **{name: ms(list(v.values())) for name, v in inside.items()},
            "self": ms([own[sid] for sid in calls])}


def graph_cache() -> dict:
    """The compiled frames' cache: the frames captured and those dropped
    past its budget (the span recorder's counters captures and
    evictions), and the frames cached with their graph pools' bytes
    (Frame.pool_bytes)."""
    counters = spans.snapshot()["counters"]
    frames = wavefront.cached_frames()
    return {"captures": counters.get("captures", 0),
            "evictions": counters.get("evictions", 0),
            "cached": len(frames),
            "pool_bytes": sum(f.pool_bytes for f in frames)}


def report(scene_file: str, device, iters: int = 3, seed: int = 0,
           overrides: dict | None = None, bvh: str | None = None,
           mode: str = "masked", tile: int = 16000,
           fallback: str | None = None, frame: str = "compiled") -> dict:
    """All three measurements of one scene on `device`, through the mesh
    intersector `bvh` (None: the loader's pick), with the binned
    intersector's exact finish `fallback` ("packet" or "wide"; None:
    binned.FALLBACK_IMPL), in engine mode `mode` (`tile`: the tiled mode's
    compact_tile); frame_ms and device_profile of the frame `frame`, and
    graph_stages, frame_host and graph_cache of their calls (the span
    recorder starts afresh)."""
    from ..scene.loader import load_scene
    fallback = fallback or binned.FALLBACK_IMPL
    scene, settings = load_scene(scene_file, device, overrides=overrides,
                                 bvh_impl=bvh,
                                 wide_tables=fallback == "wide")
    settings = mode_settings(settings, mode, tile)
    args = (scene, settings, iters, seed, mode)
    spans.reset()
    with torch.inference_mode(), mock.patch.object(binned, "FALLBACK_IMPL",
                                                   fallback):
        return {
            "scene": scene_file, "device": str(scene.device),
            "bvh": settings.bvh_impl, "fallback": fallback, "mode": mode,
            "frame": frame, "res": [settings.width, settings.height],
            "depth": settings.trace_depth, "iters": iters,
            "frame_ms": frame_ms(*args, frame),
            "device_profile": device_profile(*args, frame),
            "graph_stages": graph_stages(),
            "frame_host": frame_host(),
            "graphs": graph_cache(),
            "stage_times": stage_times(*args),
        }


@dataclasses.dataclass
class StageStats:
    """Per-stage mean milliseconds (the reference's printPerformanceStats,
    pathtracer_tpu/utils/profiling.py:31)."""

    raygen_ms: float
    intersect_ms: float
    shade_ms: float
    gather_ms: float
    frame_ms: float          # one eager frame (trace_depth bounces)
    trace_depth: int

    def table(self) -> str:
        per_bounce = [
            ("Ray generation", self.raygen_ms, 1),
            ("Intersection", self.intersect_ms, self.trace_depth),
            ("Shading", self.shade_ms, self.trace_depth),
            ("Gather", self.gather_ms, self.trace_depth),
        ]
        total_est = sum(ms * mult for _, ms, mult in per_bounce)
        lines = ["=== Performance Statistics (per-stage, isolated calls) ===",
                 f"{'Stage':<16}{'ms/call':>10}{'calls':>7}{'ms/frame':>10}"
                 f"{'%':>7}"]
        for name, ms, mult in per_bounce:
            lines.append(f"{name:<16}{ms:>10.3f}{mult:>7}{ms * mult:>10.3f}"
                         f"{100 * ms * mult / total_est:>6.1f}%")
        pad = f"{'':>10}{'':>7}"
        lines.append(f"{'SUM (isolated)':<16}{pad}{total_est:>10.3f}")
        lines.append(f"{'Eager frame':<16}{pad}{self.frame_ms:>10.3f}"
                     f"   (isolated sum / frame: "
                     f"{total_est / max(self.frame_ms, 1e-9):.2f}x)")
        return "\n".join(lines)


def _time(fn, device: torch.device, iters: int = 20) -> float:
    """Mean ms of fn(k) over k = 1..iters, after fn(0), synchronized on
    `device` before and after. fn consumes k, so that no call repeats
    another's inputs."""
    fn(0)
    _sync(device)
    t0 = time.perf_counter()
    for k in range(1, iters + 1):
        fn(k)
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


@torch.inference_mode()
def measure_stages(scene, settings, seed: int = 0,
                   iters: int = 20) -> StageStats:
    """Raygen, intersect, shade and gather each timed on its own over
    `iters` calls on the raygen pool of one iteration (the varied eps and
    iteration keep the calls' inputs distinct), and one eager frame
    (`render_chunk_eager` of one iteration) timed over `iters` frames."""
    dev = scene.device
    pmap = settings.pixel_map()

    def irng(it):
        return rng.IterationRng(seed, it, pixel_map=pmap,
                                fast=settings.fast_rng)

    def f_raygen(it):
        return wavefront.generate_paths(scene, settings, irng(it))

    state = f_raygen(1)

    def f_isect(eps):
        o = state.origin
        return intersect.intersect_scene(
            scene, settings.geom_types, Vec3(o.x + eps, o.y, o.z),
            state.direction, bvh_impl=settings.bvh_impl)

    t, normal, mat = f_isect(0.0)

    def f_shade(it):
        return bsdf.shade_lanes(state.origin, state.direction, state.color,
                                state.remaining_bounces, t, normal, mat,
                                scene.materials, irng(it), 0, state.pixel,
                                any_glossy=settings.any_glossy,
                                any_refractive=settings.any_refractive,
                                depth_quirk=settings.depth_quirk)

    _, _, color, rb = f_shade(1)
    img = wavefront.zero_accum(settings, dev)

    def f_gather(eps):
        done = rb == 0
        return Vec3(img.x + torch.where(done, color.x + eps, 0.0),
                    img.y + torch.where(done, color.y, 0.0),
                    img.z + torch.where(done, color.z, 0.0))

    frame_ms = _time(
        lambda k: wavefront.render_chunk_eager(
            scene, settings, wavefront.zero_accum(settings, dev), k + 1, 1,
            seed, True), dev, iters)
    return StageStats(
        raygen_ms=_time(lambda k: f_raygen(k + 2), dev, iters),
        intersect_ms=_time(lambda k: f_isect(k * 1e-6), dev, iters),
        shade_ms=_time(lambda k: f_shade(k + 3), dev, iters),
        gather_ms=_time(lambda k: f_gather(k * 1e-6), dev, iters),
        frame_ms=frame_ms,
        trace_depth=settings.trace_depth,
    )


def ray_survival_report(scene, settings, iteration: int = 10,
                        seed: int = 0) -> str:
    """The live rays before each bounce and after the last, as the
    reference's PRINT_RAY_COUNT prints them (pathtrace.cu:746-750,877-881;
    pathtracer_tpu/utils/profiling.py:137): the same text as the JAX
    package's."""
    counts = [int(c) for c in wavefront.ray_survival(scene, settings,
                                                     iteration, seed=seed)]
    lines = [f"[Iter {iteration}] Initial rays: {counts[0]}"]
    for d, c in enumerate(counts[1:], start=1):
        lines.append(f"[Iter {iteration}] After bounce {d}: {c} rays "
                     "remaining")
    return "\n".join(lines)


def format_report(rep: dict) -> str:
    lines = [f"{rep['scene']} {rep['res'][0]}x{rep['res'][1]} "
             f"d{rep['depth']} bvh {rep['bvh']} (fallback "
             f"{rep['fallback']}) {rep['mode']} {rep['frame']} frame on "
             f"{rep['device']}, "
             f"{rep['iters']} iterations:"
             f" untraced {rep['frame_ms']:.2f} ms/frame"]
    prof = rep["device_profile"]
    lines.append(f"  traced wall {prof['wall_ms']:.2f} ms/frame")
    if prof["device_ms"] is not None:
        lines.append(f"  device kernels {prof['device_ms']:.2f} ms/frame, "
                     f"{prof['launches']:.0f} launches/frame, busy "
                     f"{100.0 * prof['busy_share']:.1f}%, "
                     f"{prof['host_launches']:.0f} host launch calls/frame")
        for kind, v in prof["by_kind"].items():
            lines.append(f"    {kind:<20}{v['ms']:>10.3f} ms"
                         f"{v['launches']:>10.0f} launches")
    graph = rep.get("graph_stages")
    if graph is None:
        lines.append("  in-graph stages: none read (the eager frame, the "
                     "CPU or the recorder off)")
    else:
        lines.append(f"  in-graph stages (compiled frame, untraced, device "
                     f"ms/frame): sum {sum(graph.values()):.3f}")
        for name, ms in graph.items():
            lines.append(f"    {name:<20}{ms:>10.3f} ms")
    host = rep.get("frame_host")
    if host is not None:
        lines.append("  host ms of a compiled frame's call (untraced "
                     "medians):")
        for name, ms in host.items():
            lines.append(f"    {name:<20}{ms:>10.3f} ms")
    graphs = rep.get("graphs")
    if graphs is not None:
        lines.append(f"  graphs: {graphs['captures']} captured, "
                     f"{graphs['evictions']} dropped past the budget; "
                     f"{graphs['cached']} cached, "
                     f"{graphs['pool_bytes'] / 2**20:.1f} MiB of pool")
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
    ap.add_argument("--fallback", choices=("packet", "wide"), default=None,
                    help="the binned intersector's exact finish (default: "
                         "binned.FALLBACK_IMPL)")
    ap.add_argument("--mode", choices=MODES, default="masked",
                    help="engine mode (default masked)")
    ap.add_argument("--frame", choices=FRAMES, default="compiled",
                    help="frame of the untraced and traced timings "
                         "(default compiled; the stages always eager)")
    ap.add_argument("--tile", type=int, default=16000,
                    help="compact_tile of --mode tiled (must divide the "
                         "pool; default 16000, for 800x800)")
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
                     args.bvh, args.mode, args.tile, args.fallback,
                     args.frame)
        print(format_report(rep), flush=True)
        reps.append(rep)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(reps, f, indent=1)


if __name__ == "__main__":
    main()
