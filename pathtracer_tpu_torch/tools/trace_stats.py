"""In-frame per-stage split of the port's eager frame by a torch.profiler
trace (the counterpart of the repo's tools/xplane_stats.py):

    python -m pathtracer_tpu_torch.tools.trace_stats [scene.json] \
        [--res N] [--depth N] [--frames N] [--bvh IMPL] [--top K] \
        [--range-cost ROUNDS] [--device cuda]

The engine runs each stage under a torch.profiler range named as the JAX
package's scopes: pt_raygen, pt_intersect, pt_shade, pt_gather
(engine/wavefront.py), and inside pt_intersect the binned intersector's
pt_mi_sort, pt_mi_cull, pt_mi_stream, pt_mi_fb (ops/binned.py). After one
warm-up frame, `--frames` frames of the eager loop
(engine/wavefront.render_chunk_eager) run under torch.profiler: the
compiled frame that render_chunk runs on the card is one graph launch an
iteration, whose kernels have no host call to charge (its split by stage
is the span recorder's, from events inside a timed graph: utils/spans.py,
printed by `python -m pathtracer_tpu_torch.utils.profiling`). The ranges
and STAGES are the recorder's (utils/spans.py stage). Each device kernel
(and memcpy / memset) is matched to the host call that launched it and
charged to the first stage of STAGES whose range was open then, the JAX
tool's rule (xplane_stats.py:42-43): the pt_mi_* sub-stages come first,
so a sort inside pt_intersect is charged to pt_mi_sort, and nothing is
charged twice. Per stage and frame it prints
device ms, its share of the traced device total, host ms (the wall time
inside the stage's ranges, less the stages nested in them) and device
launches, and with `--top K` the stage's K largest kernels; kernels
launched outside every range are "(unattributed)", and device time with
no host call found "(unlinked)". Then `utils/profiling.measure_stages`'
isolated table, as the JAX tool prints its isolated estimate beside the
fused frame's split.

XPlane files and HLO metadata, which the JAX tool parses, are TPU formats;
this tool reads torch.profiler's own events. On the CPU (`--device cpu`)
there are no device kernels: only the host columns are printed.

`--range-cost ROUNDS [--chunk N] [--display]` instead times untraced
chunks of render_chunk (the compiled frame on the card) with the span
recorder on and off (`range_cost`), interleaved in one process: what its
host spans and timed replays cost a frame that nobody traces (untraced,
a span opens no profiler range); with `--display`, a unit also makes the
uint8 image (the interactive frame, with `--chunk 1`).
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import time
from unittest import mock

from ..utils import spans
from ..utils.device import resolve_device
from ..utils.profiling import _sync, is_range_span

# the pt_mi_* sub-stages first: a kernel is charged to the first found
STAGES = spans.STAGES
OTHER, UNLINKED = "(unattributed)", "(unlinked)"


def _is_device(evt) -> bool:
    return evt.device_type.name in ("CUDA", "PrivateUse1", "XPU")


def _stage_at(ranges, t: float):
    """The first stage of STAGES among the host ranges [(start, end, name)]
    open at host time `t`, or None."""
    names = {name for start, end, name in ranges if start <= t <= end}
    return next((s for s in STAGES if s in names), None)


def stage_split(events) -> dict:
    """Attribution of torch.profiler events (prof.events(), or objects with
    the same fields: name, id, device_type, cpu_parent, time_range with
    start and end in us; device events also key and
    linked_correlation_id).

    A device event (kernel, memcpy, memset) is matched by its correlation
    id to the host call that launched it (cudaLaunchKernel and the like),
    or else to the host op torch linked it to, and charged to the first
    stage of STAGES whose range was open at that call: the port's own
    kernels are launched through ctypes, inside a range but outside any
    torch op. The ranges' own device-side spans (GPU user annotations) are
    no device work and are skipped.

    Returns {"device_us": {stage, OTHER, UNLINKED: us}, "launches": {same:
    count}, "host_us": {stage: exclusive us}, "kernels": {stage: {kernel
    name: [us, count]}}, "device_total_us": the device events' sum,
    "ranges": {stage: ranges seen}}."""
    keys = STAGES + (OTHER, UNLINKED)
    dev = dict.fromkeys(keys, 0.0)
    launches = dict.fromkeys(keys, 0)
    kernels = {k: {} for k in keys}
    host = dict.fromkeys(STAGES, 0.0)
    ranges = dict.fromkeys(STAGES, 0)
    spans, launch_at, op_at, device = [], {}, {}, []
    for evt in events:
        start, end = evt.time_range.start, evt.time_range.end
        if _is_device(evt):
            if not is_range_span(evt):
                device.append(evt)
        elif evt.name in host:
            # exclusive host time: this range's wall time, less that of the
            # stage ranges directly inside it
            host[evt.name] += end - start
            ranges[evt.name] += 1
            spans.append((start, end, evt.name))
            up = evt.cpu_parent
            while up is not None and up.name not in host:
                up = up.cpu_parent
            if up is not None:
                host[up.name] -= end - start
        elif evt.name.startswith("cu"):     # cudaLaunchKernel, cuLaunchKernel
            launch_at[evt.id] = start
        else:
            op_at[evt.id] = start
    total = 0.0
    for evt in device:
        us = evt.time_range.end - evt.time_range.start
        total += us
        t = launch_at.get(evt.id)
        if t is None:
            t = op_at.get(getattr(evt, "linked_correlation_id", 0))
        stage = UNLINKED if t is None else (_stage_at(spans, t) or OTHER)
        dev[stage] += us
        launches[stage] += 1
        rec = kernels[stage].setdefault(evt.name, [0.0, 0])
        rec[0] += us
        rec[1] += 1
    return {"device_us": dev, "launches": launches, "host_us": host,
            "kernels": kernels, "device_total_us": total, "ranges": ranges}


def trace_frames(scene, settings, frames: int, seed: int = 0):
    """One warm-up frame, then `frames` frames of render_chunk_eager under
    torch.profiler: (prof.events(), traced wall ms a frame)."""
    from torch.profiler import ProfilerActivity, profile

    from ..engine.wavefront import render_chunk_eager, zero_accum
    dev = scene.device
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    accum = zero_accum(settings, dev)
    render_chunk_eager(scene, settings, accum, 1, 1, seed, True)
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render_chunk_eager(scene, settings, accum, 2, frames, seed, True)
        _sync(dev)
        wall = 1e3 * (time.perf_counter() - t0) / frames
    return prof.events(), wall


def split_frames(scene, settings, frames: int, seed: int = 0) -> dict:
    """stage_split of `frames` traced frames, per frame: {"device_ms",
    "host_ms", "launches", "kernels" ({stage: {name: [ms, launches]}}),
    "device_total_ms", "wall_ms", "frames", "on_device"}."""
    events, wall = trace_frames(scene, settings, frames, seed)
    s = stage_split(events)
    per = lambda us: us / 1000.0 / frames
    return {
        "device_ms": {k: per(v) for k, v in s["device_us"].items()},
        "host_ms": {k: per(v) for k, v in s["host_us"].items()},
        "launches": {k: v / frames for k, v in s["launches"].items()},
        "kernels": {st: {name: [per(us), n / frames]
                         for name, (us, n) in ks.items()}
                    for st, ks in s["kernels"].items()},
        "ranges": {k: v / frames for k, v in s["ranges"].items()},
        "device_total_ms": per(s["device_total_us"]),
        "wall_ms": wall, "frames": frames,
        "on_device": scene.device.type == "cuda",
    }


def table(res: dict, top: int = 0) -> str:
    """The in-frame table of split_frames' result."""
    lines = [f"=== In-frame stage attribution ({res['frames']} traced "
             f"frames, traced wall {res['wall_ms']:.2f} ms/frame) ==="]
    if res["on_device"]:
        total = res["device_total_ms"]
        lines.append(f"{'Stage':<16}{'device ms':>11}{'%':>7}{'host ms':>10}"
                     f"{'launches':>10}")
        for s in STAGES + (OTHER, UNLINKED):
            ms = res["device_ms"][s]
            host = (f"{res['host_ms'][s]:>10.3f}" if s in res["host_ms"]
                    else f"{'':>10}")
            share = 100 * ms / max(total, 1e-12)
            lines.append(f"{s:<16}{ms:>11.3f}{share:>6.1f}%{host}"
                         f"{res['launches'][s]:>10.1f}")
            if top:
                ks = sorted(res["kernels"].get(s, {}).items(),
                            key=lambda kv: -kv[1][0])[:top]
                for name, (kms, n) in ks:
                    lines.append(f"      {kms:9.4f} ms {n:7.1f}x  "
                                 f"{name[:90]}")
        lines.append(f"{'TOTAL device':<16}{total:>11.3f}")
    else:
        lines.append(f"{'Stage':<16}{'host ms':>10}{'ranges':>8}")
        for s in STAGES:
            lines.append(f"{s:<16}{res['host_ms'][s]:>10.3f}"
                         f"{res['ranges'][s]:>8.1f}")
        lines.append("(no device: host columns only)")
    return "\n".join(lines)


def ranges_off():
    """The block runs with the span recorder off (spans.ENABLED): no
    profiler range, host span or timed graph (the cost of them)."""
    return mock.patch.object(spans, "ENABLED", False)


def range_cost(scene, settings, chunk: int = 10, rounds: int = 4,
               seed: int = 0, out=print, display: bool = False) -> dict:
    """ms a unit with the recorder on (on) and off (off), untraced: a unit
    is render_chunk of `chunk` iterations (the compiled frame on the card,
    whose frame has a timed graph or none) up to a
    synchronize, and with `display` the averaged image to uint8 after it
    (lanes_to_image and to_uint8, the interactive frame). `rounds` rounds
    in the order on, off, off, on, after one warm-up unit of each. Returns
    {"on": [ms], "off": [...]}; prints each arm's median and 95th
    percentile."""
    from ..engine.wavefront import lanes_to_image, render_chunk, zero_accum
    from ..io.image import to_uint8
    dev = scene.device
    accum = zero_accum(settings, dev)

    def unit_ms(arm, it):
        _sync(dev)
        t0 = time.perf_counter()
        with (ranges_off() if arm == "off" else contextlib.nullcontext()):
            render_chunk(scene, settings, accum, it, chunk, seed)
            _sync(dev)
            if display:
                to_uint8(lanes_to_image(accum * (1.0 / (it + chunk - 1)),
                                        settings))
        return 1e3 * (time.perf_counter() - t0)

    res = {"on": [], "off": []}
    it = 1
    for arm in ("on", "off"):
        unit_ms(arm, it)
        it += chunk
    for _ in range(rounds):
        for arm in ("on", "off", "off", "on"):
            res[arm].append(unit_ms(arm, it))
            it += chunk
    for arm, ms in res.items():
        p95 = statistics.quantiles(ms, n=20)[-1] if len(ms) > 1 else ms[0]
        out(f"recorder {arm:3s}: median {statistics.median(ms):9.3f} "
            f"p95 {p95:9.3f} ms a unit of {chunk} iteration(s)"
            f"{' + display' if display else ''}, {len(ms)} units")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m pathtracer_tpu_torch.tools.trace_stats")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene JSON (default: the Cornell box)")
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--bvh", default=None,
                    help="mesh intersector (default: the loader's pick)")
    ap.add_argument("--top", type=int, default=0,
                    help="list each stage's K largest kernels")
    ap.add_argument("--iters", type=int, default=20,
                    help="calls a stage of the isolated table")
    ap.add_argument("--range-cost", type=int, default=0, metavar="ROUNDS",
                    help="instead, time ROUNDS rounds of chunks with the "
                         "span recorder on and off (range_cost)")
    ap.add_argument("--chunk", type=int, default=10,
                    help="iterations a unit of --range-cost")
    ap.add_argument("--display", action="store_true",
                    help="a --range-cost unit also makes the uint8 image")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    from ..scene.fixtures import scene_path
    from ..scene.loader import load_scene
    from ..utils.profiling import measure_stages
    device = resolve_device(args.device)
    overrides = {}
    if args.res:
        overrides["RES"] = [args.res, args.res]
    if args.depth:
        overrides["DEPTH"] = args.depth
    path = args.scene or scene_path("cornell")
    scene, settings = load_scene(path, device, overrides=overrides or None,
                                 bvh_impl=args.bvh)
    print(f"scene: {path} {settings.width}x{settings.height} "
          f"d{settings.trace_depth} bvh={settings.bvh_impl}", flush=True)
    if args.range_cost:
        return range_cost(scene, settings, args.chunk, args.range_cost,
                          out=lambda s: print(s, flush=True),
                          display=args.display)
    res = split_frames(scene, settings, args.frames)
    print(table(res, args.top), flush=True)
    print()
    print(measure_stages(scene, settings, iters=args.iters).table(),
          flush=True)
    return res


if __name__ == "__main__":
    main()
