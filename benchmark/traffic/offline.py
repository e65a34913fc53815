"""Offline rendering: N samples a pixel into one image, card time paid per
sample.

Closed loop on one card: `render_chunk` in chunks of `chunk` iterations
from iteration 1, each chunk ending in a synchronize, until the window's
seconds have passed; then the averaged image is fetched to the host with
`lanes_to_image`, inside the window. frame_ms is the window's wall time
over the iterations it completed. Set-up loads the scene and runs one
chunk of 2 iterations on a scratch accumulator (the eager warm-up
iteration and the capture of the cell's graph, then a replay).

With --trace 1 one steady chunk (after `trace.skip_chunks`) runs under
torch.profiler, and after the window the live lanes of each bounce of two
of its iterations are counted (the program's `ray_survival`) for the mesh
roofline.

The check: `check.pixels` pixels drawn from the seed, their averaged
values against the plain reference's average over the same iterations
(rel_l1: sum |program - reference| / sum |reference|).
"""
from __future__ import annotations

import time

import torch

from .. import trace as tr
from ..outcome import Outcome
from ..spec import load_program_scene, load_reference_scene
from . import (free, kind, peak_bytes, reference_average, rel_l1, sample,
               sync)


def run(run) -> Outcome:
    from pathtracer_tpu_torch.engine.wavefront import (lanes_to_image,
                                                       ray_survival,
                                                       render_chunk,
                                                       zero_accum)
    wl = run.cell.workload
    dev = torch.device(run.device)
    scene, settings = load_program_scene(run.cell, dev)
    chunk = int(wl["chunk"])
    with torch.inference_mode():
        warm = zero_accum(settings, dev)
        render_chunk(scene, settings, warm, 1, 2, run.seed)
        lanes_to_image(warm * 0.5, settings)
        del warm
        accum = zero_accum(settings, dev)
        sync(dev)

        skip = int(wl["trace"]["skip_chunks"])
        prof, summary, traced_first = None, None, None
        t_open = time.perf_counter()
        done = chunks = 0
        while True:
            tracing = run.trace and chunks == skip
            if tracing:
                prof = tr.profiler(dev)
                prof.__enter__()
                traced_first = done + 1
            with tr.span(tracing, tr.WINDOW):
                render_chunk(scene, settings, accum, done + 1, chunk,
                             run.seed)
                sync(dev)
            if tracing:
                prof.__exit__(None, None, None)
            done += chunk
            chunks += 1
            if (time.perf_counter() - t_open >= run.seconds
                    and not (run.trace and chunks <= skip)):
                break
        img = lanes_to_image(accum * (1.0 / float(done)), settings)
        t_close = time.perf_counter()
        peak = peak_bytes(dev)
        counters = {}
        if run.trace:
            summary = tr.read(prof, chunk)
            counters["live_lanes"] = [
                ray_survival(scene, settings, it, run.seed).cpu().tolist()
                for it in (traced_first, traced_first + 1)]
    pixels = sample(run.seed, 1, settings.pixel_count,
                    int(wl["check"]["pixels"]))
    answers = {"iterations": done, "pixels": pixels,
               "values": img.reshape(-1, 3)[pixels].copy()}
    del scene, accum, img
    free(dev)
    return Outcome(
        end_to_end={"frame_ms": 1000.0 * (t_close - t_open) / done,
                    "setup_s": t_open - run.t0},
        attempted=done, failed=0, memory_peak_bytes=peak, kind=kind(dev),
        answers=answers, counters=counters, trace=summary,
        busy_s=summary and summary["busy_s"],
        window_s=summary and summary["window_s"])


def check(run, out: Outcome) -> dict:
    from ..reference import tracer
    dev = torch.device(run.device)
    scene = load_reference_scene(run.cell)
    tb = tracer.Tables(scene, dev)
    cams = {k: v[None] for k, v in scene.startup_camera().items()}
    ans = out.answers
    ref = reference_average(tb, cams, 0, ans["pixels"], ans["iterations"],
                            run.seed)
    limit = run.cell.workload["check"]["limit"]["rel_l1"]
    return {"rel_l1": (rel_l1(ans["values"], ref.float().cpu().numpy()),
                       limit)}
