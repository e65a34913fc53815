"""Interactive viewing: one iteration a displayed frame; a camera drag
restarts the accumulation (the reference app's frame loop, main.cpp:454-472,
and the program's tools/viewer.py).

Closed loop on one card. Each displayed frame: apply the pending move, if
any (an orbit step written into the camera tensors in place, and the
accumulation restarted at iteration 1); `render_chunk` of 1 iteration;
synchronize; `lanes_to_image(accum / iterations)` and `to_uint8` on the
host. A frame's latency runs from before its input is applied to its
uint8 image in host memory; display_p95_ms is the 95th percentile over
every frame of the window. The moves come from the seed: drags of moving
frames separated by still frames, with every seed given the same drag and
still lengths (the workload's lists) in its own order, each drag along one
of four directions (orbit left, right, up, down by `orbit_step` radians a
frame). display_host_ms is the mean host span from the render's
synchronize to the uint8 image.

With --trace 1 the frames `trace.skip_frames` .. + `trace.frames` run
under torch.profiler.

The check: `check.frames` frames drawn from the seed, and the frame of the
longest accumulation, each at `check.pixels` pixels drawn from the seed:
the mean absolute difference of the uint8 values from the plain reference's
(u8_mean_abs, in levels).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import trace as tr
from ..outcome import Outcome
from ..reference.scene import startup_orbit
from ..spec import load_program_scene, load_reference_scene
from . import free, kind, peak_bytes, sample, sync

MIN_THETA, MAX_THETA = 1e-3, 3.14


def schedule(seed: int, wl: dict, n_frames: int) -> list:
    """Per frame, None (still) or the move it applies: a still run first,
    then drags and still runs in turn."""
    gen = np.random.default_rng([int(seed), 2])
    drags, stills = list(wl["drag_frames"]), list(wl["still_frames"])
    dirs = ["phi+", "phi-", "theta+", "theta-"]
    out = []
    while len(out) < n_frames:
        d_order = gen.permutation(drags)
        s_order = gen.permutation(stills)
        way = gen.choice(dirs, size=len(d_order))
        for s, d, w in zip(s_order, d_order, way):
            out += [None] * int(s) + [str(w)] * int(d)
    return out[:n_frames]


def plan(seed: int, wl: dict, block: dict, n_frames: int) -> tuple:
    """The seed's first `n_frames` frames: (each frame's move or None, each
    frame's (camera epoch, iterations accumulated), each epoch's (zoom,
    theta, phi, look_at)), the first epoch the app's start-up orbit."""
    moves = schedule(seed, wl, n_frames)
    epochs, frames, m = [startup_orbit(block)], [], 0
    for mv in moves:
        if mv is not None:
            epochs.append(move(epochs[-1], mv, float(wl["orbit_step"])))
            m = 0
        m += 1
        frames.append((len(epochs) - 1, m))
    return moves, frames, epochs


def move(state: tuple, way: str, step: float) -> tuple:
    """(zoom, theta, phi, look_at) after one orbit step."""
    zoom, theta, phi, look = state
    if way == "phi+":
        phi += step
    elif way == "phi-":
        phi -= step
    elif way == "theta+":
        theta = min(MAX_THETA, theta + step)
    else:
        theta = max(MIN_THETA, theta - step)
    return zoom, theta, phi, look


def run(run) -> Outcome:
    from pathtracer_tpu_torch.engine.wavefront import (lanes_to_image,
                                                       render_chunk,
                                                       zero_accum)
    from pathtracer_tpu_torch.io.image import to_uint8
    from pathtracer_tpu_torch.scene.loader import derive_camera, orbit_camera
    wl = run.cell.workload
    dev = torch.device(run.device)
    scene, settings = load_program_scene(run.cell, dev)
    block = scene_block(run.cell)
    cam_dict = derive_camera(block["EYE"], block["LOOKAT"], block["UP"],
                             float(block["FOVY"]), settings.width,
                             settings.height,
                             float(block.get("FOCAL_DISTANCE", 10.0)),
                             float(block.get("LENS_RADIUS", 0.0)))
    moves, plans, epochs = plan(run.seed, wl, block, int(wl["max_frames"]))
    pixels = sample(run.seed, 1, settings.pixel_count,
                    int(wl["check"]["pixels"]))

    def place(state):
        new = orbit_camera(cam_dict, *state)
        for k in ("position", "view", "up", "right"):
            getattr(scene.camera, k).copy_(torch.as_tensor(
                new[k], dtype=torch.float32))

    with torch.inference_mode():
        place(epochs[0])
        accum = zero_accum(settings, dev)
        for it in (1, 2):               # warm-up: capture, a replay
            render_chunk(scene, settings, accum, it, 1, run.seed)
        sync(dev)
        to_uint8(lanes_to_image(accum * 0.5, settings))
        for c in accum:
            c.zero_()
        sync(dev)

        skip, n_traced = (int(wl["trace"]["skip_frames"]),
                          int(wl["trace"]["frames"]))
        frames, latency, host_s = [], [], []
        prof = summary = None
        t_open = time.perf_counter()
        k = 0
        while k < len(moves):
            if run.trace and k == skip:
                prof = tr.profiler(dev)
                prof.__enter__()
                win = tr.span(True, tr.WINDOW)
                win.__enter__()
            epoch, m = plans[k]
            t_in = time.perf_counter()
            if moves[k] is not None:
                with tr.span(run.trace, "bench.move"):
                    place(epochs[epoch])
                    for c in accum:
                        c.zero_()
            with tr.span(run.trace, "bench.render"):
                render_chunk(scene, settings, accum, m, 1, run.seed)
                sync(dev)
            t_r = time.perf_counter()
            with tr.span(run.trace, "bench.display"):
                img8 = to_uint8(lanes_to_image(
                    accum * (1.0 / float(m)), settings))
            t_done = time.perf_counter()
            latency.append(t_done - t_in)
            host_s.append(t_done - t_r)
            frames.append((epoch, m, img8.reshape(-1, 3)[pixels].copy()))
            k += 1
            if run.trace and k == skip + n_traced:
                win.__exit__(None, None, None)
                prof.__exit__(None, None, None)
            if (t_done - t_open >= run.seconds
                    and not (run.trace and k < skip + n_traced)):
                break
        if k >= len(moves):
            raise RuntimeError(f"the schedule's {len(moves)} frames ran out "
                               "before the window closed")
        peak = peak_bytes(dev)
        if run.trace:
            summary = tr.read(prof, n_traced)
    del scene, accum
    free(dev)
    return Outcome(
        end_to_end={"display_p95_ms": 1000.0 * float(np.percentile(
            latency, 95)), "setup_s": t_open - run.t0},
        attempted=len(frames), failed=0, memory_peak_bytes=peak,
        kind=kind(dev),
        answers={"frames": frames, "epochs": epochs, "pixels": pixels},
        spans={"display_host_s": host_s, "latency_s": latency},
        trace=summary, busy_s=summary and summary["busy_s"],
        window_s=summary and summary["window_s"])


def scene_block(cell) -> dict:
    """The configuration's camera block, overrides applied."""
    import json
    with open(cell.path(cell.config["scene"])) as f:
        block = dict(json.load(f)["Camera"])
    block.update(cell.config.get("overrides") or {})
    return block


def reference_frames(tb, scene, answers: dict, chosen, seed: int) -> list:
    """The plain reference's uint8 values of the frames `chosen` (indices
    into answers["frames"]) at answers["pixels"]: each camera epoch's
    iterations traced once, summed in iteration order, and each frame's
    prefix averaged."""
    from ..reference import tracer
    frames, pixels = answers["frames"], answers["pixels"]
    s = len(pixels)
    need = {}
    for j in chosen:
        e, m = frames[j][0], frames[j][1]
        need[e] = max(need.get(e, 0), m)
    epochs = sorted(need)
    cams = [scene.camera(*answers["epochs"][e]) for e in epochs]
    cams = {k: np.stack([c[k] for c in cams]) for k in cams[0]}
    cam_idx = np.concatenate([np.full(need[e] * s, r)
                              for r, e in enumerate(epochs)])
    its = np.concatenate([np.repeat(np.arange(1, need[e] + 1), s)
                          for e in epochs])
    pix = np.concatenate([np.tile(pixels, need[e]) for e in epochs])
    rad = tracer.radiance(tb, cams, cam_idx, pix, its, seed)
    out, at = {}, 0
    for e in epochs:
        block = rad[at:at + need[e] * s].reshape(need[e], s, 3)
        at += need[e] * s
        want = {frames[j][1]: j for j in chosen if frames[j][0] == e}
        acc = torch.zeros_like(block[0])
        for m in range(1, need[e] + 1):
            acc = acc + block[m - 1]
            for mm, j in want.items():
                if mm == m:
                    out[j] = to_u8((acc * (1.0 / float(m))).float()
                                   .cpu().numpy())
    return [out[j] for j in chosen]


def to_u8(x: np.ndarray) -> np.ndarray:
    """Clamp to [0, 1], scale by 255 in float32 and truncate."""
    return (np.clip(x.astype(np.float32), 0.0, 1.0)
            * np.float32(255.0)).astype(np.uint8)


def chosen_frames(seed: int, answers: dict, k: int) -> list:
    """`k` frames drawn from the seed, and the longest accumulation."""
    frames = answers["frames"]
    pick = set(sample(seed, 3, len(frames), k).tolist())
    pick.add(max(range(len(frames)), key=lambda j: frames[j][1]))
    return sorted(pick)


def check(run, out: Outcome) -> dict:
    from ..reference import tracer
    dev = torch.device(run.device)
    scene = load_reference_scene(run.cell)
    tb = tracer.Tables(scene, dev)
    chosen = chosen_frames(run.seed, out.answers,
                           int(run.cell.workload["check"]["frames"]))
    ref = reference_frames(tb, scene, out.answers, chosen, run.seed)
    prog = [out.answers["frames"][j][2] for j in chosen]
    diff = np.mean([np.abs(p.astype(np.int32) - r.astype(np.int32)).mean()
                    for p, r in zip(prog, ref)])
    limit = run.cell.workload["check"]["limit"]["u8_mean_abs"]
    return {"u8_mean_abs": (float(diff), limit)}
