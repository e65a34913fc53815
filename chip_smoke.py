#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. setup: the card's name and power limit, torch / CUDA / nvcc versions;
  2. build: the kernel library (pathtracer_tpu_torch/csrc) with nvcc;
  3. kernels vs plain versions: one teapot 800x800 iteration is taken to
     bounce 1, the mesh intersection of that bounce-ray pool records the
     inputs each kernel gets on the main path, and each kernel is held
     against its plain PyTorch version on those inputs, with median times;
  4. teapot 800x800 d4 through pathtracer_tpu_torch.render, with the launch
     counters reset just before and read just after: every kernel must have
     run, and the image must be finite and not all zero;
  5. teapot 64x64 d4, 2 iterations, with the kernels and with the plain
     versions on the card: the images must agree;
  6. Cornell 800x800 d8 (no kernel on its path): ms/frame.
The second-to-last lines are one JSON object with every kernel's numbers and
the card's name and power limit; the last line is the result object.
Exits non-zero, printing no result, where torch sees no CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

DEVICE = "cuda"
TEAPOT = "scenes/teapot.json"
CORNELL = "scenes/cornell.json"
FLT_MAX = 3.402823466e38
NORMAL_TOL = 1e-6    # kernels and plain versions share 1/sqrt: expect 0
IMAGE_TOL = 1e-4     # a pixel "differs" above this in any channel
IMAGE_SHARE = 0.01   # ... and under 1% of pixels may differ


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def compare(name, got, ref, float_idx, int_idx, exact_idx):
    """Integer outputs and the `exact_idx` floats must be equal; the other
    floats within NORMAL_TOL. Returns the max abs difference over floats."""
    import torch
    for k in int_idx:
        if not torch.equal(got[k], ref[k]):
            bad = int((got[k] != ref[k]).sum())
            raise AssertionError(f"{name}: integer output {k} differs on "
                                 f"{bad} lanes")
    err = 0.0
    for k in float_idx:
        diff = float((got[k] - ref[k]).abs().max()) if got[k].numel() else 0.0
        if k in exact_idx and not torch.equal(got[k], ref[k]):
            raise AssertionError(f"{name}: output {k} differs, max {diff}")
        if diff > NORMAL_TOL:
            raise AssertionError(f"{name}: output {k} max diff {diff}")
        err = max(err, diff)
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    # -- 1. setup --------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")
    from pathtracer_tpu_torch import load_scene, render
    from pathtracer_tpu_torch.engine import wavefront
    from pathtracer_tpu_torch.ops import binned, bvh_packet, kernels, rng
    from pathtracer_tpu_torch.ops.intersect import intersect_scene
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")

    # -- 2. build ----------------------------------------------------------
    path, secs, build_log = kernels.build()
    kernels.library()
    log(f"build: {secs:.2f} s -> {path}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    scene, settings = load_scene(TEAPOT, dev)
    log(f"teapot load: {time.perf_counter() - t0:.2f} s, "
        f"{settings.width}x{settings.height} d{settings.trace_depth}, "
        f"{scene.tris_packed.shape[0] * 6} triangle slots, "
        f"{scene.treelet_f.shape[0] * 16} treelet slots, "
        f"bvh_impl={settings.bvh_impl}")

    # -- 3. kernels vs plain versions on bounce-1 rays ------------------------
    captured = {}

    def recording(name, fn):
        def wrapper(*args):
            captured.setdefault(name, args)
            return fn(*args)
        return wrapper

    with torch.inference_mode():
        irng = rng.IterationRng(0, 1, pixel_map=settings.pixel_map())
        state = wavefront.generate_paths(scene, settings, irng)
        accum = wavefront.zero_accum(settings, dev)
        state = wavefront.bounce_step(scene, settings, irng, 0, state, accum)
        live = state.remaining_bounces > 0
        log(f"bounce-1 pool: {state.origin.x.shape[0]} lanes, "
            f"{int(live.sum())} live")
        with mock.patch.object(binned, "cull",
                               recording("cull", binned.cull)), \
                mock.patch.object(binned, "stream",
                                  recording("stream", binned.stream)), \
                mock.patch.object(bvh_packet, "packet_walk",
                                  recording("packet",
                                            bvh_packet.packet_walk)):
            intersect_scene(scene, settings.geom_types, state.origin,
                            state.direction, bvh_impl="binned", active=live)
        torch.cuda.synchronize()

        specs = {
            "cull": (binned.cull, binned.cull_plain, [1], [0], [1],
                     "pathtracer_tpu_torch/csrc/cull.cu",
                     "pathtracer_tpu/ops/binned.py:290"),
            "stream": (binned.stream, binned.stream_plain, [0, 1, 2, 3],
                       [4], [0], "pathtracer_tpu_torch/csrc/stream.cu",
                       "pathtracer_tpu/ops/binned.py:446"),
            "packet": (bvh_packet.packet_walk, bvh_packet.packet_walk_plain,
                       [0, 1, 2, 3], [4], [0],
                       "pathtracer_tpu_torch/csrc/packet.cu",
                       "pathtracer_tpu/ops/bvh_pallas.py:70"),
        }
        report = {}
        for name, (kern, plain, f_idx, i_idx, ex_idx, src, tpu) in \
                specs.items():
            args = captured[name]
            got, ref = kern(*args), plain(*args)
            torch.cuda.synchronize()
            err = compare(name, got, ref, f_idx, i_idx, ex_idx)
            ms = cuda_ms(lambda: kern(*args), reps=20)
            plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
            report[name] = {"name": name, "route": "cuda", "source": src,
                            "replaces": tpu, "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms}
            log(f"kernel {name}: {args[-1].shape[0]} lanes, max_abs_err "
                f"{err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        n_fb = int((captured["packet"][10] > 0).sum())
        log(f"packet fallback lanes active on the main path: {n_fb}")

        # the packet walk on every live lane (bvh_impl="pallas" contract)
        n = state.origin.x.shape[0]
        w_args = (scene.bvh_packed_f, scene.bvh_packed_i, scene.tris_packed,
                  scene.mesh_roots[0], *(c.contiguous() for c in
                                         state.origin),
                  *(c.contiguous() for c in state.direction),
                  live.to(torch.int32),
                  torch.full((n,), FLT_MAX, device=dev))
        err = compare("packet(all live)", bvh_packet.packet_walk(*w_args),
                      bvh_packet.packet_walk_plain(*w_args), [0, 1, 2, 3],
                      [4], [0])
        report["packet"]["max_abs_err"] = max(report["packet"]["max_abs_err"],
                                              err)
        log(f"kernel packet on all {int(live.sum())} live lanes: max_abs_err "
            f"{err:.3g}, kernel "
            f"{cuda_ms(lambda: bvh_packet.packet_walk(*w_args), 5):.3f} ms")

    # -- 4. teapot 800x800 d4 through the main path ---------------------------
    render(scene, settings, iterations=1, seed=0)       # warm-up
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    iters = 4
    t0 = time.perf_counter()
    img = render(scene, settings, iterations=iters, seed=0)
    torch.cuda.synchronize()
    teapot_ms = 1000.0 * (time.perf_counter() - t0) / iters
    launches = dict(kernels.LAUNCHES)
    log(f"teapot {settings.width}x{settings.height} d{settings.trace_depth}:"
        f" {teapot_ms:.2f} ms/frame over {iters} iterations, launches "
        f"{launches}, image mean {img.mean(axis=(0, 1)).tolist()}")
    for k, c in launches.items():
        if c <= 0:
            raise AssertionError(f"main path never launched the {k} kernel")
        report[k]["launches"] = c
    if not np.isfinite(img).all() or not img.max() > 0:
        raise AssertionError("teapot image is not finite or all zero")

    # -- 5. kernel path vs plain path, teapot 64x64 d4 -----------------------
    small, s_set = load_scene(TEAPOT, dev,
                              overrides={"RES": [64, 64], "DEPTH": 4})
    img_k = render(small, s_set, iterations=2, seed=0)
    with mock.patch.object(binned, "cull", binned.cull_plain), \
            mock.patch.object(binned, "stream", binned.stream_plain), \
            mock.patch.object(bvh_packet, "packet_walk",
                              bvh_packet.packet_walk_plain):
        img_p = render(small, s_set, iterations=2, seed=0)
    differs = np.abs(img_k - img_p).max(axis=-1) > IMAGE_TOL
    log(f"teapot 64x64 d4 kernels vs plain: max diff "
        f"{float(np.abs(img_k - img_p).max()):.3g}, pixels over "
        f"{IMAGE_TOL}: {float(differs.mean()):.4%}")
    if differs.mean() >= IMAGE_SHARE:
        raise AssertionError("kernel and plain images disagree")

    # -- 6. Cornell 800x800 d8 ----------------------------------------------
    c_scene, c_set = load_scene(CORNELL, dev)
    render(c_scene, c_set, iterations=1, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_img = render(c_scene, c_set, iterations=iters, seed=0)
    torch.cuda.synchronize()
    cornell_ms = 1000.0 * (time.perf_counter() - t0) / iters
    if not np.isfinite(c_img).all() or not c_img.max() > 0:
        raise AssertionError("cornell image is not finite or all zero")
    log(f"cornell {c_set.width}x{c_set.height} d{c_set.trace_depth}: "
        f"{cornell_ms:.2f} ms/frame over {iters} iterations")

    # -- 7. results ------------------------------------------------------------
    log(json.dumps({"kernels": list(report.values())}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
