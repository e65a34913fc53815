#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. setup: the card's name and power limit, torch / CUDA / nvcc versions;
  2. build: the kernel library (pathtracer_tpu_torch/csrc) with nvcc;
  3. kernels vs plain versions: one teapot 800x800 iteration is taken to
     bounce 1; the mesh intersection of that bounce-ray pool records the
     inputs each kernel gets on its path (bvh_impl "binned" for cull,
     stream and packet, "wide" for the 8-wide walk, "brute" for the brute
     kernel), and each kernel is held against its plain PyTorch version on
     those inputs, with median times and the least time the card could
     take for the work these inputs need (bound); the push walk is also
     timed with its cull, which must not change its outputs;
  4. teapot 800x800 d4 through pathtracer_tpu_torch.render on the default
     path (binned), with the launch counters reset just before and read
     just after: every kernel of the path must have run, and the image
     must be finite and not all zero;
  5. teapot 64x64 d4, 2 iterations, with the kernels and with the plain
     versions on the card: the images must agree;
  6. Cornell 800x800 d8 (no kernel on its path): ms/frame;
  7. the other mesh paths: teapot 800x800 d4 through bvh_impl "wide" (push
     and mask variants), "wide_nosort", "sorted", "brute" and "binned"
     with the 8-wide fallback, each with the counters reset just before and
     read just after: each must launch its kernels, and its image must be
     finite and not all zero;
  8. teapot 64x64 d4, 2 iterations, through "wide" and "brute": each image
     must agree with the "binned" one.
The second-to-last lines are one JSON object with every kernel's numbers and
the card's name and power limit; the last line is the result object.
Exits non-zero, printing no result, where torch sees no CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of one slab test (common.cuh slab: 6 sub, 6 mul, 10
# min/max, 3 compares) and one Moller-Trumbore test (common.cuh tri_test)
OPS_BOX = 25
OPS_TRI = 55
# the brute function's validity test of one (ray, triangle) pair after its
# four linear forms: a*a, u*a, v*a, u*a + v*a, t*a, eps*a^2 and 5 compares
OPS_BRUTE_TEST = 11


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


def nbytes(*tensors) -> int:
    import torch
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def need_bytes(tables, planes, n_needed: int, always, outputs) -> int:
    """Bytes a call must move on these inputs: every table once, each ray
    plane only on the `n_needed` lanes that need it, the per-lane planes in
    `always` (the masks that say which lanes need work) and every output on
    all lanes."""
    per_lane = sum(p.element_size() for p in planes)
    return (nbytes(*tables) + per_lane * n_needed
            + nbytes(*always, *outputs))


def brute_ops(coeffs, n_rays: int) -> int:
    """FP32 operations the brute function needs on these inputs: per ray
    and real triangle, each linear form's non-zero coefficient terms (a
    multiply each and an add between two; features 10..15 are zero and
    pack_tris_mxu leaves most coefficients zero) plus the validity test.
    Padding triangles, all-zero rows, need none."""
    from pathtracer_tpu_torch.scene.types import MXU_NFEAT, MXU_TRI_TILE
    nnz = (coeffs.reshape(-1, 4, MXU_TRI_TILE, MXU_NFEAT) != 0).sum(-1)
    real = nnz.sum(1) > 0                                # [tiles, TILE]
    form_ops = (2 * nnz - 1).clamp(min=0).sum(1)         # [tiles, TILE]
    return n_rays * (int(form_ops[real].sum())
                     + OPS_BRUTE_TEST * int(real.sum()))


def cull_box_tests(args) -> int:
    """Slab tests the cull kernel makes on these inputs: every live lane
    tests each super row's union box, and the 16 treelets of each row whose
    box it enters closer than its bound (csrc/cull.cu)."""
    from pathtracer_tpu_torch.ops.bvh_packet import slab
    _, sup, ox, oy, oz, dx, dy, dz, bound, _, _, live = args
    lanes = live > 0
    t0, t1 = slab(sup[None, :, 0:3].unbind(-1), sup[None, :, 3:6].unbind(-1),
                  [a[lanes, None] for a in (ox, oy, oz)],
                  [1.0 / a[lanes, None] for a in (dx, dy, dz)])
    entered = (t0 <= t1) & (t1 > 0.0) & (t0 < bound[lanes, None])
    return int(lanes.sum()) * sup.shape[0] + 16 * int(entered.sum())


def stream_tri_tests(args) -> int:
    """Triangle tests the stream kernel makes: every lane with a treelet
    tests its rows of 6 (at most max_rows rows)."""
    import torch
    treelet_i, _, max_rows, *_, tid = args
    ti = treelet_i.reshape(-1, 4)
    ok = (tid >= 0) & (tid < ti.shape[0])
    rows = torch.clamp(ti[tid[ok].long(), 1], max=max_rows)
    return 6 * int(rows.sum())


def bound(n_bytes: int, ops: int) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over
    its memory rate and operations over its FP32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def render_ms(render, scene, settings, iters: int):
    """(image, ms/frame) of `iters` iterations after one warm-up."""
    import torch
    render(scene, settings, iterations=1, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(scene, settings, iterations=iters, seed=0)
    torch.cuda.synchronize()
    return img, 1000.0 * (time.perf_counter() - t0) / iters


def image_agreement(name, img, ref) -> None:
    differs = np.abs(img - ref).max(axis=-1) > IMAGE_TOL
    log(f"{name}: max diff {float(np.abs(img - ref).max()):.3g}, pixels "
        f"over {IMAGE_TOL}: {float(differs.mean()):.4%}")
    if differs.mean() >= IMAGE_SHARE:
        raise AssertionError(f"{name}: images disagree")


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
    from pathtracer_tpu_torch.ops import (binned, brute, bvh_packet, kernels,
                                          rng, wide)
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
    scene, settings = load_scene(TEAPOT, dev, brute_tables=True,
                                 wide_tables=True)
    log(f"teapot load: {time.perf_counter() - t0:.2f} s, "
        f"{settings.width}x{settings.height} d{settings.trace_depth}, "
        f"{scene.tris_packed.shape[0] * 6} triangle slots, "
        f"{scene.treelet_f.shape[0] * 16} treelet slots, "
        f"{scene.nodes8_f.shape[0] * 2} wide node slots, "
        f"{scene.tris_mxu_n.shape[0]} brute triangle slots, "
        f"bvh_impl={settings.bvh_impl}")

    # -- 3. kernels vs plain versions on bounce-1 rays ------------------------
    captured = {}

    def recording(name, fn):
        def wrapper(*args, **kwargs):
            captured.setdefault(name, args)
            return fn(*args, **kwargs)
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
                                            bvh_packet.packet_walk)), \
                mock.patch.object(wide, "wide_walk",
                                  recording("wide", wide.wide_walk)), \
                mock.patch.object(brute, "brute",
                                  recording("brute", brute.brute)):
            for impl in ("binned", "wide", "brute"):
                intersect_scene(scene, settings.geom_types, state.origin,
                                state.direction, bvh_impl=impl, active=live)
        torch.cuda.synchronize()

        def push(*a):
            return wide.wide_walk(*a, variant="push")

        def mask(*a):
            return wide.wide_walk(*a, variant="mask")

        def push_plain(*a, **kw):
            return wide.wide_walk_plain(*a, variant="push", **kw)

        def mask_plain(*a, **kw):
            return wide.wide_walk_plain(*a, variant="mask", **kw)

        src = "pathtracer_tpu_torch/csrc/"
        tpu = "pathtracer_tpu/ops/"
        hit_idx = ([0, 1, 2, 3], [4], [0])    # floats, ints, exact floats
        # name: (kernel, plain, captured inputs, outputs, source, replaces)
        specs = {
            "cull": (binned.cull, binned.cull_plain, "cull", ([1], [0], [1]),
                     src + "cull.cu", tpu + "binned.py:290"),
            "stream": (binned.stream, binned.stream_plain, "stream",
                       ([0, 1, 2, 3], [4], [0]), src + "stream.cu",
                       tpu + "binned.py:446"),
            "packet": (bvh_packet.packet_walk, bvh_packet.packet_walk_plain,
                       "packet", hit_idx, src + "packet.cu",
                       tpu + "bvh_pallas.py:70"),
            "wide_push": (push, push_plain, "wide", hit_idx, src + "wide.cu",
                          tpu + "wide.py:177"),
            "wide_mask": (mask, mask_plain, "wide", hit_idx, src + "wide.cu",
                          tpu + "wide.py:319"),
            "brute": (brute.brute, brute.brute_plain, "brute", hit_idx,
                      src + "brute.cu", tpu + "bvh_pallas.py:427"),
        }
        report, outputs = {}, {}
        for name, (kern, plain, key, (f_idx, i_idx, ex_idx), source,
                   replaces) in specs.items():
            args = captured[key]
            counts = {}
            got = kern(*args)
            if name in ("packet", "wide_push", "wide_mask"):
                ref = plain(*args, counts=counts)
            else:
                ref = plain(*args)
            torch.cuda.synchronize()
            err = compare(name, got, ref, f_idx, i_idx, ex_idx)
            outputs[name] = got
            ms = cuda_ms(lambda: kern(*args), reps=20)
            plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
            # the work these inputs need: ray planes of the lanes the kernel
            # must answer (live for cull, with a treelet for stream, active
            # for the walks, every lane for brute, which ignores `active`)
            if name == "cull":
                ops = OPS_BOX * cull_box_tests(args)
                n_need = int((args[11] > 0).sum())
                n_bytes = need_bytes(args[:2], args[2:11], n_need,
                                     [args[11]], got)
            elif name == "stream":
                ops = OPS_TRI * stream_tri_tests(args)
                tid = args[-1]
                n_need = int(((tid >= 0) & (tid < args[0].reshape(
                    -1, 4).shape[0])).sum())
                n_bytes = need_bytes(args[:2], args[3:10], n_need, [tid],
                                     got)
            elif name == "brute":
                ops = brute_ops(args[0], args[2].shape[0])
                n_need = args[2].shape[0]
                n_bytes = need_bytes(args[:2], args[2:8], n_need, [], got)
            else:
                ops = (OPS_BOX * counts["box_tests"]
                       + OPS_TRI * counts["tri_tests"])
                n_need = int((args[10] > 0).sum())
                n_bytes = need_bytes(args[:4], (*args[4:10], args[11]),
                                     n_need, [args[10]], got)
            bound_ms, bound_by = bound(n_bytes, ops)
            report[name] = {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
            log(f"kernel {name}: {args[-1].shape[0]} lanes ({n_need} "
                f"needing work), max_abs_err {err:.3g}, kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                f"{bound_by} ({n_bytes} bytes, {ops} FP32 ops"
                + (f", {counts}" if counts else "") + ")")
        # the two stack disciplines visit the same children in the same order
        compare("wide_push vs wide_mask", outputs["wide_push"],
                outputs["wide_mask"], [0, 1, 2, 3], [4], [0, 1, 2, 3])
        log("kernel wide_push == wide_mask on the captured inputs")
        # the push variant's cull (off on every render path, as in the JAX
        # package): the same outputs, and its time beside the one above
        w = captured["wide"]
        cull_counts = {}
        compare("wide_push cull", wide.wide_walk(*w, variant="push",
                                                 cull=True),
                outputs["wide_push"], [0, 1, 2, 3], [4], [0, 1, 2, 3])
        wide.wide_walk_plain(*w, variant="push", cull=True,
                             counts=cull_counts)
        cull_ms = cuda_ms(lambda: wide.wide_walk(*w, variant="push",
                                                 cull=True), reps=20)
        log(f"kernel wide_push with cull: {cull_ms:.4f} ms against "
            f"{report['wide_push']['ms']:.4f} ms without, same outputs "
            f"({cull_counts})")
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
    iters = 4
    render(scene, settings, iterations=1, seed=0)       # warm-up
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    img = render(scene, settings, iterations=iters, seed=0)
    torch.cuda.synchronize()
    teapot_ms = 1000.0 * (time.perf_counter() - t0) / iters
    launches = dict(kernels.LAUNCHES)
    log(f"teapot {settings.width}x{settings.height} d{settings.trace_depth}"
        f" binned: {teapot_ms:.2f} ms/frame over {iters} iterations, "
        f"launches {launches}, image mean {img.mean(axis=(0, 1)).tolist()}")
    for k in ("cull", "stream", "packet"):
        if launches[k] <= 0:
            raise AssertionError(f"main path never launched the {k} kernel")
        report[k]["launches"] = launches[k]
    if not np.isfinite(img).all() or not img.max() > 0:
        raise AssertionError("teapot image is not finite or all zero")

    # -- 5. kernel path vs plain path, teapot 64x64 d4 -----------------------
    small, s_set = load_scene(TEAPOT, dev, brute_tables=True,
                              wide_tables=True,
                              overrides={"RES": [64, 64], "DEPTH": 4})
    img_k = render(small, s_set, iterations=2, seed=0)
    with mock.patch.object(binned, "cull", binned.cull_plain), \
            mock.patch.object(binned, "stream", binned.stream_plain), \
            mock.patch.object(bvh_packet, "packet_walk",
                              bvh_packet.packet_walk_plain):
        img_p = render(small, s_set, iterations=2, seed=0)
    image_agreement("teapot 64x64 d4 kernels vs plain", img_k, img_p)

    # -- 6. Cornell 800x800 d8 ----------------------------------------------
    c_scene, c_set = load_scene(CORNELL, dev)
    c_img, cornell_ms = render_ms(render, c_scene, c_set, iters)
    if not np.isfinite(c_img).all() or not c_img.max() > 0:
        raise AssertionError("cornell image is not finite or all zero")
    log(f"cornell {c_set.width}x{c_set.height} d{c_set.trace_depth}: "
        f"{cornell_ms:.2f} ms/frame over {iters} iterations")

    # -- 7. the other mesh paths, teapot 800x800 d4 ---------------------------
    paths = [  # (label, bvh_impl, patches, kernels the path must launch)
        ("wide", "wide", [], ["wide_push"]),
        ("wide (mask variant)", "wide", [(wide, "VARIANT", "mask")],
         ["wide_mask"]),
        ("wide_nosort", "wide_nosort", [], ["wide_push"]),
        ("sorted", "sorted", [], ["packet"]),
        ("brute", "brute", [], ["brute"]),
        ("binned + wide fallback", "binned",
         [(binned, "FALLBACK_IMPL", "wide")],
         ["cull", "stream", "wide_push"]),
    ]
    p_iters = 3
    for label, impl, patches, needs in paths:
        p_set = dataclasses.replace(settings, bvh_impl=impl)
        with contextlib.ExitStack() as stack:
            for module, attr, value in patches:
                stack.enter_context(mock.patch.object(module, attr, value))
            render(scene, p_set, iterations=1, seed=0)       # warm-up
            torch.cuda.synchronize()
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            img = render(scene, p_set, iterations=p_iters, seed=0)
            torch.cuda.synchronize()
            ms = 1000.0 * (time.perf_counter() - t0) / p_iters
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        log(f"teapot {p_set.width}x{p_set.height} d{p_set.trace_depth} "
            f"{label}: {ms:.2f} ms/frame over {p_iters} iterations, "
            f"launches {launches}")
        for k in needs:
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"path {label} never launched the {k} "
                                     "kernel")
        if label in ("wide", "wide (mask variant)", "brute"):
            report[needs[0]]["launches"] = launches[needs[0]]
        if not np.isfinite(img).all() or not img.max() > 0:
            raise AssertionError(f"teapot image through {label} is not "
                                 "finite or all zero")

    # -- 8. wide and brute vs binned, teapot 64x64 d4 -------------------------
    for impl in ("wide", "brute"):
        img_i = render(small, dataclasses.replace(s_set, bvh_impl=impl),
                       iterations=2, seed=0)
        image_agreement(f"teapot 64x64 d4 {impl} vs binned", img_i, img_k)

    # -- 9. results ------------------------------------------------------------
    log(json.dumps({"kernels": list(report.values())}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
