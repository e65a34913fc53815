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
     those inputs (every cull and stream call of the binned passes, the
     first call of the others; float outputs that must be exact by their
     bits), with median times and the least time the card could take for
     the work these inputs need (bound), and each kernel's device time per
     call from torch.profiler (and for cull and stream, summed over the
     bounce's calls); the push walk is also timed with its cull, which must
     not change its outputs; both 8-wide walks (and the push cull) also on
     the binned intersector's wide-fallback call and on animal.json's
     bounce-1 pool through "wide", bit for bit; the packet walk also on
     every live lane (bvh_impl "pallas" contract); the brute kernel also on
     animal.json's bounce-1 pool (its first ANIMAL_LANES lanes against the
     plain version), and beside its bound the floor of its bit-exact,
     unfused arithmetic;
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
     must agree with the "binned" one;
  9. the scan kernel (csrc/scan.cu) against its plain version: the bounce-1
     liveness mask as int32 (640,000 lanes) and ragged sizes bit for bit,
     back to back on one stream with n shrinking and growing, a float32
     plane of that pool within SCAN_F32_RTOL and the same in two runs;
     median times and device times beside the bound (8 bytes an element)
     and torch.cumsum's;
 10. the scan's API on the bounce-1 state, counters reset just before and
     read just after: compact by liveness (one scan launch) must equal its
     plain version, and the radix sort_by_key of the material keys (one
     launch a bit) must equal torch.sort(stable=True);
 11. Cornell's ray_survival; then teapot 800x800 d4 and Cornell 800x800 d8
     in the sorted, tiled (compact_tile 16000) and persistent modes, each
     with the counters reset just before: ms/frame (persistent: steps a
     frame), teapot must launch its mesh kernels, every image finite and
     not all zero;
 12. teapot and Cornell 64x64 d4: the sorted, tiled and persistent images
     must each agree with the masked one;
 13. gradients, Cornell 800x800 d8: the forward image of render_iteration
     with the albedo requiring grad must equal its image under inference
     mode bit for bit; then 5 steps of tools/fit_albedo.albedo_fit_step
     from the albedo perturbed as that tool does, against the target of
     iteration 1, seed 0: the loss after them must be below the loss at
     step 1, the albedo MAE below its start; ms a step (forward and
     backward) beside the forward-only ms/frame, and the peak memory; the
     device ms of one step by torch.profiler and its largest kernels;
 14. teapot 800x800 d4 through "binned": one value-and-grad of the albedo
     loss with the launch counters reset just before and read just after:
     cull, stream and packet must each launch, the gradient must be finite
     and not zero; at 64x64 d4 the same gradient with the plain versions
     on the card, and through "jnp", must agree with it within GRAD_RTOL;
 15. glass_slab at its checked-in 48x48 d6: tools/fit_ior with its
     defaults (60 steps, spp 4) must end below half its starting IOR
     error (the tool's exit code 0);
 16. Cornell 64x64 d4: the albedo gradient's three largest coordinates
     against central differences (eps 1e-3, rtol 0.05, abs 1e-5);
 17. teapot 64x64 d4 through "jnp": the image must agree with "binned".
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
# the brute kernel keeps -fmad=false for its bits: each multiply and add is
# an instruction of its own, so its arithmetic takes at least twice the time
# the FP32 peak (which counts a fused multiply-add as two operations) gives
UNFUSED = 2.0
ANIMAL = "scenes/animal.json"
ANIMAL_LANES = 65536  # the plain version over every animal lane is too slow
# the scan at ragged sizes (int32, bit for bit) beside the 640,000-lane mask
RAGGED = (1, 31, 4095, 4097, 2 ** 24 + 3)
# the scan's float32 tolerance: two orders of summing n float32 values differ
# by at most about (the longer chain of dependent adds) * 2**-24 * sum |x|;
# 1e-5 * sum |x| allows chains of some 170 adds (the kernel's is under 60)
SCAN_F32_RTOL = 1e-5
MODE_ITERS = 2       # timed iterations of each engine mode at 800x800
GLASS = "scenes/glass_slab.json"
FIT_STEPS = 5        # albedo-fit steps at Cornell 800x800 d8
PROFILE_TOP = 6      # the largest device kernels of a step that are logged
# gradients through the kernels vs the plain versions (or "jnp"): the
# backward of the material gather sums with atomics on the card, in an
# order that changes from run to run, so equal only to float rounding
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-7
FD_EPS, FD_RTOL, FD_ATOL = 1e-3, 0.05, 1e-5   # tests/test_grad.py


def leaves(tree) -> list:
    """The tensors of a tree of tuples, in order."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in leaves(sub)]


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, got, ref, float_idx, int_idx, exact_idx):
    """Integer outputs and the `exact_idx` floats must be equal, floats by
    their bits (torch.equal takes -0 == +0); the other floats within
    NORMAL_TOL. Returns the max abs difference over floats."""
    import torch
    for k in int_idx:
        if not torch.equal(got[k], ref[k]):
            bad = int((got[k] != ref[k]).sum())
            raise AssertionError(f"{name}: integer output {k} differs on "
                                 f"{bad} lanes")
    err = 0.0
    for k in float_idx:
        diff = float((got[k] - ref[k]).abs().max()) if got[k].numel() else 0.0
        if k in exact_idx and not torch.equal(got[k].view(torch.int32),
                                              ref[k].view(torch.int32)):
            bad = int((got[k].view(torch.int32)
                       != ref[k].view(torch.int32)).sum())
            raise AssertionError(f"{name}: output {k} differs in its bits on "
                                 f"{bad} lanes, max {diff}")
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


def gradient_phases(dev, c_scene, c_set, scene, settings, c_small, cs_set,
                    small, s_set, img_k) -> dict:
    """Phases 13-17 (the module docstring): Cornell (c_*) and teapot at
    their checked-in sizes and at 64x64 d4 (c_small, small), and the
    kernels' 64x64 teapot image `img_k`. Raises on any failure."""
    import torch
    from pathtracer_tpu_torch import load_scene, render
    from pathtracer_tpu_torch.engine.wavefront import (render_iteration,
                                                       zero_accum)
    from pathtracer_tpu_torch.ops import binned, bvh_packet, kernels
    from pathtracer_tpu_torch.tools import fit_albedo, fit_ior
    from pathtracer_tpu_torch.utils.grad import value_and_grad, with_materials
    from pathtracer_tpu_torch.utils.kernel_bench import device_ms

    # -- 13. gradients: the albedo fit, Cornell 800x800 d8 --------------------
    grads = {}

    def iteration(sc, st, grad=False):
        """One fixed-depth iteration (iteration 1, seed 0): under inference
        mode, or with the albedo requiring grad."""
        if grad:
            color = sc.materials.color.detach().requires_grad_(True)
            sc = with_materials(sc, color=color)
            return render_iteration(sc, st, zero_accum(st, dev), 1, seed=0,
                                    early_exit=False)
        with torch.inference_mode():
            return render_iteration(sc, st, zero_accum(st, dev), 1, seed=0,
                                    early_exit=False)

    true_albedo = c_scene.materials.color.cpu().numpy()
    target = iteration(c_scene, c_set)
    wrong = with_materials(c_scene, color=torch.as_tensor(
        fit_albedo.perturbed_albedo(true_albedo, 0.25), dtype=torch.float32,
        device=dev))
    img_g, img_i = iteration(wrong, c_set, grad=True), iteration(wrong, c_set)
    for a, b in zip(img_g, img_i):
        if not torch.equal(a.detach().view(torch.int32),
                           b.view(torch.int32)):
            raise AssertionError("cornell: the forward image in gradient "
                                 "mode differs from inference mode")
    del img_g, img_i
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        iteration(wrong, c_set)
    torch.cuda.synchronize()
    fwd_ms = 1000.0 * (time.perf_counter() - t0) / 3

    def mae(sc):
        return float(np.abs(sc.materials.color.cpu().numpy()
                            - true_albedo).mean())

    s, losses, step_ms, maes = wrong, [], [], [mae(wrong)]
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    for k in range(FIT_STEPS):
        t0 = time.perf_counter()
        s, loss = fit_albedo.albedo_fit_step(s, c_set, target, 1, lr=1.0,
                                             seed=0)
        losses.append(float(loss))
        step_ms.append(1000.0 * (time.perf_counter() - t0))
        maes.append(mae(s))
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        final_loss = float(fit_albedo.albedo_loss(s, c_set, target, 1)(
            s.materials.color))
    step_dev, by_kernel = device_ms(lambda: fit_albedo.albedo_fit_step(
        wrong, c_set, target, 1, lr=1.0, seed=0), reps=1, warmup=1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
    grads["cornell_fit"] = {
        "steps": FIT_STEPS, "losses": losses, "loss_after": final_loss,
        "albedo_mae": maes, "step_ms": step_ms,
        "forward_ms": fwd_ms, "peak_bytes": peak, "base_bytes": base_mem,
        "step_device_ms": step_dev,
        "top_kernels": [{"kernel": k[:120], "ms": ms} for k, ms in top]}
    log(f"cornell {c_set.width}x{c_set.height} d{c_set.trace_depth} albedo "
        f"fit: forward image in gradient mode bit-equal to inference mode; "
        f"losses {losses}, after step {FIT_STEPS} {final_loss}; albedo MAE "
        f"{maes}; ms a step (forward + backward) {step_ms}; forward-only "
        f"{fwd_ms:.2f} ms/frame (fixed depth); peak memory "
        f"{peak / 2**30:.3f} GiB ({base_mem / 2**30:.3f} GiB before)")
    log(f"cornell albedo step, torch.profiler: {step_dev:.2f} device ms; "
        f"its {PROFILE_TOP} largest kernels (ms): "
        + "; ".join(f"{ms:.3f} {k[:90]}" for k, ms in top))
    if not (final_loss < losses[0] and maes[-1] < maes[0]):
        raise AssertionError("cornell albedo fit: loss or MAE did not fall")

    # -- 14. gradients through the mesh kernels, teapot "binned" ------------
    def albedo_grad(sc, st):
        """value_and_grad of the albedo loss from the perturbed albedo,
        against the true albedo's image."""
        tgt = iteration(sc, st)
        start = with_materials(sc, color=torch.as_tensor(
            fit_albedo.perturbed_albedo(sc.materials.color.cpu().numpy(),
                                        0.25), dtype=torch.float32,
            device=dev))
        return value_and_grad(fit_albedo.albedo_loss(start, st, tgt, 1),
                              start.materials.color)

    albedo_grad(scene, settings)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    t_loss, t_grad = albedo_grad(scene, settings)
    torch.cuda.synchronize()
    t_ms = 1000.0 * (time.perf_counter() - t0)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    t_peak = torch.cuda.max_memory_allocated()
    grads["teapot_binned"] = {"ms": t_ms, "launches": launches,
                              "peak_bytes": t_peak, "loss": float(t_loss),
                              "grad_max_abs": float(t_grad.abs().max())}
    log(f"teapot {settings.width}x{settings.height} d{settings.trace_depth} "
        f"binned albedo value-and-grad: loss {float(t_loss)}, max |g| "
        f"{float(t_grad.abs().max()):.4g}, {t_ms:.2f} ms (target render + "
        f"forward + backward), launches {launches}, peak memory "
        f"{t_peak / 2**30:.3f} GiB")
    for k in ("cull", "stream", "packet"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"teapot gradient never launched the {k} "
                                 "kernel")
    if not bool(torch.isfinite(t_grad).all()) or not bool(t_grad.any()):
        raise AssertionError("teapot albedo gradient not finite or zero")
    _, g_k = albedo_grad(small, s_set)
    with mock.patch.object(binned, "cull", binned.cull_plain), \
            mock.patch.object(binned, "stream", binned.stream_plain), \
            mock.patch.object(bvh_packet, "packet_walk",
                              bvh_packet.packet_walk_plain):
        _, g_p = albedo_grad(small, s_set)
    small_j, sj_set = load_scene(TEAPOT, dev, bvh_impl="jnp",
                                 overrides={"RES": [64, 64], "DEPTH": 4})
    _, g_j = albedo_grad(small_j, sj_set)
    for label, g in (("plain versions", g_p), ('"jnp"', g_j)):
        err = float((g - g_k).abs().max())
        log(f"teapot 64x64 d4 albedo gradient, kernels vs {label}: max "
            f"diff {err:.3g} (max |g| {float(g_k.abs().max()):.4g})")
        torch.testing.assert_close(g, g_k, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if not bool(g_k.any()):
        raise AssertionError("teapot 64x64 albedo gradient is zero")

    # -- 15. the IOR fit, glass_slab 48x48 d6 --------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = fit_ior.main([GLASS, "--res", "48", "--depth", "6",
                       "--device", dev.type])
    torch.cuda.synchronize()
    ior_s = time.perf_counter() - t0
    grads["glass_ior_fit"] = {"seconds": ior_s, "exit_code": rc,
                              "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"glass_slab 48x48 d6 IOR fit (60 steps, spp 4): exit code {rc}, "
        f"{ior_s:.2f} s ({1000.0 * ior_s / 60:.1f} ms a step with the "
        f"targets and the check), peak memory "
        f"{grads['glass_ior_fit']['peak_bytes'] / 2**30:.3f} GiB")
    if rc != 0:
        raise AssertionError("glass_slab IOR fit did not halve its error")

    # -- 16. finite differences on the card, Cornell 64x64 d4 ----------------
    def image_mean(color):
        # tests/test_grad.py's loss: the image sum over the pixel count
        img = render_iteration(with_materials(c_small, color=color), cs_set,
                               zero_accum(cs_set, dev), 1, seed=0,
                               early_exit=False)
        return (img.x.sum() + img.y.sum() + img.z.sum()) / cs_set.pixel_count

    p0 = c_small.materials.color
    _, g = value_and_grad(image_mean, p0)
    flat = g.cpu().numpy().ravel()
    p64 = p0.cpu().numpy().astype(np.float64)
    checked = []
    with torch.no_grad():
        for i in np.argsort(-np.abs(flat))[:3]:
            dp = np.zeros_like(p64).ravel()
            dp[i] = FD_EPS
            dp = dp.reshape(p64.shape)
            lp, lm = (float(image_mean(torch.as_tensor(
                p64 + sgn * dp, dtype=torch.float32, device=dev)))
                for sgn in (1, -1))
            fd = (lp - lm) / (2 * FD_EPS)
            checked.append((int(i), float(flat[i]), fd))
            if abs(fd - flat[i]) > FD_ATOL + FD_RTOL * abs(flat[i]):
                raise AssertionError(f"cornell 64x64 albedo[{i}]: autodiff "
                                     f"{flat[i]} vs FD {fd}")
    grads["cornell_fd"] = checked
    log(f"cornell 64x64 d4 albedo gradient vs central differences (index, "
        f"autodiff, FD): {checked}")

    # -- 17. "jnp" vs "binned", teapot 64x64 d4 ------------------------------
    img_j = render(small_j, sj_set, iterations=2, seed=0)
    image_agreement('teapot 64x64 d4 "jnp" vs binned', img_j, img_k)
    log(json.dumps({"gradients": grads}))
    return grads


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    # -- 1. setup --------------------------------------------------------
    from pathtracer_tpu_torch.utils.kernel_bench import (card_line, cuda_ms,
                                                         device_ms)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")
    from pathtracer_tpu_torch import load_scene, render, render_persistent
    from pathtracer_tpu_torch.engine import persistent, wavefront
    from pathtracer_tpu_torch.engine.wavefront import ray_survival
    from pathtracer_tpu_torch.ops import (binned, brute, bvh_packet, kernels,
                                          rng, scan, wide)
    from pathtracer_tpu_torch.ops.intersect import intersect_scene
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")

    # -- 2. build ----------------------------------------------------------
    path, secs, build_log = kernels.build()
    lib = kernels.library()
    log(f"build: {secs:.2f} s -> {path}")
    for line in build_log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "smem" in line):
            log(f"  ptxas: {line.strip()}")
    log("wide walk dynamic shared memory a block: push "
        f"{lib.pt_wide_smem(0, 0)} bytes, push with cull "
        f"{lib.pt_wide_smem(0, 1)}, mask {lib.pt_wide_smem(1, 0)}")

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
    captured = {}   # kernel -> the arguments of each call, in order

    def recording(name, fn):
        def wrapper(*args, **kwargs):
            # the 8-wide walk's kernel table rides at the end (index 12)
            extra = ((kwargs["nodes8_c"],) if name.startswith("wide")
                     else ())
            captured.setdefault(name, []).append(args + extra)
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

        def push(*a, cull=False):
            return wide.wide_walk(*a[:12], variant="push", cull=cull,
                                  nodes8_c=a[12])

        def mask(*a):
            return wide.wide_walk(*a[:12], variant="mask", nodes8_c=a[12])

        def push_plain(*a, **kw):
            return wide.wide_walk_plain(*a[:12], variant="push", **kw)

        def mask_plain(*a, **kw):
            return wide.wide_walk_plain(*a[:12], variant="mask", **kw)

        def brute_plain(coeffs, attrs, table, n_tris, *planes):
            return brute.brute_plain(coeffs, attrs, *planes)

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
            "brute": (brute.brute, brute_plain, "brute",
                      ([0, 1, 2, 3], [4], [0, 1, 2, 3]),
                      src + "brute.cu", tpu + "bvh_pallas.py:427"),
        }
        report, outputs = {}, {}

        def check_and_time(name, kern, plain, args, idx):
            """One captured call: (outputs, max_abs_err, counts, ms, device
            ms, n_need, n_bytes, ops)."""
            f_idx, i_idx, ex_idx = idx
            counts = {}
            got = kern(*args)
            if name in ("packet", "wide_push", "wide_mask"):
                ref = plain(*args, counts=counts)
            else:
                ref = plain(*args)
            torch.cuda.synchronize()
            err = compare(name, got, ref, f_idx, i_idx, ex_idx)
            ms = cuda_ms(lambda: kern(*args), reps=20)
            dev_ms, _ = device_ms(lambda: kern(*args), reps=20)
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
                ops = brute_ops(args[0], args[4].shape[0])
                n_need = args[4].shape[0]
                n_bytes = need_bytes(args[:2], args[4:10], n_need, [], got)
            else:
                ops = (OPS_BOX * counts["box_tests"]
                       + OPS_TRI * counts["tri_tests"])
                n_need = int((args[10] > 0).sum())
                # the tables the kernel reads: the packet walk's three, the
                # 8-wide walk's node table (index 12), triangles and root
                tables = args[:4] if name == "packet" else (args[12],
                                                            *args[2:4])
                n_bytes = need_bytes(tables, (*args[4:10], args[11]),
                                     n_need, [args[10]], got)
            return got, err, counts, ms, dev_ms, n_need, n_bytes, ops

        for name, (kern, plain, key, idx, source,
                   replaces) in specs.items():
            # cull and stream: every call of the bounce's binned passes;
            # the first call's numbers head the report
            calls = captured[key] if name in ("cull", "stream") else \
                captured[key][:1]
            per_call = []
            for k, args in enumerate(calls):
                (got, err, counts, ms, dev_ms, n_need, n_bytes,
                 ops) = check_and_time(name, kern, plain, args, idx)
                bound_ms, bound_by = bound(n_bytes, ops)
                per_call.append({"ms": ms, "device_ms": dev_ms,
                                 "bound_ms": bound_ms, "work": n_need,
                                 "max_abs_err": err})
                # the lanes: the last ray plane (tb) of a walk's call
                lanes = args[11 if name.startswith("wide") else -1].shape[0]
                log(f"kernel {name}" + (f" call {k}" if len(calls) > 1
                                        else "")
                    + f": {lanes} lanes ({n_need} needing "
                    f"work), max_abs_err {err:.3g}, kernel {ms:.4f} ms "
                    f"(device {dev_ms:.4f}), bound {bound_ms:.4f} ms by "
                    f"{bound_by} ({n_bytes} bytes, {ops} FP32 ops"
                    + (f", {counts}" if counts else "") + ")")
                if k == 0:
                    outputs[name] = got
                    head = (ms, dev_ms, bound_ms, bound_by)
            args = calls[0]
            plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
            ms, dev_ms, bound_ms, bound_by = head
            report[name] = {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0,
                "max_abs_err": max(c["max_abs_err"] for c in per_call),
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}
            log(f"kernel {name}: plain {plain_ms:.4f} ms on the first call's "
                "inputs")
            if len(calls) > 1:
                report[name].update(
                    calls=per_call,
                    bounce_device_ms=sum(c["device_ms"] for c in per_call),
                    bounce_bound_ms=sum(c["bound_ms"] for c in per_call))
                log(f"kernel {name}: {len(calls)} calls in the bounce-1 "
                    f"binned intersection, device "
                    f"{report[name]['bounce_device_ms']:.4f} ms in all "
                    f"(bound {report[name]['bounce_bound_ms']:.4f} ms)")
        # the two stack disciplines visit the same children in the same order
        compare("wide_push vs wide_mask", outputs["wide_push"],
                outputs["wide_mask"], [0, 1, 2, 3], [4], [0, 1, 2, 3])
        log("kernel wide_push == wide_mask on the captured inputs")
        # the push variant's cull (off on every render path, as in the JAX
        # package): the same outputs, and its time beside the one above
        w = captured["wide"][0]
        cull_counts = {}
        compare("wide_push cull", push(*w, cull=True),
                outputs["wide_push"], [0, 1, 2, 3], [4], [0, 1, 2, 3])
        push_plain(*w, cull=True, counts=cull_counts)
        cull_ms = cuda_ms(lambda: push(*w, cull=True), reps=20)
        log(f"kernel wide_push with cull: {cull_ms:.4f} ms against "
            f"{report['wide_push']['ms']:.4f} ms without, same outputs "
            f"({cull_counts})")
        n_fb = int((captured["packet"][0][10] > 0).sum())
        log(f"packet fallback lanes active on the main path: {n_fb}")

        def wide_inputs(label, w):
            """Push (with and without its cull) and mask on one captured
            8-wide walk call: each bit-equal to the plain walk of its
            variant, then timed."""
            ref = push_plain(*w)
            got = {"push": push(*w), "push cull": push(*w, cull=True),
                   "mask": mask(*w)}
            for key, out in got.items():
                compare(f"wide {key} ({label})", out,
                        mask_plain(*w) if key == "mask" else ref,
                        [0, 1, 2, 3], [4], [0, 1, 2, 3])
            for name, fn in (("wide_push", push), ("wide_mask", mask)):
                dev_ms, _ = device_ms(lambda: fn(*w), reps=20)
                report[name][f"{label}_device_ms"] = dev_ms
                log(f"kernel {name} on {label}: {w[4].shape[0]} lanes, "
                    f"{int((w[10] > 0).sum())} active, bit-equal, device "
                    f"{dev_ms:.4f} ms")

        # the 8-wide walk as the binned intersector's exact finish
        with mock.patch.object(binned, "FALLBACK_IMPL", "wide"), \
                mock.patch.object(wide, "wide_walk",
                                  recording("wide_fallback",
                                            wide.wide_walk)):
            intersect_scene(scene, settings.geom_types, state.origin,
                            state.direction, bvh_impl="binned", active=live)
        wide_inputs("fallback", captured["wide_fallback"][0])

        # brute: the unfused floor beside the bound, and animal's bounce-1
        # pool (93 tiles), its first ANIMAL_LANES lanes bit for bit
        b = report["brute"]
        b["unfused_floor_ms"] = UNFUSED * b["bound_ms"]
        a_scene, a_set = load_scene(ANIMAL, dev, brute_tables=True,
                                    wide_tables=True)
        a_irng = rng.IterationRng(0, 1, pixel_map=a_set.pixel_map())
        a_state = wavefront.bounce_step(
            a_scene, a_set, a_irng, 0,
            wavefront.generate_paths(a_scene, a_set, a_irng),
            wavefront.zero_accum(a_set, dev))
        a_args = (a_scene.tris_mxu_c, a_scene.tris_mxu_n, a_scene.tris_brute,
                  a_scene.brute_tris,
                  *(c.contiguous() for c in a_state.origin),
                  *(c.contiguous() for c in a_state.direction))
        a_got = brute.brute(*a_args)
        a_ref = brute_plain(*a_args[:4], *(c[:ANIMAL_LANES]
                                           for c in a_args[4:]))
        torch.cuda.synchronize()
        err = compare("brute(animal)", [g[:ANIMAL_LANES] for g in a_got],
                      a_ref, [0, 1, 2, 3], [4], [0, 1, 2, 3])
        b["max_abs_err"] = max(b["max_abs_err"], err)
        a_ms = cuda_ms(lambda: brute.brute(*a_args), reps=10)
        a_dev, _ = device_ms(lambda: brute.brute(*a_args), reps=10)
        a_ops = brute_ops(a_args[0], a_args[4].shape[0])
        a_bound = bound(need_bytes(a_args[:2], a_args[4:10],
                                   a_args[4].shape[0], [], a_got), a_ops)[0]
        b.update(animal_lanes=a_args[4].shape[0], animal_ms=a_ms,
                 animal_device_ms=a_dev, animal_bound_ms=a_bound,
                 animal_unfused_floor_ms=UNFUSED * a_bound)
        log(f"kernel brute: unfused floor {b['unfused_floor_ms']:.4f} ms "
            f"beside the bound {b['bound_ms']:.4f}; animal "
            f"{a_args[4].shape[0]} lanes, {a_scene.brute_tris} triangles "
            f"swept: first {ANIMAL_LANES} lanes bit-equal, kernel "
            f"{a_ms:.4f} ms (device {a_dev:.4f}), bound {a_bound:.4f} ms, "
            f"unfused floor {UNFUSED * a_bound:.4f} ms")
        # the 8-wide walk on animal's bounce-1 pool (1,312 node slots)
        with mock.patch.object(wide, "wide_walk",
                               recording("wide_animal", wide.wide_walk)):
            intersect_scene(a_scene, a_set.geom_types, a_state.origin,
                            a_state.direction, bvh_impl="wide",
                            active=a_state.remaining_bounces > 0)
        wide_inputs("animal", captured["wide_animal"][0])
        del a_scene, a_state, a_args, a_got, a_ref

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
        all_ms = cuda_ms(lambda: bvh_packet.packet_walk(*w_args), 20)
        all_dev, _ = device_ms(lambda: bvh_packet.packet_walk(*w_args), 20)
        report["packet"].update(all_live_ms=all_ms, all_live_device_ms=all_dev)
        log(f"kernel packet on all {int(live.sum())} live lanes: max_abs_err "
            f"{err:.3g}, kernel {all_ms:.4f} ms (device {all_dev:.4f})")

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

    # -- 9. the scan kernel vs its plain version -------------------------------
    with torch.inference_mode():
        mask = live.to(torch.int32)          # teapot bounce-1 liveness
        plane = state.color.x.contiguous()   # a float32 plane of that pool
        counts = {}
        got = scan.exclusive_scan(mask)
        ref = scan.exclusive_scan_plain(mask)
        if not torch.equal(got, ref):
            raise AssertionError("scan: the liveness mask's scan differs on "
                                 f"{int((got != ref).sum())} lanes")
        gen = torch.Generator(device=dev).manual_seed(0)
        # back to back on one stream, n shrinking and growing (the scratch's
        # epochs and the tile counter's reset)
        for n in (1, 4097, 2 ** 24 + 3, 31, mask.shape[0], 4095):
            x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), device=dev,
                              dtype=torch.int32, generator=gen)
            if not torch.equal(scan.exclusive_scan(x),
                               scan.exclusive_scan_plain(x)):
                raise AssertionError(f"scan: back-to-back n={n} differs")
        for n in RAGGED:
            x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), device=dev,
                              dtype=torch.int32, generator=gen)
            for xi in (x, x & 1):              # sums that wrap, and a mask
                if not torch.equal(scan.exclusive_scan(xi),
                                   scan.exclusive_scan_plain(xi)):
                    raise AssertionError(f"scan: int32 n={n} differs")
        f_got = scan.exclusive_scan(plane)
        f_err = float((f_got - scan.exclusive_scan_plain(plane)).abs().max())
        f_tol = SCAN_F32_RTOL * float(plane.abs().sum())
        if f_err > f_tol or not torch.equal(f_got,
                                            scan.exclusive_scan(plane)):
            raise AssertionError(f"scan: float32 error {f_err} over {f_tol},"
                                 " or two runs differ")
        n = mask.shape[0]

        def lib(x):
            return torch.cumsum(x, 0, dtype=x.dtype)

        ms = cuda_ms(lambda: scan.exclusive_scan(mask), reps=20)
        dev_ms, _ = device_ms(lambda: scan.exclusive_scan(mask), reps=20)
        plain_ms = cuda_ms(lambda: scan.exclusive_scan_plain(mask), reps=20)
        lib_ms = cuda_ms(lambda: lib(mask), reps=20)
        lib_dev, _ = device_ms(lambda: lib(mask), reps=20)
        f_ms = cuda_ms(lambda: scan.exclusive_scan(plane), reps=20)
        big = torch.randint(0, 2, (2 ** 24 + 3,), device=dev,
                            dtype=torch.int32, generator=gen)
        big_ms = cuda_ms(lambda: scan.exclusive_scan(big), reps=10)
        big_dev, _ = device_ms(lambda: scan.exclusive_scan(big), reps=10)
        big_lib = cuda_ms(lambda: lib(big), reps=10)
        big_lib_dev, _ = device_ms(lambda: lib(big), reps=10)
        bound_ms, bound_by = bound(8 * n, 0)
        big_bound = bound(8 * big.shape[0], 0)[0]
        report["scan"] = {
            "name": "scan", "route": "cuda", "source": src + "scan.cu",
            "replaces": "pathtracer_tpu/ops/scan.py:67", "launches": 0,
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "library_device_ms": lib_dev,
            "big_n": big.shape[0], "big_ms": big_ms,
            "big_device_ms": big_dev, "big_bound_ms": big_bound,
            "big_library_ms": big_lib, "big_library_device_ms": big_lib_dev}
        log(f"kernel scan: {n} lanes ({int(mask.sum())} live), int32 "
            f"bit-equal (and at n in {RAGGED}, and back to back), kernel "
            f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, "
            f"torch.cumsum {lib_ms:.4f} ms (device {lib_dev:.4f}), bound "
            f"{bound_ms:.4f} ms by {bound_by}; float32 plane {f_ms:.4f} ms, "
            f"max_abs_err {f_err:.3g} (tolerance {f_tol:.3g}), repeatable; "
            f"n=2**24+3: kernel {big_ms:.4f} ms (device {big_dev:.4f}), "
            f"torch.cumsum {big_lib:.4f} ms (device {big_lib_dev:.4f}), "
            f"bound {big_bound:.4f} ms")

        # -- 10. the scan's API on the bounce-1 state -------------------------
        t, _, mat = intersect_scene(scene, settings.geom_types, state.origin,
                                    state.direction,
                                    bvh_impl=settings.bvh_impl, active=live)
        keys = torch.where(t > 0.0, mat, 0)
        n_bits = max(1, int(keys.max()).bit_length())
        torch.cuda.synchronize()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        packed, count = scan.compact(state, live)
        n_compact = kernels.LAUNCHES["scan"]
        s_keys, s_state = scan.sort_by_key(keys, state, n_bits=n_bits)
        torch.cuda.synchronize()
        n_sort = kernels.LAUNCHES["scan"] - n_compact
        report["scan"]["launches"] = kernels.LAUNCHES["scan"]
        log(f"scan API on the bounce-1 state: compact {int(count)} live of "
            f"{n} ({n_compact} scan launch), radix sort of the material "
            f"keys, {n_bits} bits ({n_sort} scan launches)")
        if n_compact != 1 or n_sort != n_bits:
            raise AssertionError("scan API: expected 1 and n_bits launches")
        with mock.patch.object(scan, "exclusive_scan",
                               scan.exclusive_scan_plain):
            p_packed, p_count = scan.compact(state, live)
        if int(count) != int(p_count) or not all(
                torch.equal(a, b) for a, b in zip(leaves(packed),
                                                  leaves(p_packed))):
            raise AssertionError("compact differs from its plain version")
        w_keys, perm = torch.sort(keys, stable=True)
        want = scan.gather_tree(state, perm)
        if not torch.equal(s_keys, w_keys) or not all(
                torch.equal(a, b) for a, b in zip(leaves(s_state),
                                                  leaves(want))):
            raise AssertionError("sort_by_key differs from torch.sort")

    # -- 11. the engine modes at 800x800 --------------------------------------
    surv = ray_survival(c_scene, c_set, 1).tolist()
    mean_len = sum(surv[:-1]) / surv[0]
    log(f"cornell {c_set.width}x{c_set.height} d{c_set.trace_depth} "
        f"ray_survival {surv}: {mean_len:.3f} bounces a path")
    modes = {"sorted": {"sort_materials": True},
             "tiled": {"compact": True, "compact_tile": 16000},
             "persistent": {}}
    for name, sc, st, masked_ms in (("teapot", scene, settings, teapot_ms),
                                    ("cornell", c_scene, c_set, cornell_ms)):
        for mode, kw in modes.items():
            m_set = dataclasses.replace(st, **kw)
            fn = render_persistent if mode == "persistent" else render
            steps = [0]
            real_step = persistent._step

            def counted(*a, **k):
                steps[0] += 1
                return real_step(*a, **k)

            fn(sc, m_set, iterations=1, seed=0)              # warm-up
            torch.cuda.synchronize()
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            with mock.patch.object(persistent, "_step", counted):
                t0 = time.perf_counter()
                img = fn(sc, m_set, iterations=MODE_ITERS, seed=0)
                torch.cuda.synchronize()
            ms = 1000.0 * (time.perf_counter() - t0) / MODE_ITERS
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            extra = (f", {steps[0] / MODE_ITERS:.1f} steps a frame"
                     if mode == "persistent" else "")
            log(f"{name} {st.width}x{st.height} d{st.trace_depth} {mode}: "
                f"{ms:.2f} ms/frame over {MODE_ITERS} iterations (masked "
                f"{masked_ms:.2f}){extra}, launches {launches}")
            if name == "teapot":
                for k in ("cull", "stream"):
                    if launches.get(k, 0) <= 0:
                        raise AssertionError(f"teapot {mode} never launched "
                                             f"the {k} kernel")
            if not np.isfinite(img).all() or not img.max() > 0:
                raise AssertionError(f"{name} {mode} image is not finite or "
                                     "all zero")

    # -- 12. the engine modes vs masked at 64x64 d4 ----------------------------
    c_small, cs_set = load_scene(CORNELL, dev,
                                 overrides={"RES": [64, 64], "DEPTH": 4})
    for name, sc, st in (("teapot", small, s_set), ("cornell", c_small,
                                                    cs_set)):
        ref = render(sc, st, iterations=2, seed=0)
        for mode, kw in (("sorted", {"sort_materials": True}),
                         ("tiled", {"compact": True, "compact_tile": 1024})):
            image_agreement(f"{name} 64x64 d4 {mode} vs masked",
                            render(sc, dataclasses.replace(st, **kw),
                                   iterations=2, seed=0), ref)
        image_agreement(f"{name} 64x64 d4 persistent vs masked",
                        render_persistent(sc, st, iterations=2, seed=0), ref)

    # -- 13.-17. gradients ---------------------------------------------------
    gradient_phases(dev, c_scene, c_set, scene, settings, c_small, cs_set,
                    small, s_set, img_k)

    # -- 18. results -----------------------------------------------------------
    log(json.dumps({"kernels": list(report.values())}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
