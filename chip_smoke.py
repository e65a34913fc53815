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
 17. teapot 64x64 d4 through "jnp": the image must agree with "binned";
 18. (a) one NCCL rank (parallel/distributed.init_distributed on a free
     localhost port, world size 1): render_distributed of teapot 800x800
     d4 binned, PAR_ITERS iterations, must equal render bit for bit and
     launch cull, stream and packet (counters reset just before, read just
     after); one sharded albedo_fit_step on Cornell 800x800 d8 must equal
     tools/fit_albedo.albedo_fit_step within GRAD_RTOL in loss and new
     albedo; the gather's and the all-reduce's ms; the group is destroyed
     at the end of the phase;
 19. (b) local shards on the one card: render_sharded of teapot 800x800 d4
     binned at 1 and 4 shards must equal render bit for bit, each with its
     ms/frame and cull / stream / packet launches (counters reset just
     before each); render_persistent_sharded of Cornell 800x800 d8 at
     PERSIST_SPP spp on 4 shards must match render_persistent within rtol
     and atol 1e-5; shard_work_counts of Cornell and teapot on 4 shards,
     with and without the interleave: the interleaved max/mean must be
     below the contiguous one;
 20. (c) two ranks in two processes on the one card, with gloo (NCCL
     refuses two ranks on one GPU): tools/multihost_worker on teapot
     800x800 d4 binned (PAR_ITERS iterations) and on Cornell 800x800 d8
     with --fit; the images of the ranks must equal each other and the
     single-process render bit for bit, the ranks' new albedos each other
     bit for bit and phase 18's single-process step within GRAD_RTOL, and
     each teapot rank must launch cull, stream and packet; a worker that
     outlives WORKER_TIMEOUT is killed and fails the phase;
 21. (d) parallel/dryrun.dryrun_multichip(1) on the card;
 22. the binned pipeline's other forms: the teapot bounce-1 pool's cull and
     stream calls recorded under EXPAND=2, EXPAND=4, SLOTS=3,
     MIN_SUPPORT=64, STREAM_UV and CHUNK_GATE; each new kernel form (the
     K-want cull at K = 2, 3, 4; the stream's uv, defer and gate forms)
     against its plain version on every recorded call of its form, bit for
     bit (the default stream on the expanded pools too), with median ms,
     device ms and bound; then teapot 800x800 d4, one iteration under each
     setting with the counters reset just before: each render must launch
     its forms and give the default binned image bit for bit (STREAM_UV
     too: tests/test_torch_binned_forms.py holds its normals to 0 ulp);
     then the threefry path: one bounce's uniforms and raygen normals on
     the card against the CPU's (uniforms bit for bit, normals within
     NORMAL_ULP), Cornell 800x800 d8 with fast_rng=False beside the fast
     path (ms/frame, device kernels of one draw), and the image means of
     both at THREEFRY_SPP spp within THREEFRY_MEAN_TOL (tests/test_engine
     .py:210);
 23. full-scale golden parity: tools/golden_parity.compute_parity of
     Cornell 800x800 d8 at golden_parity.ENVELOPE_SPP spp against the
     reference's 5000-spp render, within tests/test_parity_full.py's
     bounds (golden_parity.check_envelope; that test's 300 spp is too few
     for its correlation bound, see ENVELOPE_SPP), with s and ms a frame;
     then animal 1200x1200 d12 through binned, ANIMAL_SPP spp with the
     counters reset just before and read just after: cull, stream and
     packet must launch, the image must be finite; ms/frame, launches a
     frame and B1-B3's device ms a frame (utils/profiling.device_profile
     over one frame), and the scene's union rows and BVH nodes beside the
     kernels' shared-memory limits; then one more animal frame with cull,
     stream and packet recorded: the lanes of every call by bounce, and
     each call of ANIMAL_CHECK_BOUNCES against its plain version bit for
     bit (the 1,440,000-lane pool at this path's shapes);
 24. measure_stages (utils/profiling.py, tools/perfstats.py's table) on
     teapot 800x800 d4 through binned and on Cornell 800x800 d8: every
     time finite and positive;
 25. the terminal viewer: `python -m pathtracer_tpu_torch.tools.viewer
     scenes/teapot.json --res 256 --typed --spp-per-step 2 --max-steps 3`
     in a temporary directory, fed "a" and "s": exit code 0, a timestamped
     save, and 4 spp after the orbit restarted accumulation; its ms/frame;
 26. the RNG stream API (ops/rng.py Stream), fast and threefry: uniforms
     of (640000, 4) on the card bit-equal to the CPU's, normals within
     NORMAL_ULP or STREAM_NORMAL_ABS, whichever is larger;
 27. the benchmark entry points: tools/bench.bench on Cornell 800x800 d8
     (chunk BENCH_CHUNK, one warm-up, BENCH_REPS reps), then
     tools/bench_suite.run_row of BENCH_ROWS at their chunks with
     BENCH_REPS reps and the suite's device_profile pass, the counters
     reset just before each: the binned row must launch cull, stream and
     packet, the wide row wide_push; every number finite and the busy
     share at most 1; ms/frame best and median, device ms, launches and
     busy share;
 28. the mesh path's measurement tools (pathtracer_tpu_torch/tools), each
     once: trace_stats.split_frames on teapot 800x800 d4 (binned) and
     Cornell 800x800 d8, TOOL_FRAMES traced frames each: the stages' device
     ms (and the unattributed) must sum to the traced device total within
     TOOL_SHARE_TOL, and on teapot the pt_mi_* stages must hold the
     kernels cull, stream and packet; sweep_mesh modes prod and split on
     the teapot bounce-ray pool (TOOL_REPS calls a row); diag_bins on that
     pool; bench_sorts with m = 4 (its radix sort must equal torch.sort's
     keys and payloads first); exp_r5b arms base and p2, one round, teapot
     256x256 d4: both images bit-equal; sim_wide on 65,536 rays of the
     teapot's 256x256 pool.
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
PAR_ITERS = 2        # iterations of each sharded teapot render
PERSIST_SPP = 8      # samples of the sharded persistent Cornell render
WORK_ITERS = 4       # iterations of each shard_work_counts
PERSIST_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_torch_modes.py
WORKER_TIMEOUT = 300  # seconds a worker process may take
COLLECTIVE_REPS = 5
# phase 22: the settings whose kernel forms it holds and renders
FORM_SETTINGS = (("expand2", {"EXPAND": 2}), ("expand4", {"EXPAND": 4}),
                 ("slots3", {"SLOTS": 3}), ("min_support64",
                                            {"MIN_SUPPORT": 64}),
                 ("stream_uv", {"STREAM_UV": True}),
                 ("chunk_gate", {"CHUNK_GATE": True}))
# form -> the setting whose recorded calls it is held on
FORM_OF = {"cull_k2": "expand2", "cull_k4": "expand4", "cull_k3": "slots3",
           "stream_defer": "min_support64", "stream_uv": "stream_uv",
           "stream_gate": "chunk_gate"}
NORMAL_ULP = 4        # tests/test_torch_threefry.py / test_torch_kernels.py
THREEFRY_SPP = 16
THREEFRY_MEAN_TOL = 0.03
# phase 23: one animal frame's cull, stream and packet calls of these
# bounces (0: camera rays, 1: the first scattered rays) are held against
# their plain versions bit for bit
ANIMAL_CHECK_BOUNCES = (0, 1)
ANIMAL_RES, ANIMAL_DEPTH, ANIMAL_SPP = 1200, 12, 4
CULL_SMEM_ROWS = 80  # csrc/cull.cu SMEM_MAX_ROWS
STAGE_ITERS = 10     # phase 24: calls of each stage and frames
VIEWER_TIMEOUT = 300
STREAM_LANES = 640000
STREAM_NORMAL_ABS = 1e-6   # tests/test_torch_rng_stream.py
BENCH_CHUNK, BENCH_REPS = 5, 2   # phase 27
# phase 27: suite rows and the kernels each must launch
BENCH_ROWS = (("teapot d4 binned", ("cull", "stream", "packet")),
              ("alien d4 wide", ("wide_push",)))
TOOL_FRAMES = 2      # phase 28: traced frames of each trace_stats scene
TOOL_REPS = 5        # phase 28: timed calls of each sweep_mesh row
TOOL_SHARE_TOL = 0.01   # the stages' sum within 1% of the traced total


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
    kernels.reset_counts()
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


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal float32 arrays, by their bits."""
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, out: str, scene: str, *extra) -> list:
    """`world` tools/multihost_worker processes with gloo on cuda:0; returns
    each rank's JSON report. Raises if a worker fails, or outlives
    WORKER_TIMEOUT (every worker is then killed)."""
    import os
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pathtracer_tpu_torch.tools.multihost_worker",
         scene, out, "--device", "cuda:0", "--backend", "gloo",
         "--init-method", init, "--world-size", str(world), "--rank",
         str(rank), *extra],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    logs, timed_out = [], False
    for p in procs:
        try:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    for rank, (p, text) in enumerate(zip(procs, logs)):
        if timed_out or p.returncode != 0:
            raise AssertionError(
                f"worker rank {rank} of {scene} "
                + ("timed out" if timed_out else f"exit {p.returncode}")
                + f":\n{text[-3000:]}")
    return [json.loads(text.strip().splitlines()[-1]) for text in logs]


def parallel_phases(dev, scene, settings, c_scene, c_set) -> dict:
    """Phases 18-21 (the module docstring): teapot 800x800 d4 binned
    (scene) and Cornell 800x800 d8 (c_scene). Raises on any failure."""
    import tempfile

    import torch
    import torch.distributed as dist
    from pathtracer_tpu_torch import render, render_persistent
    from pathtracer_tpu_torch.engine.wavefront import (render_iteration,
                                                       zero_accum)
    from pathtracer_tpu_torch.ops import kernels
    from pathtracer_tpu_torch.parallel import distributed, dryrun, sharding
    from pathtracer_tpu_torch.tools import fit_albedo
    from pathtracer_tpu_torch.utils.grad import with_materials

    out = {}
    b13 = ("cull", "stream", "packet")

    def counted(label, fn, frames, shards=1):
        """fn() with the launch counters reset just before and read just
        after: (result, ms a frame, launches). B1-B3 must launch."""
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = 1000.0 * (time.perf_counter() - t0) / frames
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        for k in b13:
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"{label} never launched the {k} "
                                     "kernel")
        out[label] = {"ms_per_frame": ms, "launches": launches,
                      "launches_a_frame_a_shard": {
                          k: launches[k] / (frames * shards) for k in b13}}
        return res, ms, launches

    def tol_used(got, want) -> float:
        """The largest share of the GRAD_RTOL / GRAD_ATOL tolerance that a
        coordinate of `got` uses against `want`."""
        return float(((got - want).abs()
                      / (GRAD_ATOL + GRAD_RTOL * want.abs())).max())

    def peak_over(base: int) -> int:
        """Peak device bytes since the last reset, above `base`."""
        return torch.cuda.max_memory_allocated() - base

    def collective_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COLLECTIVE_REPS):
            fn()
        torch.cuda.synchronize()
        return 1000.0 * (time.perf_counter() - t0) / COLLECTIVE_REPS

    t_all = time.perf_counter()
    ref = render(scene, settings, iterations=PAR_ITERS, seed=0)
    with torch.inference_mode():
        target = render_iteration(c_scene, c_set, zero_accum(c_set, dev), 1,
                                  seed=0, early_exit=False)
    wrong = with_materials(c_scene, color=torch.as_tensor(
        fit_albedo.perturbed_albedo(c_scene.materials.color.cpu().numpy(),
                                    0.25), dtype=torch.float32, device=dev))
    new_1, loss_1 = fit_albedo.albedo_fit_step(wrong, c_set, target, 1,
                                               lr=1.0, seed=0)
    new_1 = new_1.materials.color

    # -- 18. one NCCL rank ----------------------------------------------------
    t_phase = time.perf_counter()
    distributed.init_distributed("nccl", f"tcp://127.0.0.1:{free_port()}",
                                 world_size=1, rank=0)
    try:
        distributed.render_distributed(scene, settings, iterations=1,
                                       device=dev)           # warm-up
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        img, ms, launches = counted(
            "nccl_1_rank_teapot", lambda: distributed.render_distributed(
                scene, settings, iterations=PAR_ITERS, device=dev),
            PAR_ITERS)
        peak = peak_over(base)
        if not same_bits(img, ref):
            raise AssertionError("render_distributed (1 NCCL rank) differs "
                                 "from render")
        mesh = distributed.global_ray_mesh()
        blocks = sharding.shard_accum(target, mesh)
        new_d, loss_d = sharding.albedo_fit_step(wrong, c_set, mesh, blocks,
                                                 1, lr=1.0, seed=0)
        torch.testing.assert_close(loss_d, loss_1, rtol=GRAD_RTOL, atol=0)
        torch.testing.assert_close(new_d.materials.color, new_1,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        grad_like = torch.zeros(new_1.numel() + 1, device=dev)
        gather_ms = collective_ms(lambda: sharding.gather_accum(blocks, mesh))
        reduce_ms = collective_ms(lambda: sharding.all_reduce(grad_like,
                                                              mesh))
        out["nccl_1_rank_teapot"].update(peak_bytes=peak)
        out["nccl_1_rank_albedo"] = {
            "loss": float(loss_d), "loss_single": float(loss_1),
            "max_abs_diff": float((new_d.materials.color
                                   - new_1).abs().max()),
            "tolerance_used": tol_used(new_d.materials.color, new_1),
            "gather_ms": gather_ms, "all_reduce_ms": reduce_ms}
    finally:
        dist.destroy_process_group()
    log(f"1 NCCL rank: teapot {settings.width}x{settings.height} "
        f"d{settings.trace_depth} render_distributed bit-equal to render, "
        f"{ms:.2f} ms/frame, launches {launches}, peak memory "
        f"{peak / 2**30:.3f} GiB over the scenes; cornell albedo step loss "
        f"{float(loss_d)} (single-device {float(loss_1)}), new albedo max "
        f"diff {out['nccl_1_rank_albedo']['max_abs_diff']:.3g} "
        f"({out['nccl_1_rank_albedo']['tolerance_used']:.3f} of the "
        "tolerance); gather "
        f"{gather_ms:.3f} ms, all-reduce {reduce_ms:.3f} ms; phase "
        f"{time.perf_counter() - t_phase:.1f} s")

    # -- 19. local shards on the one card -------------------------------------
    t_phase = time.perf_counter()
    for n in (1, 4):
        mesh = sharding.make_ray_mesh(n, devices=dev)
        sharding.render_sharded(scene, settings, mesh, iterations=1)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        img, ms, launches = counted(
            f"local_{n}_shards_teapot", lambda: sharding.render_sharded(
                scene, settings, mesh, iterations=PAR_ITERS), PAR_ITERS, n)
        out[f"local_{n}_shards_teapot"].update(peak_bytes=peak_over(base))
        if not same_bits(img, ref):
            raise AssertionError(f"render_sharded on {n} shards differs "
                                 "from render")
        log(f"{n} local shard(s): teapot render_sharded bit-equal to render,"
            f" {ms:.2f} ms/frame, launches {launches} (a frame a shard: "
            f"{out[f'local_{n}_shards_teapot']['launches_a_frame_a_shard']}"
            f"), peak memory "
            f"{out[f'local_{n}_shards_teapot']['peak_bytes'] / 2**30:.3f} "
            "GiB over the scenes")
    mesh4 = sharding.make_ray_mesh(4, devices=dev)
    t0 = time.perf_counter()
    p_img = sharding.render_persistent_sharded(c_scene, c_set, mesh4,
                                               iterations=PERSIST_SPP)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p_ref = render_persistent(c_scene, c_set, iterations=PERSIST_SPP)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    np.testing.assert_allclose(p_img, p_ref, **PERSIST_TOL)
    out["persistent_cornell"] = {
        "spp": PERSIST_SPP, "max_abs_diff": float(np.abs(p_img - p_ref).max()),
        "sharded_ms_per_frame": 1000.0 * (t1 - t0) / PERSIST_SPP,
        "single_ms_per_frame": 1000.0 * (t2 - t1) / PERSIST_SPP}
    log(f"cornell {c_set.width}x{c_set.height} d{c_set.trace_depth} "
        f"render_persistent_sharded, 4 shards, {PERSIST_SPP} spp: max diff "
        f"{out['persistent_cornell']['max_abs_diff']:.3g} against "
        f"render_persistent; "
        f"{out['persistent_cornell']['sharded_ms_per_frame']:.2f} against "
        f"{out['persistent_cornell']['single_ms_per_frame']:.2f} ms/frame")
    for name, sc, st in (("cornell", c_scene, c_set),
                         ("teapot", scene, settings)):
        ratios = {}
        for interleave in (True, False):
            w = sharding.shard_work_counts(sc, st, mesh4, WORK_ITERS,
                                           interleave=interleave)
            ratios["interleaved" if interleave else "contiguous"] = (
                float(w.max() / w.mean()), w.tolist())
        out[f"work_{name}"] = ratios
        log(f"{name} shard_work_counts, 4 shards, {WORK_ITERS} iterations: "
            f"max/mean interleaved {ratios['interleaved'][0]:.4f} "
            f"{ratios['interleaved'][1]}, contiguous "
            f"{ratios['contiguous'][0]:.4f} {ratios['contiguous'][1]}")
        if not ratios["interleaved"][0] < ratios["contiguous"][0]:
            raise AssertionError(f"{name}: the interleave does not balance "
                                 "the shards' work")
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")

    # -- 20. two ranks in two processes on the one card (gloo) ----------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t_out = f"{tmp}/teapot"
        reports = run_ranks(2, t_out, TEAPOT, "--spp", str(PAR_ITERS))
        imgs = [np.load(f"{t_out}.{r}.npy") for r in range(2)]
        c_out = f"{tmp}/cornell"
        c_reports = run_ranks(2, c_out, CORNELL, "--spp", "1", "--fit")
        c_imgs = [np.load(f"{c_out}.{r}.npy") for r in range(2)]
        albedo = [np.load(f"{c_out}.albedo.{r}.npy") for r in range(2)]
    c_ref = render(c_scene, c_set, iterations=1, seed=0)
    for label, got, want in (("teapot", imgs, ref),
                             ("cornell", c_imgs, c_ref)):
        if not (same_bits(got[0], got[1]) and same_bits(got[0], want)):
            raise AssertionError(f"2 gloo ranks: the {label} images differ "
                                 "from each other or from render")
    if not same_bits(albedo[0], albedo[1]):
        raise AssertionError("2 gloo ranks: the new albedos differ")
    albedo_2 = torch.as_tensor(albedo[0], device=dev)
    torch.testing.assert_close(albedo_2, new_1, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    for r in reports:
        for k in b13:
            if r["launches"].get(k, 0) <= 0:
                raise AssertionError(f"gloo rank {r['rank']} never launched "
                                     f"the {k} kernel")
    out["gloo_2_ranks"] = {
        "teapot": reports, "cornell": c_reports,
        "albedo_max_abs_diff": float((albedo_2 - new_1).abs().max()),
        "albedo_tolerance_used": tol_used(albedo_2, new_1),
        "seconds": time.perf_counter() - t_phase}
    for r in reports + c_reports:
        log(f"gloo rank {r['rank']}/2 {r['size']} {r['bvh_impl']}: "
            f"{r['ms_per_frame']:.2f} ms/frame, launches {r['launches']}, "
            f"gather {r['gather_ms']:.3f} ms, all-reduce "
            f"{r['all_reduce_ms']:.3f} ms, peak memory "
            f"{r['peak_bytes'] / 2**30:.3f} GiB (scene included)"
            + (f", albedo step {r['fit_ms']:.1f} ms, loss {r['fit_loss']}"
               if "fit_ms" in r else ""))
    log("2 gloo ranks on one card: teapot and cornell images bit-equal to "
        "each other and to render; new albedos bit-equal, max diff "
        f"{out['gloo_2_ranks']['albedo_max_abs_diff']:.3g} "
        f"({out['gloo_2_ranks']['albedo_tolerance_used']:.3f} of the "
        "tolerance) to the single-process step; phase "
        f"{out['gloo_2_ranks']['seconds']:.1f} s")

    # -- 21. the dry run --------------------------------------------------------
    t_phase = time.perf_counter()
    dryrun.dryrun_multichip(1, dev)
    log(f"dryrun_multichip(1) on {dev}: OK, "
        f"{time.perf_counter() - t_phase:.1f} s; parallel phases "
        f"{time.perf_counter() - t_all:.1f} s in all")
    out["seconds"] = time.perf_counter() - t_all
    log(json.dumps({"parallel": out}))
    return out


def gate_tri_tests(args, chunk) -> tuple[int, int]:
    """(triangle tests, chunk box tests) the gated stream makes: a lane
    with a treelet tests each chunk box of its first batch against its
    bound, and the rows of the chunks that pass. Exact for treelets of at
    most GATE_ROWS rows, which read the bound once (the teapot's)."""
    import torch
    from pathtracer_tpu_torch.ops import binned
    from pathtracer_tpu_torch.ops.bvh_packet import slab
    treelet_i, _, max_rows, ox, oy, oz, dx, dy, dz, bound, tid = args
    ti = treelet_i.reshape(-1, 4)
    ok = (tid >= 0) & (tid < ti.shape[0])
    if max_rows > binned.GATE_ROWS:
        raise ValueError("gate_tri_tests counts one batch a treelet")
    g = tid[ok].long()
    rows = torch.clamp(ti[g, 1], max=max_rows)
    n_chunks = -(-max_rows // 4)
    box = chunk[g].reshape(-1, 16, 8)[:, :n_chunks]
    t0, t1 = slab(box[..., 0:3].unbind(-1), box[..., 3:6].unbind(-1),
                  [a[ok, None] for a in (ox, oy, oz)],
                  [1.0 / a[ok, None] for a in (dx, dy, dz)])
    enters = (t0 <= t1) & (t1 > 0.0) & (t0 < bound[ok, None])
    c_rows = torch.clamp(rows[:, None] - 4 * torch.arange(
        n_chunks, device=rows.device)[None, :], 0, 4)
    return 6 * int((c_rows * enters).sum()), n_chunks * int(ok.sum())


def forms_phase(dev, scene, settings, state, live, c_scene, c_set,
                report) -> None:
    """Phase 22 (the module docstring): adds a row of the kernels JSON line
    for each new kernel form. Raises on any failure."""
    import torch
    from pathtracer_tpu_torch import render
    from pathtracer_tpu_torch.ops import binned, kernels, rng
    from pathtracer_tpu_torch.ops.intersect import intersect_scene
    from pathtracer_tpu_torch.utils.kernel_bench import cuda_ms, device_ms
    t_phase = time.perf_counter()
    captured = {}   # (setting, "cull" | "stream") -> [(args, kwargs)]

    def recording(label, name, fn):
        def wrapper(*args, **kwargs):
            captured.setdefault((label, name), []).append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    with torch.inference_mode():
        for label, flags in FORM_SETTINGS:
            with mock.patch.multiple(binned, **flags), \
                    mock.patch.object(binned, "cull", recording(
                        label, "cull", binned.cull)), \
                    mock.patch.object(binned, "stream", recording(
                        label, "stream", binned.stream)):
                intersect_scene(scene, settings.geom_types, state.origin,
                                state.direction, bvh_impl="binned",
                                active=live)
        torch.cuda.synchronize()
        src = "pathtracer_tpu_torch/csrc/"
        for form, label in FORM_OF.items():
            is_cull = form.startswith("cull")
            if is_cull:
                k = int(form[len("cull_k"):])
                calls = [c for c in captured[(label, "cull")]
                         if c[1].get("k", 1) == k]
                kern, plain = binned.cull, binned.cull_plain
                idx = ([1], [0], [1])
            else:
                calls = [c for c in captured[(label, "stream")] if c[1]]
                kern, plain = binned.stream, binned.stream_plain
                idx = ([0, 1, 2, 3], [4], [0, 1, 2, 3])
            if not calls:
                raise AssertionError(f"{label}: no {form} call recorded")
            err, rows = 0.0, []
            for args, kw in calls:
                got = kern(*args, **kw)
                f_idx, i_idx, ex_idx = idx
                if len(got) == 6:           # the deferring stream's inc
                    i_idx = i_idx + [5]
                err = max(err, compare(form, got, plain(*args, **kw), f_idx,
                                       i_idx, ex_idx))
                ms = cuda_ms(lambda: kern(*args, **kw), reps=20)
                dev_ms, _ = device_ms(lambda: kern(*args, **kw), reps=20)
                if is_cull:
                    ops = OPS_BOX * cull_box_tests(args)
                    n_need = int((args[11] > 0).sum())
                    n_bytes = need_bytes(args[:2], args[2:11], n_need,
                                         [args[11]], got)
                else:
                    tid = args[-1]
                    work = (tid >= 0) & (tid < args[0].numel() // 4)
                    if "min_support" in kw:
                        work = work & (got[5] == 0)
                        ops = OPS_TRI * stream_tri_tests(
                            args[:-1] + (torch.where(work, tid, -1),))
                    elif "treelet_chunk" in kw:
                        tris, boxes = gate_tri_tests(args,
                                                     kw["treelet_chunk"])
                        ops = OPS_TRI * tris + OPS_BOX * boxes
                    else:
                        ops = OPS_TRI * stream_tri_tests(args)
                    n_need = int(work.sum())
                    tables = args[:2] + ((kw["treelet_chunk"],)
                                         if "treelet_chunk" in kw else ())
                    n_bytes = need_bytes(tables, args[3:10], n_need, [tid],
                                         got)
                bound_ms, bound_by = bound(n_bytes, ops)
                rows.append((ms, dev_ms, bound_ms, bound_by))
                log(f"kernel {form} ({label}, call {len(rows) - 1}): "
                    f"{args[3].shape[0]} lanes ({n_need} needing work), "
                    f"bit-equal, kernel {ms:.4f} ms (device {dev_ms:.4f}), "
                    f"bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} bytes,"
                    f" {ops} FP32 ops)")
            args, kw = calls[0]
            plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=3, warmup=1)
            ms, dev_ms, bound_ms, bound_by = rows[0]
            report[form] = {
                "name": form, "route": "cuda",
                "source": src + ("cull.cu" if is_cull else "stream.cu"),
                "replaces": "pathtracer_tpu/ops/binned.py:"
                + ("290" if is_cull else "446"),
                "launches": 0, "max_abs_err": err, "ms": ms,
                "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "calls": len(calls),
                "bounce_device_ms": sum(r[1] for r in rows)}
            total = report[form]["bounce_device_ms"]
            log(f"kernel {form}: plain {plain_ms:.4f} ms on the first call; "
                f"{len(calls)} calls, device {total:.4f} ms in all")
        # the default stream on the expanded pools (2x and 4x the lanes)
        for label in ("expand2", "expand4"):
            (args, kw), = [c for c in captured[(label, "stream")]]
            got = binned.stream(*args)
            compare(f"stream ({label} pool)", got,
                    binned.stream_plain(*args), [0, 1, 2, 3], [4],
                    [0, 1, 2, 3])
            ms = cuda_ms(lambda: binned.stream(*args), reps=20)
            dev_ms, _ = device_ms(lambda: binned.stream(*args), reps=10)
            tid = args[-1]
            n_need = int(((tid >= 0) & (tid < args[0].numel() // 4)).sum())
            ops = OPS_TRI * stream_tri_tests(args)
            n_bytes = need_bytes(args[:2], args[3:10], n_need, [tid], got)
            bound_ms, bound_by = bound(n_bytes, ops)
            report["stream"][f"{label}_pool"] = {
                "lanes": args[3].shape[0], "ms": ms, "device_ms": dev_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"kernel stream on the {label} pool: {args[3].shape[0]} "
                f"lanes ({n_need} needing work), bit-equal, kernel "
                f"{ms:.4f} ms (device {dev_ms:.4f}), bound {bound_ms:.4f} ms "
                f"by {bound_by} ({n_bytes} bytes, {ops} FP32 ops)")

    # each setting's render: its forms launch, the default image's bits
    ref = render(scene, settings, iterations=1, seed=0)
    for label, flags in FORM_SETTINGS:
        with mock.patch.multiple(binned, **flags):
            torch.cuda.synchronize()
            kernels.reset_counts()
            t0 = time.perf_counter()
            img = render(scene, settings, iterations=1, seed=0)
            torch.cuda.synchronize()
            ms = 1000.0 * (time.perf_counter() - t0)
            forms = dict(kernels.FORMS)
        log(f"teapot {settings.width}x{settings.height} "
            f"d{settings.trace_depth} binned {label}: {ms:.2f} ms for one "
            f"iteration, launches {dict(kernels.LAUNCHES)}, forms {forms}")
        for form in (f for f, lab in FORM_OF.items() if lab == label):
            if forms.get(form, 0) <= 0:
                raise AssertionError(f"{label} render never launched {form}")
            report[form]["launches"] = forms[form]
        if not same_bits(img, ref):
            raise AssertionError(f"{label}: image differs from the default "
                                 f"binned image on "
                                 f"{int((img != ref).any(-1).sum())} pixels")
    log("phase 22: every form's teapot image equals the default's bits")

    # the threefry path: the card's draws against the CPU's (iteration 1,
    # seed 0: bounce 0's uniforms and raygen's jitter normals)
    n = c_set.pixel_count
    it_key = rng.fold_in(rng.key(0), 1)
    u_key, z_key = rng.fold_in(it_key, 0), rng.fold_in(it_key, -1)
    u_card = rng.uniforms(u_key, n, 4, dev).cpu().numpy()
    if not same_bits(u_card, rng.uniforms(u_key, n, 4, "cpu").numpy()):
        raise AssertionError("threefry uniforms differ card vs CPU")
    z_card = rng.normals(z_key, n, 2, dev).cpu().numpy()
    z_cpu = rng.normals(z_key, n, 2, "cpu").numpy()
    ulp = np.abs(z_card.view(np.int32).astype(np.int64)
                 - z_cpu.view(np.int32).astype(np.int64))
    if ulp.max() > NORMAL_ULP:
        raise AssertionError(f"threefry normals {ulp.max()} ulp off")
    log(f"threefry draws, {n} lanes: uniforms bit-equal card vs CPU; "
        f"normals max {int(ulp.max())} ulp, {float((ulp > 0).mean()):.4%} "
        "differ")
    t_set = dataclasses.replace(c_set, fast_rng=False)
    irng = rng.IterationRng(0, 1, fast=False)
    lanes = torch.arange(n, device=dev)
    draw_ms = cuda_ms(lambda: irng.uniforms(3, lanes, 4), reps=10)
    draw_dev, _ = device_ms(lambda: irng.uniforms(3, lanes, 4), reps=5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        irng.uniforms(3, lanes, 4)
        torch.cuda.synchronize()
    draw_kernels = sum(e.count for e in prof.key_averages()
                       if e.self_device_time_total > 0)
    imgs, frame = {}, {}
    for name, st in (("fast", c_set), ("threefry", t_set)):
        imgs[name], frame[name] = render_ms(render, c_scene, st,
                                            THREEFRY_SPP)
    means = {k: float(v.mean()) for k, v in imgs.items()}
    log(f"threefry: one bounce's draw (uniforms {n}x4) {draw_ms:.4f} ms "
        f"(device {draw_dev:.4f} ms, {draw_kernels} device kernels); "
        f"cornell {c_set.width}x{c_set.height} d{c_set.trace_depth} "
        f"{frame['threefry']:.2f} ms/frame against {frame['fast']:.2f} on "
        f"the fast path ({THREEFRY_SPP} spp); image means {means}")
    if not np.isfinite(imgs["threefry"]).all() or abs(
            means["threefry"] - means["fast"]) >= THREEFRY_MEAN_TOL:
        raise AssertionError("threefry image mean off the fast path's")
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")


def animal_kernel_calls(a_scene, a_set) -> None:
    """Phase 23's kernel check at full width: one animal frame through
    render with cull, stream and packet recorded (the bounce counted at
    each intersect_scene call of the bounce loop); logs every call's lanes
    by bounce and holds each call of ANIMAL_CHECK_BOUNCES against its plain
    version bit for bit. Raises on any failure."""
    import torch
    from pathtracer_tpu_torch import render
    from pathtracer_tpu_torch.engine import wavefront
    from pathtracer_tpu_torch.ops import binned, bvh_packet
    from pathtracer_tpu_torch.utils.kernel_bench import cuda_ms
    bounce = [-1]
    lanes = {}       # bounce -> {kernel: [lanes of each call]}
    recorded = []    # (bounce, kernel, args, kwargs)

    def counting(fn):
        def wrapper(*args, **kwargs):
            bounce[0] += 1
            return fn(*args, **kwargs)
        return wrapper

    def recording(name, fn):
        def wrapper(*args, **kwargs):
            # the last argument is a per-lane plane: the cull's active
            # mask, the stream's treelet ids, the packet walk's t bound
            lanes.setdefault(bounce[0], {}).setdefault(name, []).append(
                args[-1].shape[-1])
            if bounce[0] in ANIMAL_CHECK_BOUNCES:
                recorded.append((bounce[0], name, args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    # name: (kernel, plain, (float outputs, int outputs, exact floats))
    specs = {
        "cull": (binned.cull, binned.cull_plain, ([1], [0], [1])),
        "stream": (binned.stream, binned.stream_plain,
                   ([0, 1, 2, 3], [4], [0])),
        "packet": (bvh_packet.packet_walk, bvh_packet.packet_walk_plain,
                   ([0, 1, 2, 3], [4], [0])),
    }
    with torch.inference_mode():
        with mock.patch.object(wavefront, "intersect_scene",
                               counting(wavefront.intersect_scene)), \
                mock.patch.object(binned, "cull",
                                  recording("cull", binned.cull)), \
                mock.patch.object(binned, "stream",
                                  recording("stream", binned.stream)), \
                mock.patch.object(bvh_packet, "packet_walk",
                                  recording("packet",
                                            bvh_packet.packet_walk)):
            render(a_scene, a_set, iterations=1, seed=0)
        torch.cuda.synchronize()
        for b in sorted(lanes):
            log(f"animal frame, bounce {b}: lanes a call "
                + ", ".join(f"{k} {v}" for k, v in lanes[b].items()))
        for b in ANIMAL_CHECK_BOUNCES:
            names = {name for bb, name, _, _ in recorded if bb == b}
            if not {"cull", "stream"} <= names:
                raise AssertionError(f"animal bounce {b}: cull or stream "
                                     f"not called ({sorted(names)})")
        for b, name, args, kw in recorded:
            kern, plain, (f_idx, i_idx, ex_idx) = specs[name]
            if name == "cull":
                need = int((args[11] > 0).sum())
            elif name == "stream":
                tid = args[-1]
                need = int(((tid >= 0)
                            & (tid < args[0].numel() // 4)).sum())
            else:
                need = int((args[10] > 0).sum())
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            compare(f"animal bounce {b} {name}", got, ref, f_idx, i_idx,
                    ex_idx)
            ms = cuda_ms(lambda: kern(*args, **kw), reps=5)
            log(f"animal bounce {b} {name}: {args[-1].shape[-1]} lanes "
                f"({need} needing work), bit-equal to the plain version; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
        if not any(name == "packet" for _, name, _, _ in recorded):
            log(f"animal bounces {ANIMAL_CHECK_BOUNCES}: no packet "
                "fallback call to hold")


def fullscale_phases(dev, scene, settings, c_scene, c_set) -> None:
    """Phases 23-26 (the module docstring). Raises on any failure."""
    import os
    import re
    import tempfile

    import torch
    from pathtracer_tpu_torch import load_scene, render
    from pathtracer_tpu_torch.ops import bvh_packet, kernels, rng
    from pathtracer_tpu_torch.tools.golden_parity import (ENVELOPE_SPP,
                                                          check_envelope,
                                                          compute_parity)
    from pathtracer_tpu_torch.utils.profiling import (device_profile,
                                                      measure_stages)

    def r5(a):
        return [round(float(x), 5) for x in a]

    # -- 23. full-scale parity ------------------------------------------------
    t_phase = time.perf_counter()
    m = compute_parity(spp=ENVELOPE_SPP, chunk=100, device=dev)
    log(f"parity cornell 800x800 d8, {ENVELOPE_SPP} spp: mad "
        f"{m['mad']:.5f}, "
        f"b8 mean {m['b8_mean']:.5f} max {m['b8_max']:.5f}, b16 mean "
        f"{m['b16_mean']:.5f} max {m['b16_max']:.5f}, corr {m['corr']:.5f}, "
        f"channel means {r5(m['means_ours'])} against "
        f"{r5(m['means_gold'])} (delta {r5(m['mean_delta'])}); "
        f"{m['seconds']:.2f} s, "
        f"{m['ms_frame']:.2f} ms/frame after the first chunk")
    bad = check_envelope(m)
    if bad:
        raise AssertionError(f"parity off the envelope: {bad}")
    t0 = time.perf_counter()
    a_scene, a_set = load_scene(ANIMAL, dev, overrides={
        "RES": [ANIMAL_RES, ANIMAL_RES], "DEPTH": ANIMAL_DEPTH})
    load_s = time.perf_counter() - t0
    rows = a_scene.treelet_super.shape[0]
    nodes = min(a_scene.bvh_packed_f.numel() // 8,
                a_scene.bvh_packed_i.numel() // 4)
    def path(n, limit):
        return "cached-read path" if n > limit else "shared-memory path"

    log(f"animal {a_set.width}x{a_set.height} d{a_set.trace_depth} "
        f"{a_set.bvh_impl}: load {load_s:.2f} s; {rows} union rows (cull.cu"
        f" stages up to {CULL_SMEM_ROWS}: {path(rows, CULL_SMEM_ROWS)}), "
        f"{nodes} BVH nodes (packet.cu stages up to "
        f"{bvh_packet.SMEM_NODES}: {path(nodes, bvh_packet.SMEM_NODES)})")
    render(a_scene, a_set, iterations=1, seed=0)           # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    img = render(a_scene, a_set, iterations=ANIMAL_SPP, seed=0)
    torch.cuda.synchronize()
    a_ms = 1000.0 * (time.perf_counter() - t0) / ANIMAL_SPP
    launches = {k: v / ANIMAL_SPP for k, v in kernels.LAUNCHES.items() if v}
    for k in ("cull", "stream", "packet"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"animal never launched the {k} kernel")
    if not np.isfinite(img).all() or not img.max() > 0:
        raise AssertionError("animal image is not finite or all zero")
    with torch.inference_mode():
        prof = device_profile(a_scene, a_set, iters=1)
    by_kind = prof["by_kind"]
    kern = {k: by_kind.get(f"{k} kernel", {"ms": 0.0, "launches": 0})
            for k in ("cull", "stream", "packet")}
    log(f"animal {ANIMAL_RES}x{ANIMAL_RES} d{ANIMAL_DEPTH} binned: "
        f"{a_ms:.2f} ms/frame over {ANIMAL_SPP} iterations, launches a "
        f"frame {launches}; one profiled frame: wall {prof['wall_ms']:.2f} "
        f"ms, device {prof['device_ms']:.2f} ms in "
        f"{prof['launches']:.0f} device kernels, busy "
        f"{100.0 * prof['busy_share']:.1f}%; "
        + ", ".join(f"{k} {v['ms']:.4f} device ms ({v['launches']:.0f} "
                    "device kernels)" for k, v in kern.items())
        + f"; image mean {r5(img.mean(axis=(0, 1)))}")
    animal_kernel_calls(a_scene, a_set)
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s")

    # -- 24. measure_stages ----------------------------------------------------
    t_phase = time.perf_counter()
    for name, sc, st in (("teapot", scene, settings),
                         ("cornell", c_scene, c_set)):
        stats = measure_stages(sc, st, iters=STAGE_ITERS)
        log(f"measure_stages {name} {st.width}x{st.height} "
            f"d{st.trace_depth} {st.bvh_impl} ({STAGE_ITERS} calls "
            f"each):\n{stats.table()}")
        times = (stats.raygen_ms, stats.intersect_ms, stats.shade_ms,
                 stats.gather_ms, stats.frame_ms)
        if not all(np.isfinite(t) and t > 0 for t in times):
            raise AssertionError(f"measure_stages {name}: {times}")
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s")

    # -- 25. the terminal viewer ----------------------------------------------
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        p = subprocess.run(
            [sys.executable, "-m", "pathtracer_tpu_torch.tools.viewer",
             os.path.join(root, TEAPOT), "--res", "256", "--typed",
             "--spp-per-step", "2", "--max-steps", "3"],
            cwd=tmp, env=env, input="a\ns\n", capture_output=True,
            text=True, timeout=VIEWER_TIMEOUT)
        saved = re.findall(r"saved (\S+samp\.png)", p.stdout)
        if p.returncode != 0 or not saved or not os.path.exists(
                os.path.join(tmp, saved[0])):
            raise AssertionError(f"viewer rc {p.returncode}, no save: "
                                 f"{p.stdout[-1500:]} {p.stderr[-1500:]}")
    # the two typed steps print 2 then 4 spp (4 then 6 without the restart)
    if re.findall(r"(\d+) spp", p.stdout) != ["2", "4"]:
        raise AssertionError("viewer: the orbit did not restart "
                             f"accumulation: {p.stdout[-1500:]}")
    log("viewer teapot 256x256 typed: rc 0, saved, "
        + "; ".join(re.findall(r"\d+ spp +\([\d.]+ ms/frame\)", p.stdout))
        + f"; phase 25: {time.perf_counter() - t_phase:.1f} s")

    # -- 26. the RNG stream API, card vs CPU ----------------------------------
    for fast in (True, False):
        card = rng.Stream.for_iteration(fast, 0, 7, salt=-1, device=dev)
        cpu = rng.Stream.for_iteration(fast, 0, 7, salt=-1, device="cpu")
        max_ulp, n_differ = 0, 0.0
        for c, h in ((card, cpu), (card.fold(3), cpu.fold(3))):
            if not same_bits(c.uniforms(STREAM_LANES, 4).cpu().numpy(),
                             h.uniforms(STREAM_LANES, 4).numpy()):
                raise AssertionError(f"Stream(fast={fast}) uniforms differ "
                                     "card vs CPU")
            z_c = c.normals(STREAM_LANES, 3).cpu().numpy()
            z_h = h.normals(STREAM_LANES, 3).numpy()
            ulp = np.abs(z_c.view(np.int32).astype(np.int64)
                         - z_h.view(np.int32).astype(np.int64))
            bad = (ulp > NORMAL_ULP) & (np.abs(z_c - z_h) > STREAM_NORMAL_ABS)
            if bad.any():
                raise AssertionError(f"Stream(fast={fast}) normals: "
                                     f"{int(bad.sum())} off")
            max_ulp = max(max_ulp, int(ulp.max()))
            n_differ = max(n_differ, float((ulp > 0).mean()))
        log(f"Stream(fast={fast}) {STREAM_LANES}x4 and one fold on the card:"
            f" uniforms bit-equal to the CPU's, normals (x3) max {max_ulp} "
            f"ulp ({n_differ:.4%} differ at most)")


def bench_phase(dev, c_scene, c_set) -> None:
    """Phase 27 (the module docstring). Raises on any failure."""
    import math

    from pathtracer_tpu_torch.ops import kernels
    from pathtracer_tpu_torch.tools import bench, bench_suite

    t_phase = time.perf_counter()
    kernels.reset_counts()
    t = bench.bench(c_scene, c_set, chunk=BENCH_CHUNK, warmup=1,
                    reps=BENCH_REPS)
    if not (all(math.isfinite(x) and x > 0 for x in t.reps_ms)
            and t.best <= t.median <= t.max):
        raise AssertionError(f"bench.bench cornell: {t.reps_ms}")
    log(f"bench.bench cornell {c_set.width}x{c_set.height} "
        f"d{c_set.trace_depth}, chunk {BENCH_CHUNK}: {t.best:.3f} ms/frame "
        f"best, {t.median:.3f} median of {t.reps_ms}; launches "
        f"{[(k, v) for k, v in kernels.LAUNCHES.items() if v]}")
    for name, want in BENCH_ROWS:
        rec = bench_suite.run_row(bench_suite.row_named(name), dev,
                                  reps=BENCH_REPS)
        log(f"bench_suite {bench_suite.row_line(rec)}; "
            f"{rec['traced_wall_ms']:.2f} ms traced wall, "
            f"{rec['frames']} frames")
        if rec["error"]:
            raise AssertionError(f"{name}: {rec['error']}")
        missing = [k for k in want if not rec["kernel_launches"].get(k)]
        if missing:
            raise AssertionError(f"{name} never launched {missing}")
        nums = [rec[k] for k in ("ms_per_frame", "median_ms", "max_ms",
                                 "primary_mrays_per_s", "traced_wall_ms",
                                 "device_ms", "device_kernels",
                                 "busy_share", "load_s")]
        nums += rec["reps_ms"] + list(rec["kernel_launches"].values())
        if not all(isinstance(x, (int, float)) and math.isfinite(x)
                   for x in nums):
            raise AssertionError(f"{name}: a field is not finite: {rec}")
        if not 0 < rec["busy_share"] <= 1:
            raise AssertionError(f"{name}: busy share {rec['busy_share']}")
    log(f"phase 27: {time.perf_counter() - t_phase:.1f} s")


def tools_phase(dev) -> None:
    """Phase 28 (the module docstring). Raises on any failure."""
    import math

    from pathtracer_tpu_torch import load_scene
    from pathtracer_tpu_torch.tools import (bench_sorts, diag_bins, exp_r5b,
                                            sim_wide, sweep_mesh,
                                            trace_stats)

    t_phase = time.perf_counter()
    for path in (TEAPOT, CORNELL):
        scene, settings = load_scene(path, dev)
        res = trace_stats.split_frames(scene, settings, TOOL_FRAMES)
        log(trace_stats.table(res))
        total = res["device_total_ms"]
        shares = sum(res["device_ms"][s]
                     for s in trace_stats.STAGES + (trace_stats.OTHER,))
        if not (total > 0 and abs(shares - total) <= TOOL_SHARE_TOL * total):
            raise AssertionError(f"trace_stats {path}: stages sum to "
                                 f"{shares:.3f} of {total:.3f} device ms")
        if path == TEAPOT:
            for stage, frag in (("pt_mi_cull", "cull_kernel"),
                                ("pt_mi_stream", "stream_kernel"),
                                ("pt_mi_fb", "packet_kernel")):
                if not any(frag in k for k in res["kernels"][stage]):
                    raise AssertionError(f"trace_stats: no {frag} in "
                                         f"{stage}")
    pool = sweep_mesh.make_pool(TEAPOT, dev)
    for mode in ("prod", "split"):
        rows = sweep_mesh.sweep(pool, mode, reps=TOOL_REPS, out=log)
        if not all(math.isfinite(ms) and ms > 0 for _, ms in rows):
            raise AssertionError(f"sweep_mesh {mode}: {rows}")
    stats = diag_bins.diagnose(pool, out=log)
    if not stats or stats[0] is None or stats[0]["live"] <= 0:
        raise AssertionError(f"diag_bins: {stats}")
    sorts = bench_sorts.bench(dev, m=4, out=log)
    if not all(math.isfinite(ms) and ms > 0 for ms in sorts.values()):
        raise AssertionError(f"bench_sorts: {sorts}")
    arms = exp_r5b.run_arms(TEAPOT, ["base", "p2"], dev,
                            {"RES": [256, 256], "DEPTH": 4}, rounds=1,
                            out=log)
    if arms["equal"] != {"base": True, "p2": True}:
        raise AssertionError(f"exp_r5b: images differ {arms['equal']}")
    sim = sim_wide.main(["--rays", "65536"])
    if not sim["node"] > 0 < sim["leaf"]:
        raise AssertionError(f"sim_wide: {sim}")
    log(f"phase 28: {time.perf_counter() - t_phase:.1f} s")


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
    kernels.reset_counts()
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
            kernels.reset_counts()
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
        kernels.reset_counts()
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
            kernels.reset_counts()
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

    # -- 18.-21. multi-device rendering ----------------------------------------
    parallel_phases(dev, scene, settings, c_scene, c_set)

    # -- 22. the binned pipeline's other forms, the threefry path -------------
    forms_phase(dev, scene, settings, state, live, c_scene, c_set, report)

    # -- 23.-26. full-scale parity, perfstats, the viewer, the stream API -----
    fullscale_phases(dev, scene, settings, c_scene, c_set)

    # -- 27. the benchmark entry points ---------------------------------------
    bench_phase(dev, c_scene, c_set)

    # -- 28. the mesh path's measurement tools --------------------------------
    tools_phase(dev)

    # -- 29. results ----------------------------------------------------------

    log(json.dumps({"kernels": list(report.values())}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
